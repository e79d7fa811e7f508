"""Card-only tests of the port: each hand-written kernel against its plain
PyTorch version on the same CUDA tensors. They skip without a card.

This file imports no jax, so it runs on a machine with a card and without
jax: `python -m pytest --noconftest tests/test_torch_cuda.py -q`.

Tolerances: kernel A bit-identical, also across its train chunks. Kernel
B sums its per-camera rows and cost in a fixed blocking (two calls give the
same bits), in another order than the plain version. Kernel E (blocked Cholesky solve):
relative max error < 1e-5 against float64 on S = A A^T + N I, and the same
against its plain version with the same panels, and bit-identical between
two calls. Kernel D sums red6 in a fixed blocking as B does (two calls give
the same bits). Kernels C and K5 sum S and the rhs over tiles with
shared-memory atomics, in an order that changes from run to run. For B, C,
K5 and D:
cost rtol 1e-5; red, Vu, g_p, W, S, b, red6 and G rtol 2e-4 / atol 2e-3
relative to the max magnitude of each block
(`torch_port_helpers.block_scale`); zv, vinv6 and Xt_new elementwise. Dense
solves: cameras atol 5e-4, final cost rtol 1e-3.

Modules without a kernel, on the card: batched against per-frame detection
(>= 99% of keypoints identical, their descriptors bit-identical), ICP on
the card against its CPU run (R and t 1e-4, fitness 1e-4 relative), and a
checkpoint written and resumed on the card (positions within 2e-3 m of the
uninterrupted run).
"""

import numpy as np
import pytest
import torch

from bundleadjustment_tpu_torch import kernels
from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu_torch.data.track_scene import make_track_scene
from bundleadjustment_tpu_torch.parallel import sharded_dense_ba as tsh
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu_torch.ops import hamming as th
from bundleadjustment_tpu_torch.solvers import chol as tc
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from bundleadjustment_tpu_torch.solvers.lm import LMConfig
from torch_port_helpers import (  # noqa: F401
    as_tensor,
    assert_blocks_close,
    assert_close,
    cuda_device,
)

pytestmark = pytest.mark.cuda


def _descs(rng, m1, m2, case):
    t = rng.integers(0, 2**32, (m2, 8), dtype=np.uint32)
    q = t[rng.integers(0, m2, m1)].copy()
    q[::2] ^= rng.integers(0, 2**32, q[::2].shape, dtype=np.uint32) & np.uint32(0x00110011)
    valid = np.ones(m2, bool)
    if case == "ties":
        t[1::2] = t[0::2]  # every train row has an identical twin
    elif case == "invalid":
        valid = rng.random(m2) > 0.3
    return q, t, valid


def _scene(n_cams, n_pts, seed, pixel_noise, device, max_obs=16, copies=1):
    """A dense problem; with copies > 1 every camera is repeated and each
    observation goes to one of its camera's copies at random."""
    sc = make_synthetic_scene(n_cams=n_cams, n_pts=n_pts, pixel_noise=pixel_noise,
                              seed=seed)
    sc.extr_init[1] = sc.extr_gt[1]
    rng = np.random.default_rng(seed)
    cam_idx = (sc.cam_idx + n_cams * rng.integers(0, copies, sc.cam_idx.shape)
               ).astype(np.int32)
    cf = np.zeros(n_cams * copies, bool)
    cf[:2] = True
    prob, _ = td.densify_problem(sc.K4, cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                 sc.valid, cf, n_pts, max_obs=max_obs, device=device)
    cams = torch.from_numpy(np.tile(sc.extr_init, (copies, 1))).to(device)
    pts = torch.from_numpy(sc.points_init).to(device)
    return prob, cams, pts


def test_hamming_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(0)
    for B, case in ((1, "ties"), (4, "invalid")):
        q, t, valid = _descs(rng, 500, 1000, case)
        args = (as_tensor(q, cuda_device)[None],
                as_tensor(np.stack([t] * B), cuda_device),
                torch.from_numpy(np.stack([valid] * B)).to(cuda_device))
        got = th.hamming_top2(*args)
        ref = th.hamming_top2_plain(*args)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def _hamming_chunk_case(rng, case):
    """(q [1, M1, 8], t [B, M2, 8], valid [B, M2]) as tensors' numpy arrays,
    and the plan kernel A takes on an H100 (132 SMs)."""
    B, m1, m2 = {"tie_across_chunks": (1, 1000, 1000), "no_valid_row": (1, 1000, 1000),
                 "chunk_without_valid": (1, 1000, 1000),
                 "batch_25": (25, 1000, 1000)}[case]
    t = rng.integers(0, 2**32, (B, m2, 8), dtype=np.uint32)
    q = t[0, rng.integers(0, m2, m1)].copy()
    q[::2] ^= rng.integers(0, 2**32, q[::2].shape, dtype=np.uint32) & np.uint32(0x00110011)
    valid = rng.random((B, m2)) > 0.1
    plan = th.hamming_plan(B, m1, m2, 132)
    if case == "tie_across_chunks":  # twins across every chunk and quarter border
        for a, e in th.hamming_pieces(m2, plan)[1:]:
            if e > a:
                t[:, a] = t[:, a - 1]
                valid[:, a] = valid[:, a - 1] = True
                q[a % m1] = t[0, a]
    elif case == "no_valid_row":
        valid[:] = False
    elif case == "chunk_without_valid":
        valid[:, plan.chunk:3 * plan.chunk] = False
    return q[None], t, valid


@pytest.mark.parametrize("case", ["tie_across_chunks", "no_valid_row",
                                  "chunk_without_valid", "batch_25"])
def test_hamming_kernel_chunks_match_plain_on_card(cuda_device, case):
    """Kernel A over its train chunks, bit-identical to the plain version:
    ties across chunk and warp-quarter borders, no valid train row, a chunk
    without one, and 25 train sets against one query set."""
    q, t, valid = _hamming_chunk_case(np.random.default_rng(1), case)
    args = (as_tensor(q, cuda_device), as_tensor(t, cuda_device),
            torch.from_numpy(valid).to(cuda_device))
    got = th.hamming_top2(*args)
    ref = th.hamming_top2_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if case == "no_valid_row":
        assert (got[2] == -1).all() and torch.isinf(got[0]).all()


# name: (cameras, landmarks, copies of each camera, all cameras fixed)
B_CARD_CASES = {"K1": (1, 300, 1, False), "K8": (8, 1024, 1, False),
                "K600": (12, 3000, 50, False), "K2100": (12, 3000, 175, False),
                "K8_all_fixed": (8, 1024, 1, True), "L0": (8, 1024, 1, False)}


def _b_card_inputs(device, case):
    """Kernel B's seed and back-substitution arguments on the card; the
    camera step is small (1e-5), so the trial cost stays well conditioned,
    and zero at one camera (one observation a landmark: V is rank 2)."""
    K, n_pts, copies, all_fixed = B_CARD_CASES[case]
    sc = make_synthetic_scene(n_cams=K, n_pts=n_pts, pixel_noise=0.4, seed=7)
    rng = np.random.default_rng(7)
    cam_idx = (sc.cam_idx + K * rng.integers(0, copies, sc.cam_idx.shape)).astype(np.int32)
    n = K * copies
    cf = np.ones(n, bool) if all_fixed else (np.arange(n) == 0) & (n > 1)
    prob, _ = td.densify_problem(sc.K4, cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
                                 cf, n_pts, max_obs=16, device=device)
    cm = td._to_cm(prob)
    cams = torch.from_numpy(np.tile(sc.extr_init, (copies, 1))).to(device)
    R = aa_to_rotmat(cams[:, :3]).contiguous()
    t = cams[:, 3:].contiguous()
    Xt = torch.from_numpy(sc.points_init).to(device).T.contiguous()
    args = (cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t)
    _, _, Vu, gp, W = dk.eval_assemble_plain(*args, R, t, Xt)
    O, L = cm.cam_t.shape
    W18 = W.reshape(18, O, L)
    vinv6 = dk.schur_prepare_plain(torch.tensor(1e-3, device=device), Vu, gp,
                                   cm.pt_valid, W18, cm.cam_t, n)[2]
    dc = torch.from_numpy(rng.normal(0, 1e-5, (n, 6)).astype(np.float32)).to(device)
    dc = torch.where(cm.cam_fixed[:, None], torch.zeros_like(dc), dc)
    if n == 1:
        dc, gp = torch.zeros_like(dc), torch.zeros_like(gp)
    R_new = (aa_to_rotmat(dc[:, :3]) @ R).contiguous()
    t_new = (t + dc[:, 3:]).contiguous()
    seed = (*args, R, t, Xt)
    bs = (*args, R_new, t_new, dc.contiguous(), Xt, W18, vinv6, gp, cm.pt_valid)
    if case == "L0":
        cut = lambda x: x[..., :0].contiguous()
        seed = (args[0], *map(cut, args[1:]), R, t, cut(Xt))
        bs = (args[0], *map(cut, args[1:]), R_new, t_new, bs[8], cut(Xt),
              *map(cut, bs[10:]))
    return seed, bs


@pytest.mark.parametrize("case", list(B_CARD_CASES))
def test_dense_eval_kernel_matches_plain_on_card(cuda_device, case):
    """Kernel B (seed and back-substitution) against its plain version, and
    against the plain version summed in the kernel's blocking (`plan=`):
    1, 8, 600 (5 camera tiles) and 2,100 cameras (17 tiles), every camera
    fixed, and no landmarks (red and the cost written as zeros). One
    wrapper call is one launch."""
    seed, bs = _b_card_inputs(cuda_device, case)
    O, L = seed[1].shape
    plan = dk.dense_eval_plan(seed[6].shape[0], L, O, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    kernels.reset_launch_counts()
    got, got_bs = dk.eval_assemble(*seed), dk.eval_assemble_bs(*bs)
    assert kernels.launch_counts()["dense_eval_assemble"] == 1
    assert kernels.launch_counts()["dense_eval_assemble_bs"] == 1
    if case == "L0":
        for g_all in (got, got_bs):
            assert float(g_all[0]) == 0.0 and g_all[1].shape == (8, 27)
            assert not g_all[1].any()
            assert g_all[2].shape == (6, 0) and g_all[4].shape == (6, 3, O, 0)
        return
    for g_all, plain in ((got, dk.eval_assemble_plain), (got_bs, dk.eval_assemble_bs_plain)):
        args = seed if plain is dk.eval_assemble_plain else bs
        for ref in (plain(*args), plain(*args, plan=plan)):
            assert_close(g_all[0], ref[0], rtol=1e-5, atol=0)
            for g, r, name in zip(g_all[1:5], ref[1:5], ("red", "Vu", "g_p", "W")):
                assert_blocks_close(name, g, r)
            for g, r in zip(g_all[5:], ref[5:]):  # Xt_new
                assert_close(g, r)
    if case == "K8_all_fixed":
        assert not got[1].any() and not got_bs[1].any()


@pytest.mark.parametrize("case", ["K8", "K600"])
def test_dense_eval_two_calls_bit_identical_on_card(cuda_device, case):
    """Two calls of kernel B on the same inputs give the same bits in every
    output, red and the cost included (no atomics)."""
    seed, bs = _b_card_inputs(cuda_device, case)
    for fn, args in ((dk.eval_assemble, seed), (dk.eval_assemble_bs, bs)):
        x, y = fn(*args), fn(*args)
        for a, b in zip(x, y):
            assert torch.equal(a, b)


@pytest.mark.parametrize("copies", [1, 50])
def test_dense_kernels_match_plain_on_card(cuda_device, copies):
    """B, C and B with back-substitution at 12 cameras, and at 600 (12 x 50
    copies: kernel B in 5 camera tiles)."""
    prob, cams, pts = _scene(12, 3000, 7, 0.4, cuda_device, copies=copies)
    cm = td._to_cm(prob)
    K = cm.cam_fixed.shape[0]
    R = aa_to_rotmat(cams[:, :3]).contiguous()
    t = cams[:, 3:].contiguous()
    Xt = pts.T.contiguous()
    args = (cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t)
    names = ("red", "Vu", "g_p", "W")
    seed_k = dk.eval_assemble(*args, R, t, Xt)
    seed_p = dk.eval_assemble_plain(*args, R, t, Xt)
    assert_close(seed_k[0], seed_p[0], rtol=1e-5, atol=0)
    for g, r, n in zip(seed_k[1:], seed_p[1:], names):
        assert_blocks_close(n, g, r)

    _, red, Vu, gp, W = seed_p
    O, L = cm.cam_t.shape
    W18 = W.reshape(18, O, L)
    c_args = (torch.tensor(1e-3, device=cuda_device), Vu, gp, cm.pt_valid, W18,
              cm.cam_t, K, red, cm.cam_fixed)
    s_k = dk.schur_prepare_s(*c_args)
    s_p = dk.schur_prepare_s_plain(*c_args)
    assert_blocks_close("S", s_k[0], s_p[0])
    assert_blocks_close("b", s_k[3], s_p[3])
    for g, r in zip(s_k[1:3], s_p[1:3]):  # zv, vinv6
        assert_close(g, r)

    S, _, vinv6, b = s_p
    dc = torch.linalg.solve(S.double(), b.double()).float().reshape(6, K).T
    dc = torch.where(cm.cam_fixed[:, None], torch.zeros_like(dc), dc).contiguous()
    R_new = (aa_to_rotmat(dc[:, :3]) @ R).contiguous()
    t_new = (t + dc[:, 3:]).contiguous()
    bs_args = (*args, R_new, t_new, dc, Xt, W18, vinv6, gp, cm.pt_valid)
    bs_k = dk.eval_assemble_bs(*bs_args)
    bs_p = dk.eval_assemble_bs_plain(*bs_args)
    assert_close(bs_k[0], bs_p[0], rtol=1e-5, atol=0)
    for g, r, n in zip(bs_k[1:5], bs_p[1:5], names):
        assert_blocks_close(n, g, r)
    assert_close(bs_k[5], bs_p[5])


def test_dense_solve_kernels_match_plain_on_card(cuda_device):
    prob, cams, pts = _scene(8, 200, 32, 0.3, cuda_device)
    cfg = LMConfig(max_iters=15)
    ck, _, ik = td.dense_ba_solve(prob, cams, pts, cfg)
    cp, _, ip = td.dense_ba_solve(prob, cams, pts, cfg, ops=dk.PLAIN_OPS)
    np.testing.assert_allclose(ck.cpu().numpy(), cp.cpu().numpy(), atol=5e-4)
    np.testing.assert_allclose(float(ik["cost"]), float(ip["cost"]), rtol=1e-3)
    assert float(ik["cost"]) < float(ik["cost0"])


def test_dense_pcg_solve_kernels_match_plain_on_card(cuda_device):
    """The dense PCG solve through kernel B (without back-substitution)
    against the plain versions: cameras within the JAX package's PCG bound
    (5e-3), costs within rel 1e-3; B launched once for the seed eval and
    once an LM iteration, C, K5, D, E and B with back-substitution never."""
    prob, cams, pts = _scene(8, 200, 32, 0.3, cuda_device)
    cfg = LMConfig(max_iters=10, solver="pcg", pcg_iters=60)
    kernels.reset_launch_counts()
    ck, _, ik = td.dense_ba_solve(prob, cams, pts, cfg)
    counts = kernels.launch_counts()
    cp, _, ip = td.dense_ba_solve(prob, cams, pts, cfg, ops=dk.PLAIN_OPS)
    np.testing.assert_allclose(ck.cpu().numpy(), cp.cpu().numpy(), atol=5e-3)
    np.testing.assert_allclose(float(ik["cost"]), float(ip["cost"]), rtol=1e-3)
    assert float(ik["cost"]) < float(ik["cost0"])
    assert counts["dense_eval_assemble"] == 1 + cfg.max_iters
    assert not any(counts[n] for n in ("dense_eval_assemble_bs", "schur_prepare_s",
                                       "schur_qqt_partial", "schur_prepare",
                                       "chol_solve"))


def _prepare_args(device, copies):
    """The inputs of K5 and kernel D at 12 x `copies` cameras."""
    prob, cams, pts = _scene(12, 3000, 7, 0.4, device, copies=copies)
    cm = td._to_cm(prob)
    O, L = cm.cam_t.shape
    R = aa_to_rotmat(cams[:, :3]).contiguous()
    _, _, Vu, gp, W = dk.eval_assemble_plain(
        cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t, R,
        cams[:, 3:].contiguous(), pts.T.contiguous())
    return (torch.tensor(1e-3, device=device), Vu, gp, cm.pt_valid,
            W.reshape(18, O, L), cm.cam_t, cm.cam_fixed.shape[0])


def _check_prepare(args):
    O, L = args[5].shape
    got, ref = dk.schur_prepare(*args), dk.schur_prepare_plain(*args)
    assert_blocks_close("W", got[0].reshape(6, 3, O, L), ref[0].reshape(6, 3, O, L))
    assert_blocks_close("red6", got[3], ref[3])
    for g, r in zip(got[1:3], ref[1:3]):  # zv, vinv6
        assert_close(g, r)


@pytest.mark.parametrize("copies", [1, 50])
def test_schur_partial_and_prepare_match_plain_on_card(cuda_device, copies):
    """K5 and kernel D at 12 cameras and at 600 (12 x 50 copies)."""
    args = _prepare_args(cuda_device, copies)
    got, ref = dk.schur_qqt_partial(*args), dk.schur_qqt_partial_plain(*args)
    assert_blocks_close("S", got[0], ref[0])
    assert_blocks_close("red6", got[3], ref[3])
    for g, r in zip(got[1:3], ref[1:3]):  # zv, vinv6
        assert_close(g, r)
    _check_prepare(args)


def test_schur_prepare_global_atomics_match_plain_on_card(cuda_device):
    """Kernel D at 2,100 cameras (12 x 175 copies), where the parent design
    summed red6 with global atomics: now in 5 camera tiles of 420."""
    _check_prepare(_prepare_args(cuda_device, 175))


D_CARD_CASES = ["K1", "K8", "K12", "K600", "K2100", "config7_1", "config7_500",
                "K8_all_fixed", "L0"]


def _d_card_args(device, case):
    """Kernel D's arguments of one card case: the config-7 shape (71
    cameras, 10,842 landmarks, O = 72) with 1 or 500 landmarks seen by every
    camera, K5's 12-camera inputs, or from kernel B's card cases (1 free
    camera, 8, 600 and 2,100 cameras, every camera fixed, no landmarks)."""
    if case.startswith("config7"):
        args = _schur_case(device, case)[:7]
        assert args[5].shape[0] == 72
        return args
    if case == "K12":
        return _prepare_args(device, 1)
    seed, _ = _b_card_inputs(device, case)
    _, _, Vu, gp, W = dk.eval_assemble_plain(*seed)
    cam_t = seed[1]
    O, L = cam_t.shape
    return (torch.tensor(1e-3, device=device), Vu, gp, seed[4].any(0),
            W.reshape(18, O, L), cam_t, seed[6].shape[0])


@pytest.mark.parametrize("case", list(D_CARD_CASES))
def test_schur_prepare_kernel_matches_planned_plain_on_card(cuda_device, case):
    """Kernel D against its plain version and against the plain version
    summed in the kernel's blocking (`plan=`): 1, 8, 12, 600 (2 camera
    tiles) and 2,100 cameras (5 tiles), the config-7 shape with 1 and 500
    landmarks seen by every camera, every camera fixed, and no landmarks
    (red6 written as zeros). One wrapper call is one launch; two calls give
    the same bits in every output."""
    args = _d_card_args(cuda_device, case)
    O, L = args[5].shape
    K = args[6]
    plan = dk.schur_prepare_plan(K, L, O, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    kernels.reset_launch_counts()
    got = dk.schur_prepare(*args)
    assert kernels.launch_counts()["schur_prepare"] == 1
    again = dk.schur_prepare(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if case == "L0":
        assert got[3].shape == (6, K) and not got[3].any()
        assert got[0].shape == (18, O, 0)
        return
    for ref in (dk.schur_prepare_plain(*args), dk.schur_prepare_plain(*args, plan=plan)):
        assert_blocks_close("W", got[0].reshape(6, 3, O, L), ref[0].reshape(6, 3, O, L))
        assert_blocks_close("red6", got[3], ref[3])
        for g, r in zip(got[1:3], ref[1:3]):  # zv, vinv6
            assert_close(g, r)
    if case == "K8_all_fixed":
        assert not got[0].any() and not got[3].any()


def test_schur_prepare_launches_only_its_own_kernels_on_card(cuda_device):
    """A call of kernel D launches D's own kernels (the units and the
    finishing pass) and nothing else: no zeroing launch."""
    from torch.profiler import ProfilerActivity, profile

    args = _d_card_args(cuda_device, "K12")
    dk.schur_prepare(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dk.schur_prepare(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    assert names and all("schur_prepare" in n for n in names), names


def _schur_case(device, case):
    """Kernel C's inputs (lam, Vu, g_p, pt_valid, W18, cam_t, K, red27,
    cam_fixed) of one card case of C / K5."""
    if case.startswith("config7"):  # 71c / 10,842 / 156,774 obs, O = 72
        n_all = int(case.split("_")[1])
        sc = make_track_scene(n_all=n_all)
        cf = np.zeros(71, bool)
        cf[np.argsort(-np.bincount(sc.cam_idx, minlength=71), kind="stable")[:2]] = True
        prob, dropped = td.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                                           sc.sigma2, sc.valid, cf, sc.points_init.shape[0],
                                           max_obs=128, device=device)
        assert dropped == 0
        cams = torch.from_numpy(sc.extr_init).to(device)
        pts = torch.from_numpy(sc.points_init).to(device)
    else:  # 12 cameras, or 600 (12 x 50 copies)
        prob, cams, pts = _scene(12, 3000, 7, 0.4, device,
                                 copies=50 if case == "K600" else 1)
    cm = td._to_cm(prob)
    O, L = cm.cam_t.shape
    R = aa_to_rotmat(cams[:, :3]).contiguous()
    _, red, Vu, gp, W = dk.eval_assemble_plain(
        cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t, R,
        cams[:, 3:].contiguous(), pts.T.contiguous())
    args = (torch.tensor(1e-3, device=device), Vu, gp, cm.pt_valid,
            W.reshape(18, O, L), cm.cam_t, cm.cam_fixed.shape[0], red, cm.cam_fixed)
    if case == "K12_dup":  # every other landmark sees its first camera twice
        cam_t = cm.cam_t.clone()
        cam_t[1, ::2] = cam_t[0, ::2]
        args = (*args[:5], cam_t, *args[6:])
    if case == "L0":
        args = (args[0], Vu[:, :0], gp[:, :0], cm.pt_valid[:0],
                args[4][:, :, :0].contiguous(), cm.cam_t[:, :0].contiguous(),
                *args[6:])
    return args


def _check_schur(got, ref, rhs):
    assert_blocks_close("S", got[0], ref[0])
    assert_blocks_close(rhs, got[3], ref[3])
    for g, r in zip(got[1:3], ref[1:3]):  # zv, vinv6
        assert_close(g, r)


@pytest.mark.parametrize("case", ["config7_1", "config7_500", "K600", "K12",
                                  "K12_dup", "L0"])
def test_schur_s_kernels_match_plain_on_card(cuda_device, case):
    """Kernel C and K5 against their plain versions: the config-7 shape
    with 1 and 500 landmarks seen by every camera (3 tiles of 24: 71 is no
    multiple of 24), 600 cameras (18 tiles of 34, one chunk), 12 cameras
    (one tile), the same with landmarks that observe a camera twice, and
    no landmarks. One wrapper call is one launch."""
    args = _schur_case(cuda_device, case)
    kernels.reset_launch_counts()
    got_c = dk.schur_prepare_s(*args)
    got_q = dk.schur_qqt_partial(*args[:7])
    assert kernels.launch_counts()["schur_prepare_s"] == 1
    assert kernels.launch_counts()["schur_qqt_partial"] == 1
    _check_schur(got_c, dk.schur_prepare_s_plain(*args), "b")
    _check_schur(got_q, dk.schur_qqt_partial_plain(*args[:7]), "red6")


def test_schur_s_two_calls_agree_on_card(cuda_device):
    """Two calls of C (and of K5) on the same inputs at the config-7 shape
    (n_all = 500, the most contended tiles) agree to the per-block checks,
    and zv and vinv6 bit for bit. S and the rhs need not be bit-identical:
    the warps of a block add into shared entries in an order that changes
    from run to run (csrc/schur_s.cu)."""
    args = _schur_case(cuda_device, "config7_500")
    for fn, a, rhs in ((dk.schur_prepare_s, args, "b"),
                       (dk.schur_qqt_partial, args[:7], "red6")):
        x, y = fn(*a), fn(*a)
        _check_schur(x, y, rhs)
        assert torch.equal(x[1], y[1]) and torch.equal(x[2], y[2])


def test_schur_s_rejects_what_the_kernel_does_not_take(cuda_device):
    args = _schur_case(cuda_device, "K12")
    with pytest.raises(ValueError):
        dk.schur_prepare_s(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):
        dk.schur_qqt_partial(*args[:3], args[3].cpu(), *args[4:7])


def test_large_o_solve_kernels_match_plain_on_card(cuda_device):
    """O = 72: route (c), kernel D + Pf + Q Q^T."""
    sc = make_track_scene(n_cams=71, n_pts=300, n_obs=4000, n_all=20, seed=3)
    cf = np.zeros(71, bool)
    gauge = np.argsort(-np.bincount(sc.cam_idx, minlength=71), kind="stable")[:2]
    cf[gauge] = True
    sc.extr_init[gauge] = sc.extr_gt[gauge]
    prob, _ = td.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                 sc.valid, cf, 300, max_obs=128, device=cuda_device)
    cams = torch.from_numpy(sc.extr_init).to(cuda_device)
    pts = torch.from_numpy(sc.points_init).to(cuda_device)
    cfg = LMConfig(max_iters=10)
    kernels.reset_launch_counts()
    ck, _, ik = td.dense_ba_solve(prob, cams, pts, cfg)
    assert kernels.launch_counts()["schur_prepare"] == 10
    cp, _, ip = td.dense_ba_solve(prob, cams, pts, cfg, ops=dk.PLAIN_OPS)
    np.testing.assert_allclose(ck.cpu().numpy(), cp.cpu().numpy(), atol=5e-4)
    np.testing.assert_allclose(float(ik["cost"]), float(ip["cost"]), rtol=1e-3)
    assert float(ik["cost"]) < float(ik["cost0"])


def test_one_shard_sharded_solve_matches_plain_on_card(cuda_device):
    """The sharded engine without a group: route (b), K5."""
    sc = make_synthetic_scene(n_cams=8, n_pts=256, pixel_noise=0.3, seed=53)
    cf = np.zeros(8, bool)
    cf[:2] = True
    sc.extr_init[1] = sc.extr_gt[1]
    prob, pts, _, _ = tsh.shard_dense_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
        sc.points_init, 1, device=cuda_device)
    cams = torch.from_numpy(sc.extr_init).to(cuda_device)
    cfg = LMConfig(max_iters=8)
    kernels.reset_launch_counts()
    ck, _, ik = tsh.sharded_dense_ba_solve(prob, cams, pts, cfg)
    assert kernels.launch_counts()["schur_qqt_partial"] == 8
    cp, _, ip = td.dense_ba_solve(prob, cams, pts, cfg, ops=dk.PLAIN_OPS,
                                  reduce=lambda x: x)
    np.testing.assert_allclose(ck.cpu().numpy(), cp.cpu().numpy(), atol=5e-4)
    np.testing.assert_allclose(float(ik["cost"]), float(ip["cost"]), rtol=1e-3)


def _chol_case(N):
    rng = np.random.default_rng(N)
    A = rng.standard_normal((N, N)).astype(np.float32)
    S = A @ A.T + N * np.eye(N, dtype=np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    return S, b, np.linalg.solve(S.astype(np.float64), b)


def _rel(x, ref):
    x = x.cpu().numpy().astype(np.float64) if torch.is_tensor(x) else x
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("N", [1, 48, 50, 384, 426, 768, 1000, 3600])
def test_chol_solve_kernel_matches_plain_and_float64_on_card(cuda_device, N):
    """Kernel E against float64 and its plain version with the kernel's
    panels, in one launch; S is left as it was, and a second call on the
    same inputs gives the same x (no sum goes through an atomic)."""
    S, b, x64 = _chol_case(N)
    St, bt = as_tensor(S, cuda_device), as_tensor(b, cuda_device)
    kernels.reset_launch_counts()
    x = tc.chol_solve(St, bt)
    assert kernels.launch_counts()["chol_solve"] == 1
    xp = tc.chol_solve_plain(St, bt, panel=tc.PANEL_E).cpu().numpy().astype(np.float64)
    assert _rel(x, x64) < 1e-5 and _rel(x, xp) < 1e-5
    assert torch.equal(St, as_tensor(S, cuda_device))
    assert torch.equal(tc.chol_solve(St, bt), x)


def test_chol_solve_kernel_on_an_indefinite_system_on_card(cuda_device):
    """An indefinite S: the clamped pivots give huge or non-finite x (where
    the library call gives NaN), and the kernel returns."""
    S, b, _ = _chol_case(426)
    S = S - 2.0 * np.diag(np.diag(S))  # negative diagonal
    x = tc.chol_solve(as_tensor(S, cuda_device), as_tensor(b, cuda_device))
    torch.cuda.synchronize()
    assert x.shape == (426,)
    assert not bool(torch.isfinite(x).all()) or float(x.abs().max()) > 1e6


def test_chol_solve_rejects_what_the_kernel_does_not_take(cuda_device):
    S = torch.eye(16, device=cuda_device)
    b = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError):
        tc.chol_solve(S.double(), b.double())
    with pytest.raises(ValueError):
        tc.chol_solve(S[:, :8], b)
    with pytest.raises(ValueError):
        tc.chol_solve(S, b[:8])


def test_dense_solve_with_kernel_e_matches_plain_on_card(cuda_device):
    """The dense LM solve with the camera system solved by kernel E
    (KERNEL_OPS_CHOL) against the plain versions (PLAIN_OPS_CHOL)."""
    prob, cams, pts = _scene(8, 200, 32, 0.3, cuda_device)
    cfg = LMConfig(max_iters=10)
    kernels.reset_launch_counts()
    ck, _, ik = td.dense_ba_solve(prob, cams, pts, cfg, ops=dk.KERNEL_OPS_CHOL)
    assert kernels.launch_counts()["chol_solve"] == 10
    cp, _, ip = td.dense_ba_solve(prob, cams, pts, cfg, ops=dk.PLAIN_OPS_CHOL)
    np.testing.assert_allclose(ck.cpu().numpy(), cp.cpu().numpy(), atol=5e-4)
    np.testing.assert_allclose(float(ik["cost"]), float(ip["cost"]), rtol=1e-3)
    assert float(ik["cost"]) < float(ik["cost0"])


def _gray_frames(n, width, height, fx):
    from bundleadjustment_tpu_torch.data.synthetic import render_plane_sequence

    frames, K4 = render_plane_sequence(n_frames=n, width=width, height=height,
                                       fx=fx, fy=fx, motion_step=0.06)
    return frames, K4


def test_detect_batch_matches_per_frame_on_card(cuda_device):
    """The batched detector against per-frame detection on the card, with
    the JAX parity bounds of tests/test_torch_features.py (the batched
    pyramid resize may take another cuBLAS algorithm than a single frame's):
    >= 99% of keypoints identical, their descriptors bit-identical."""
    from bundleadjustment_tpu_torch.ops import features as tf

    frames, _ = _gray_frames(8, 640, 480, 525.0)
    imgs = torch.from_numpy(np.stack([f["gray"] for f in frames]).astype(np.float32))
    imgs = imgs.to(cuda_device)
    cfg = tf.FeatureConfig(n_features=1000, n_levels=8)
    batch = tf.detect_batch(imgs, cfg)
    for i in range(len(frames)):
        one = tf.detect_and_describe(imgs[i], cfg)
        same = ((batch.xy[i] - one.xy).abs().amax(1) < 1e-3) & (
            batch.valid[i] == one.valid) & (batch.octave[i] == one.octave)
        assert float(same.float().mean()) >= 0.99
        assert torch.equal(batch.desc[i][same], one.desc[same])
    assert int(batch.valid.sum()) > 0.5 * batch.valid.numel()


def test_icp_on_card_matches_cpu(cuda_device):
    """`icp_align` on the card against its CPU run on a moved, noisy
    subset of a bumpy ellipsoid (tests/test_torch_reconstruction.py's
    scene): n_corr equal, R and t within 1e-4, fitness within 1e-4
    relative; blocks of 300 source rows."""
    from bundleadjustment_tpu_torch.metrics.reconstruction import icp_align

    rng = np.random.default_rng(0)
    v = rng.normal(size=(3000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    th, ph = np.arccos(v[:, 2]), np.arctan2(v[:, 1], v[:, 0])
    dst = v * (1.0 + 0.2 * np.sin(3 * th) * np.cos(2 * ph))[:, None] * [1.0, 0.8, 0.6]
    c, s = np.cos(0.05), np.sin(0.05)
    R0 = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    src = dst[:2000] @ R0.T + [0.02, -0.015, 0.01] + rng.normal(scale=0.005, size=(2000, 3))
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    ref = icp_align(src, dst, chunk=300, device="cpu")
    got = icp_align(src, dst, chunk=300, device=cuda_device)
    assert got["n_corr"] == ref["n_corr"] == 2000
    np.testing.assert_allclose(got["R"], ref["R"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["fitness"], ref["fitness"], rtol=1e-4)


def test_checkpoint_written_on_card_resumes_on_card(cuda_device, tmp_path):
    """6 frames at 160x120 on the card, cut after 3: saved, loaded onto the
    card, resumed; against the uninterrupted card run: every frame tracked,
    positions within 2e-3 m, ATE < 0.06 m (tests/test_checkpoint.py)."""
    from bundleadjustment_tpu_torch.data.tum import FrameData
    from bundleadjustment_tpu_torch.metrics.ate import evaluate_ate
    from bundleadjustment_tpu_torch.pipeline.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
    from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline

    frames, K4 = _gray_frames(6, 160, 120, 150.0)
    ds = [FrameData(index=i, timestamp=f["timestamp"], gray=f["gray"],
                    depth=f["depth"], rgb=None, gt_cam_to_world=f["gt_cam_to_world"])
          for i, f in enumerate(frames)]
    cfg = PipelineConfig(init_type="gtdepth", estimation="ba", n_features=300,
                         n_levels=3, local_ba=False, final_ba_outer=1,
                         final_ba_iters=5)
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])

    def finish(pipe):
        pipe.finalize()
        ts, mats = pipe.trajectory_cam_to_world()
        return mats, evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)["rmse"]

    straight = BundleAdjustmentPipeline(cfg, K4, 160, 120, device=cuda_device)
    for f in ds:
        straight.process_frame(f)
    cut = BundleAdjustmentPipeline(cfg, K4, 160, 120, device=cuda_device)
    for f in ds[:3]:
        cut.process_frame(f)
    path = str(tmp_path / "card.npz")
    save_checkpoint(path, cut)
    resumed = load_checkpoint(path, cfg, device=cuda_device)
    assert resumed.device == cuda_device and resumed._prev_track is None
    statuses = [resumed.process_frame(f) for f in ds[3:]]
    assert all(s in ("tracked", "keyframe") for s in statuses), statuses
    mats_a, ate_a = finish(straight)
    mats_c, ate_c = finish(resumed)
    assert len(mats_c) == 6 and ate_a < 0.06 and ate_c < 0.06, (ate_a, ate_c)
    assert np.abs(mats_a[:, :3, 3] - mats_c[:, :3, 3]).max() < 2e-3
