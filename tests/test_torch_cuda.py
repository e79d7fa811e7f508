"""Card-only tests of the port: each hand-written kernel against its plain
PyTorch version on the same CUDA tensors. They skip without a card.

This file imports no jax, so it runs on a machine with a card and without
jax: `python -m pytest --noconftest tests/test_torch_cuda.py -q`.

Tolerances: kernel A bit-identical. Kernel E (blocked Cholesky solve):
relative max error < 1e-5 against float64 on S = A A^T + N I, and the same
against its plain version with the same panels, and bit-identical between
two calls. Kernels B, C, K5 and D sum per-camera
rows, S and b with float atomics, in an order that changes from run to run:
cost rtol 1e-5; red, Vu, g_p, W, S, b, red6 and G rtol 2e-4 / atol 2e-3
relative to the max magnitude of each block
(`torch_port_helpers.block_scale`); zv, vinv6 and Xt_new elementwise. Dense
solves: cameras atol 5e-4, final cost rtol 1e-3.
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


@pytest.mark.parametrize("copies", [1, 50])
def test_dense_kernels_match_plain_on_card(cuda_device, copies):
    """12 cameras, and 600 (12 x 50 copies): there kernel B's [K,27] table
    exceeds its 48 KB of shared memory and the rows go to global atomics."""
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
    """Kernel D at 2,100 cameras (12 x 175 copies): its [6,K] table exceeds
    48 KB of shared memory and red6 is summed with global atomics."""
    _check_prepare(_prepare_args(cuda_device, 175))


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
