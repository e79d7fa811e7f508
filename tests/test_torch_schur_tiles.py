"""Kernel C / K5's blocking on the CPU: the host plan
(`dense_kernels.schur_s_plan`) and the plain versions summed in the
kernel's blocking (`plan=`: tile pair by tile pair, chunk by chunk).

The tiled plain versions are held to the unplanned ones and to the Pallas
kernel in interpret mode (`fused_schur_prepare_s`, float32), with
`fold_u=True` (C: S, b) and without red27 (K5: +Q Q^T, red6, permuted to
the reference's (k, i) order). Tolerances: the JAX package's Pallas-vs-XLA
bounds, rtol 2e-4 / atol 2e-3 relative to each block's own magnitude for S,
b and red6 (their sums cancel, `torch_port_helpers.block_scale`); zv and
vinv6 elementwise. The kernels themselves are held to these plain versions
on the card (tests/test_torch_cuda.py)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.solvers import pallas_dense_eval as jp
from bundleadjustment_tpu_torch.data.track_scene import make_track_scene
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from torch_port_helpers import assert_blocks_close, assert_close

N_SM = 132  # an H100 SXM's SMs

# name: (cameras, landmarks, scene, tile override, all cameras fixed)
CASES = {
    "K1": (1, 40, "arc", None, False),
    "K6": (6, 150, "arc", None, False),
    "K6_all_fixed": (6, 150, "arc", None, True),
    # landmarks 0-1 seen by every camera; 37 = 2 x 16 + 5
    "K37_tile16": (37, 120, "track", 16, False),
    "K38": (38, 120, "track", None, False),
    # two tiles of 36, O = 72 (three 32-lane rounds a landmark)
    "K71": (71, 120, "track", None, False),
    "K71_tile8": (71, 120, "track", 8, False),
}


def _inputs(K, n_pts, scene, all_fixed, seed=3):
    """(lam, Vu, g_p, pt_valid, W18, cam_t, K, red27, cam_fixed) on the CPU,
    from the port's plain kernel B at the scene's initial values."""
    if scene == "arc":
        sc = make_synthetic_scene(n_cams=K, n_pts=n_pts, pixel_noise=0.4, seed=seed)
    else:
        n_all = 2
        n_obs = n_all * K + 3 * (n_pts - n_all)
        sc = make_track_scene(n_cams=K, n_pts=n_pts, n_obs=n_obs, n_all=n_all,
                              seed=seed)
    cf = np.ones(K, bool) if all_fixed else np.arange(K) == 0
    prob, _ = td.densify_problem(sc.K4, sc.cam_idx.astype(np.int32), sc.pt_idx,
                                 sc.uv, sc.sigma2, sc.valid, cf, n_pts,
                                 max_obs=128, device="cpu")
    cm = td._to_cm(prob)
    cams = torch.from_numpy(sc.extr_init).float()
    _, red, Vu, gp, W = dk.eval_assemble_plain(
        cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t,
        aa_to_rotmat(cams[:, :3]), cams[:, 3:].contiguous(),
        torch.from_numpy(sc.points_init).float().T.contiguous())
    O, L = cm.cam_t.shape
    return (torch.tensor(1e-3), Vu, gp, cm.pt_valid, W.reshape(18, O, L),
            cm.cam_t, K, red, cm.cam_fixed)


def _ki(S, K):
    """[6K,6K] in (i, k) row order -> (k, i) order (row k*6 + i)."""
    return S.reshape(6, K, 6, K).permute(1, 0, 3, 2).reshape(6 * K, 6 * K)


def _pallas(args, fold):
    lam, Vu, gp, pt_valid, W18, cam_t, K, red, cf = args
    j = [jnp.asarray(x.numpy()) for x in (Vu, gp, pt_valid, W18, cam_t)]
    return jp.fused_schur_prepare_s(
        jnp.float32(float(lam)), *j, K, red27=jnp.asarray(red.numpy()) if fold else None,
        cam_fixed=jnp.asarray(cf.numpy()) if fold else None, s_bf16=False,
        interpret=True)


def _plan(args, tile):
    O, L = args[5].shape
    return dk.schur_s_plan(args[6], L, O, N_SM, tile)


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_plain_matches_plain_and_pallas(case):
    K, n_pts, scene, tile, all_fixed = CASES[case]
    args = _inputs(K, n_pts, scene, all_fixed)
    plan = _plan(args, tile)
    if tile:
        assert plan.n_tiles > 1 and K % plan.tile
    # C: tiled against unplanned, then against the Pallas kernel
    got = dk.schur_prepare_s_plain(*args, plan=plan)
    flat = dk.schur_prepare_s_plain(*args)
    ref = _pallas(args, fold=True)
    for want in (flat, ref):
        assert_blocks_close("S", got[0], want[0])
        assert_blocks_close("b", got[3], want[3])
        assert_close(got[1], want[1])
        assert_close(got[2], want[2])
    if all_fixed:  # no landmark term: identity blocks + 1e-8 I, b = 0
        eye = torch.eye(6 * K) * (1 + 1e-8)
        assert torch.allclose(got[0], eye) and not got[3].any()
    # K5
    got = dk.schur_qqt_partial_plain(*args[:7], plan=plan)
    flat = dk.schur_qqt_partial_plain(*args[:7])
    ref = _pallas(args, fold=False)
    assert_blocks_close("S", got[0], flat[0])
    assert_blocks_close("red6", got[3], flat[3])
    assert_blocks_close("S", _ki(got[0], K), ref[0])
    assert_blocks_close("red6", got[3].T, ref[3])
    assert_close(got[1], ref[1])
    assert_close(got[2], ref[2])


def test_tiled_plain_with_a_camera_seen_twice():
    """Every other landmark observes its first camera twice (the kernels'
    atomic path): the tiled plain C against the unplanned one and Pallas."""
    args = list(_inputs(37, 120, "track", False))
    cam_t = args[5].clone()
    cam_t[1, ::2] = cam_t[0, ::2]
    args[5] = cam_t
    got = dk.schur_prepare_s_plain(*args, plan=_plan(args, 16))
    for want in (dk.schur_prepare_s_plain(*args), _pallas(args, fold=True)):
        assert_blocks_close("S", got[0], want[0])
        assert_blocks_close("b", got[3], want[3])


def test_tiled_plain_without_landmarks():
    """L = 0: C gives the damped U embed + 1e-8 I and b = -g_c (g_c zero
    for fixed cameras), K5 zeros, and the plan launches no landmark pass."""
    args = _inputs(6, 150, "arc", False)
    K, red, cf = args[6], args[7], args[8]
    empty = (args[0], args[1][:, :0], args[2][:, :0], args[3][:0],
             args[4][:, :, :0].contiguous(), args[5][:, :0].contiguous(), K)
    plan = dk.schur_s_plan(K, 0, args[5].shape[0], N_SM)
    assert plan.chunks == 0 and plan.scratch_bytes == 0
    S, zv, vinv6, b = dk.schur_prepare_s_plain(*empty, red, cf, plan=plan)
    S_ref, b_ref = dk.damped_system(args[0], red, cf, torch.zeros(6 * K, 6 * K),
                                    torch.zeros(6, K))
    assert torch.equal(S, S_ref) and torch.equal(b, b_ref)
    assert zv.shape == (3, 0) and vinv6.shape == (6, 0)
    S_q, _, _, red6 = dk.schur_qqt_partial_plain(*empty, plan=plan)
    assert not S_q.any() and not red6.any()


def _cover(plan, K):
    """How often each ordered camera pair is written: once by its upper
    tile pair, or by the mirror of the pair below the diagonal."""
    n = np.zeros((K, K), int)
    T = plan.tile
    for I, J in plan.pairs:
        ri, rj = slice(I * T, min(K, I * T + T)), slice(J * T, min(K, J * T + T))
        n[ri, rj] += 1
        if I != J:
            n[rj, ri] += 1
    return n


PLAN_SHAPES = [
    # (K, L, O, tile): the chip's shapes, and small ones with tiles forced
    (8, 1024, 8, None), (64, 10_000, 16, None), (128, 100_000, 8, None),
    (71, 10_842, 72, None), (600, 3_000, 16, None), (2_100, 3_000, 16, None),
    (1, 10, 1, None), (40, 500, 8, None), (41, 500, 8, None), (37, 120, 72, 16),
    (71, 120, 72, 8), (6, 0, 8, None), (10, 100, 512, None), (10, 100, 960, None),
]


@pytest.mark.parametrize("K,L,O,tile", PLAN_SHAPES)
def test_schur_plan_invariants(K, L, O, tile):
    plan = dk.schur_s_plan(K, L, O, N_SM, tile)
    T, nt = plan.tile, plan.n_tiles
    assert nt * T >= K > (nt - 1) * T
    assert plan.pairs == ([(i, i) for i in range(nt)]
                          + [(i, j) for i in range(nt) for j in range(i + 1, nt)])
    assert (_cover(plan, K) == 1).all()
    # the tile fits in a block's 227 KB of shared memory
    assert plan.smem_bytes == dk.schur_tile_bytes(T, plan.slots, O) <= dk.SMEM_MAX_BYTES
    # one landmark's slots fit in a batch, and the spare shared memory holds
    # at most 64 landmarks' worth more
    assert max(dk.SCHUR_SLOTS, O) <= plan.slots <= max(dk.SCHUR_SLOTS, 64 * O)
    if tile is None:
        t_max = dk.schur_tile_max(plan.slots, O)
        assert nt == -(-K // t_max)
        assert (nt == 1) == (K <= t_max)
    # the scratch bound: the cap, or one chunk's slabs (at most a padded S
    # and its rhs)
    one_chunk = 4 * (len(plan.pairs) * 36 * T * T + nt * 6 * T)
    assert plan.scratch_bytes == plan.chunks * one_chunk
    assert plan.scratch_bytes <= max(dk.SCHUR_SCRATCH_CAP, one_chunk)
    assert one_chunk <= 4 * ((6 * nt * T) ** 2 + 6 * nt * T)
    assert (plan.chunks == 0) == (L == 0)
    if L:
        # every landmark in exactly one chunk, and every chunk holds some
        chunk_of = (np.arange(L) // dk.SCHUR_UNIT) % plan.chunks
        assert set(chunk_of.tolist()) == set(range(plan.chunks))
        blocks = len(plan.pairs) * plan.chunks
        if len(plan.pairs) >= N_SM // 2:
            assert plan.chunks == 1
        elif (-(-L // dk.SCHUR_UNIT) >= 2 * N_SM
              and plan.scratch_bytes < dk.SCHUR_SCRATCH_CAP):
            assert 2 * N_SM - len(plan.pairs) < blocks <= 2 * N_SM  # two waves


def test_schur_plan_at_the_main_shapes():
    """The pipeline's K = 8 is one tile; 128 cameras are 4 tiles of 32 in
    about two waves; 600 cameras fill the card with their pairs alone."""
    p8 = dk.schur_s_plan(8, 1024, 8, N_SM)
    assert (p8.n_tiles, p8.tile) == (1, 8)
    p128 = dk.schur_s_plan(128, 100_000, 8, N_SM)
    assert (p128.n_tiles, p128.tile, len(p128.pairs)) == (4, 32, 10)
    assert 2 * N_SM - 10 < 10 * p128.chunks <= 2 * N_SM
    p600 = dk.schur_s_plan(600, 3_000, 16, N_SM)
    assert p600.chunks == 1 and len(p600.pairs) >= N_SM // 2
    p71 = dk.schur_s_plan(71, 10_842, 72, N_SM)
    assert (p71.n_tiles, p71.tile) == (3, 24)
    assert all(p.scratch_bytes <= dk.SCHUR_SCRATCH_CAP for p in (p8, p128, p600, p71))


def test_schur_plan_refuses_what_shared_memory_cannot_stage():
    """A landmark's slots are staged at once: past 960 slots no tile fits."""
    with pytest.raises(ValueError, match="shared memory"):
        dk.schur_s_plan(10, 100, 4096, N_SM)


def test_tile_override_sizes_are_exact():
    """Tile sizes from 1 to the largest at K = 41 still cover each camera
    pair exactly once."""
    for T in itertools.chain(range(1, 9), (13, 20, dk.schur_tile_max())):
        plan = dk.schur_s_plan(41, 100, 8, N_SM, T)
        assert plan.tile == T and (_cover(plan, 41) == 1).all()
