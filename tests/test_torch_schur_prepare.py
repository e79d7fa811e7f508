"""Kernel D's blocking on the CPU: the host plan
(`dense_kernels.schur_prepare_plan`) and the plain version summed in the
kernel's blocking (`schur_prepare_plain(..., plan=)`: red6 per block of the
plan, then over the blocks in the finishing pass's order).

The planned plain version is held to the unplanned one (G, zv and vinv6
bit for bit: the blocking changes only red6's sums) and to the Pallas
kernel in interpret mode (`fused_schur_prepare`), at the JAX package's
Pallas-vs-XLA bounds: G and red6 rtol 2e-4 / atol 2e-3 relative to each
block's own magnitude (their sums cancel, `torch_port_helpers.
block_scale`), zv and vinv6 elementwise. The kernel itself is held to the
planned plain version on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_tpu.solvers import pallas_dense_eval as jp
from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu_torch.data.track_scene import make_track_scene
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from torch_port_helpers import assert_blocks_close, assert_close

N_SM = 132  # an H100 SXM's SMs

# name: (cameras, landmarks, scene, copies, SMs the plan is made for: few
# SMs give few blocks with several rounds)
D_CASES = {
    "K1": (1, 40, "arc", 1, N_SM),
    "K8": (8, 150, "arc", 1, N_SM),
    "K8_one_sm_rounds": (8, 1500, "arc", 1, 1),
    "K71_O72": (71, 96, "track", 1, N_SM),
    "K2100_tiles": (12, 70, "arc", 175, N_SM),  # 5 camera tiles of 420
    "K8_all_fixed": (8, 150, "arc", 1, N_SM),
    "K8_invalid_landmarks": (8, 150, "arc", 1, N_SM),
    "K12_camera_seen_twice": (12, 120, "arc", 1, 3),
    "K8_one_slot": (8, 150, "arc", 1, N_SM),
}


def _d_inputs(case, seed=5):
    """(lam, Vu, g_p, pt_valid, W18, cam_t, K) of one case, on the CPU, from
    the plain seed eval."""
    K, n_pts, scene, copies, _ = D_CASES[case]
    if scene == "arc":
        sc = make_synthetic_scene(n_cams=K, n_pts=n_pts, pixel_noise=0.4, seed=seed)
    else:  # 71 cameras, 8 landmarks seen by every camera: O = 72
        sc = make_track_scene(n_cams=K, n_pts=n_pts, n_obs=1200, n_all=8, seed=seed)
    rng = np.random.default_rng(seed)
    cam_idx = (sc.cam_idx + K * rng.integers(0, copies, sc.cam_idx.shape)).astype(np.int32)
    n_cams = K * copies
    cf = (np.ones(n_cams, bool) if case == "K8_all_fixed"
          else (np.arange(n_cams) == 0) & (n_cams > 1))
    prob, _ = td.densify_problem(sc.K4, cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
                                 cf, n_pts, max_obs=128, device="cpu")
    cm = td._to_cm(prob)
    cams = torch.from_numpy(np.tile(sc.extr_init, (copies, 1))).float()
    R = aa_to_rotmat(cams[:, :3]).contiguous()
    Xt = torch.from_numpy(sc.points_init).float().T.contiguous()
    _, _, Vu, gp, W = dk.eval_assemble_plain(cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t,
                                             cm.valid_t, cm.fixed_t, R,
                                             cams[:, 3:].contiguous(), Xt)
    O, L = cm.cam_t.shape
    W18, cam_t, pt_valid = W.reshape(18, O, L), cm.cam_t, cm.pt_valid
    if case == "K8_invalid_landmarks":
        pt_valid = pt_valid.clone()
        pt_valid[::3] = False
    if case == "K12_camera_seen_twice":  # every other landmark, its first camera
        cam_t = cam_t.clone()
        cam_t[1, ::2] = cam_t[0, ::2]
    if case == "K8_one_slot":
        W18, cam_t = W18[:, :1].contiguous(), cam_t[:1].contiguous()
    return (torch.tensor(1e-3), Vu, gp, pt_valid, W18, cam_t, n_cams)


def _pallas(args):
    lam, Vu, gp, pt_valid, W18, cam_t, K = args
    return jp.fused_schur_prepare(jnp.float32(float(lam)), *(jnp.asarray(x.numpy())
                                  for x in (Vu, gp, pt_valid, W18, cam_t)), K,
                                  interpret=True)


def _check(got, want):
    O, L = got[0].shape[1:]
    assert_blocks_close("W", got[0].reshape(6, 3, O, L),
                        np.asarray(want[0]).reshape(6, 3, O, L))
    red6 = np.asarray(want[3])
    assert_blocks_close("red6", got[3], red6 if red6.shape == got[3].shape else red6.T)
    assert_close(got[1], want[1])
    assert_close(got[2], want[2])


@pytest.mark.parametrize("case", list(D_CASES))
def test_blocked_plain_d_matches_plain_and_pallas(case):
    args = _d_inputs(case)
    O, L = args[5].shape
    K = args[6]
    plan = dk.schur_prepare_plan(K, L, O, D_CASES[case][-1])
    if case == "K8_one_sm_rounds":
        assert plan.blocks > 1 and plan.rounds > 1
    if case == "K71_O72":
        assert O == 72 and plan.chunks > 1
    if case == "K2100_tiles":
        assert K == 2100 and plan.n_tiles == 5
    if case == "K8_one_slot":
        assert O == 1
    got = dk.schur_prepare_plain(*args, plan=plan)
    flat = dk.schur_prepare_plain(*args)
    for g, f in zip(got[:3], flat[:3]):  # G, zv, vinv6: the same arithmetic
        assert torch.equal(g, f)
    for want in (flat, _pallas(args)):
        _check(got, want)
    if case == "K8_all_fixed":  # every W is zero: no rhs term at all
        assert not got[0].any() and not got[3].any()
    if case == "K12_camera_seen_twice":
        assert (args[5][1, ::2] == args[5][0, ::2]).all() and got[3].any()


def test_blocked_plain_d_without_landmarks():
    """L = 0: no block; red6 is zeros, as the kernel's finishing pass writes
    it."""
    lam, Vu, gp, pt_valid, W18, cam_t, K = _d_inputs("K8")
    cut = lambda x: x[..., :0].contiguous()
    plan = dk.schur_prepare_plan(K, 0, cam_t.shape[0], N_SM)
    assert plan.blocks == 0 and plan.scratch_bytes == 0
    G, zv, vinv6, red6 = dk.schur_prepare_plain(lam, cut(Vu), cut(gp), pt_valid[:0],
                                                cut(W18), cut(cam_t), K, plan=plan)
    assert red6.shape == (6, K) and not red6.any()
    assert G.shape == (18, cam_t.shape[0], 0) and zv.shape == (3, 0)
    assert vinv6.shape == (6, 0)


def _pair_blocks(plan, O, L):
    """The unit, warp and block of every (slot, landmark) pair [O, L], as
    the kernel walks them."""
    o = np.arange(O)[:, None]
    l = np.arange(L)[None, :]
    unit = (l // 32) * plan.chunks + o // plan.slots
    warp = unit % (plan.blocks * plan.warps)
    return unit, warp, warp // plan.warps


PLAN_SHAPES = [
    # (K, L, O): the chip's shapes, and small and ragged ones
    (8, 1_024, 8), (64, 10_000, 16), (128, 100_000, 8), (600, 3_000, 16),
    (2_100, 3_000, 16), (71, 10_842, 72), (1, 10, 1), (8, 147, 3), (129, 5_000, 33),
    (20_000, 200, 8), (8, 0, 8),
]


@pytest.mark.parametrize("K,L,O", PLAN_SHAPES)
def test_schur_prepare_plan_invariants(K, L, O):
    plan = dk.schur_prepare_plan(K, L, O, N_SM)
    # the slot chunks and the camera tiles cover each slot and camera once
    assert plan.chunks * plan.slots >= O > (plan.chunks - 1) * plan.slots
    assert plan.chunks <= max(1, O)
    assert plan.units == -(-L // 32) * plan.chunks
    assert plan.n_tiles * plan.tile >= K > (plan.n_tiles - 1) * plan.tile
    assert plan.tile <= dk.PREP_TILE_MAX
    # a block's tables fit in shared memory, the slabs within their bound
    assert plan.smem_bytes == dk.schur_prepare_smem_bytes(plan.warps, plan.tile)
    assert plan.smem_bytes <= dk.SMEM_MAX_BYTES
    assert plan.scratch_bytes == 4 * plan.n_tiles * plan.blocks * 6 * plan.tile
    assert plan.scratch_bytes <= max(dk.PREP_SCRATCH_CAP, 24 * plan.n_tiles * plan.tile)
    if L == 0:
        assert plan.blocks == 0
        return
    # every pair in one unit, every unit on one warp, at most `rounds` a
    # warp, and every block busy
    unit, warp, block = _pair_blocks(plan, O, L)
    assert unit.max() < plan.units
    assert len(np.unique(unit)) == plan.units
    nw = plan.blocks * plan.warps
    assert plan.rounds == -(-plan.units // nw)
    assert np.bincount(np.unique(unit) % nw).max() <= plan.rounds
    assert set(np.unique(block).tolist()) == set(range(plan.blocks))
    assert (plan.blocks * plan.n_tiles * plan.warps
            <= max(N_SM * dk.PREP_SM_WARPS, plan.n_tiles * plan.warps))


@pytest.mark.parametrize("K,L,O", [(8, 1_024, 8), (8, 700, 8), (64, 10_000, 16),
                                   (128, 100_000, 8), (71, 10_842, 72),
                                   (600, 3_000, 16)])
def test_schur_prepare_plan_fills_the_card(K, L, O):
    """The pipeline's final BA (8 cameras, ~700-1,000 landmarks, O = 8), the
    config-7 global BA and the solve shapes give at least one block an SM,
    and the config-7 shape at least 16 warps an SM."""
    plan = dk.schur_prepare_plan(K, L, O, N_SM)
    assert plan.blocks * plan.n_tiles >= N_SM
    if O == 72:
        assert plan.blocks * plan.warps >= 16 * N_SM
