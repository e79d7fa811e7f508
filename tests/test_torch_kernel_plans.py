"""Kernels B and A's blocking on the CPU: the host plans
(`dense_kernels.dense_eval_plan`, `hamming.hamming_plan`) and the plain
versions summed or merged in the kernels' blocking (`plan=`).

Kernel B: the plain version with a plan sums red and the cost per block of
the plan, then over the blocks in the finishing pass's order. It is held to
the unplanned plain version and to the Pallas kernels in interpret mode
(`fused_eval_assemble`, `fused_eval_assemble_bs`), at the JAX package's
Pallas-vs-XLA bounds: cost rtol 1e-5; red, Vu, g_p and W rtol 2e-4 / atol
2e-3 relative to each block's own magnitude (their sums cancel,
`torch_port_helpers.block_scale`); Xt_new elementwise. Kernel A: each train
piece of the plan (a chunk's warp quarter) gets its own top-2, merged in the
kernel's order; held bit-identical to the unchunked plain version and to
`hamming_top2_pallas(interpret=True)`. The kernels themselves are held to
the plain versions on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_tpu.ops.pallas_matching import hamming_top2_pallas
from bundleadjustment_tpu.solvers import pallas_dense_eval as jp
from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu_torch.data.track_scene import make_track_scene
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu_torch.ops import hamming as th
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from torch_port_helpers import assert_blocks_close, assert_close

N_SM = 132  # an H100 SXM's SMs

# name: (cameras, landmarks, scene, copies, all cameras fixed, invalid share,
# SMs the plan is made for: few SMs give few blocks with several rounds)
B_CASES = {
    "K1": (1, 40, "arc", 1, False, 0.0, N_SM),
    "K8": (8, 150, "arc", 1, False, 0.0, N_SM),
    "K8_one_sm_rounds": (8, 600, "arc", 1, False, 0.0, 1),
    "K38": (38, 120, "track", 1, False, 0.0, N_SM),
    "K600": (12, 90, "arc", 50, False, 0.0, N_SM),  # 5 camera tiles of 120
    "K8_all_fixed": (8, 150, "arc", 1, True, 0.0, N_SM),
    "K8_invalid_slots": (8, 150, "arc", 1, False, 0.3, N_SM),
    "K8_ragged_units": (8, 147, "arc", 1, False, 0.0, 3),  # 147 = 36 x 4 + 3
}


def _b_inputs(case, seed=3):
    """(seed args, bs args, plan) of one case, on the CPU."""
    K, n_pts, scene, copies, all_fixed, invalid, n_sm = B_CASES[case]
    if scene == "arc":
        sc = make_synthetic_scene(n_cams=K, n_pts=n_pts, pixel_noise=0.4, seed=seed)
    else:
        n_all = 2
        sc = make_track_scene(n_cams=K, n_pts=n_pts, n_obs=n_all * K + 3 * (n_pts - n_all),
                              n_all=n_all, seed=seed)
    rng = np.random.default_rng(seed)
    cam_idx = (sc.cam_idx + K * rng.integers(0, copies, sc.cam_idx.shape)).astype(np.int32)
    valid = sc.valid & (rng.random(sc.valid.shape) >= invalid)
    n_cams = K * copies
    cf = np.ones(n_cams, bool) if all_fixed else (np.arange(n_cams) == 0) & (n_cams > 1)
    prob, _ = td.densify_problem(sc.K4, cam_idx, sc.pt_idx, sc.uv, sc.sigma2, valid,
                                 cf, n_pts, max_obs=128, device="cpu")
    cm = td._to_cm(prob)
    cams = torch.from_numpy(np.tile(sc.extr_init, (copies, 1))).float()
    R = aa_to_rotmat(cams[:, :3]).contiguous()
    t = cams[:, 3:].contiguous()
    Xt = torch.from_numpy(sc.points_init).float().T.contiguous()
    args = (cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t)
    _, red, Vu, gp, W = dk.eval_assemble_plain(*args, R, t, Xt)
    O, L = cm.cam_t.shape
    W18 = W.reshape(18, O, L)
    # the LM step of the damped Schur system (lam 1e-3), solved in float64
    S, _, vinv6, b = dk.schur_prepare_s_plain(torch.tensor(1e-3), Vu, gp, cm.pt_valid,
                                              W18, cm.cam_t, n_cams, red, cm.cam_fixed)
    dc = torch.linalg.solve(S.double(), b.double()).float().reshape(6, n_cams).T
    dc = torch.where(cm.cam_fixed[:, None], torch.zeros_like(dc), dc).contiguous()
    if n_cams == 1:
        # one observation a landmark leaves V rank 2, and a trial point
        # V^-1 (g_p + W^T dc) away from Xt meaningless: with dc and g_p zero
        # the trial point is Xt itself
        dc.zero_()
        gp = torch.zeros_like(gp)
    R_new = (aa_to_rotmat(dc[:, :3]) @ R).contiguous()
    t_new = (t + dc[:, 3:]).contiguous()
    bs = (*args, R_new, t_new, dc, Xt, W18, vinv6, gp, cm.pt_valid)
    return (*args, R, t, Xt), bs, dk.dense_eval_plan(n_cams, L, O, n_sm)


def _j(x):
    return jnp.asarray(x.numpy())


def _check(got, want):
    assert_close(got[0], want[0], rtol=1e-5, atol=0)
    for g, r, n in zip(got[1:5], want[1:5], ("red", "Vu", "g_p", "W")):
        assert_blocks_close(n, g, np.asarray(r).reshape(np.asarray(g).shape))
    for g, r in zip(got[5:], want[5:]):
        assert_close(g, r)


@pytest.mark.parametrize("case", list(B_CASES))
def test_blocked_plain_b_matches_plain_and_pallas(case):
    seed, bs, plan = _b_inputs(case)
    L = seed[1].shape[1]
    if case == "K8_one_sm_rounds":
        assert plan.blocks > 1 and plan.rounds > 1
    if case == "K8_ragged_units":
        assert plan.blocks > 1 and L % (32 // plan.lanes)
    if case == "K600":
        assert plan.n_tiles == 5
    got = dk.eval_assemble_plain(*seed, plan=plan)
    ref = jp.fused_eval_assemble(*map(_j, seed), interpret=True)
    for want in (dk.eval_assemble_plain(*seed), ref):
        _check(got, want)
    got_bs = dk.eval_assemble_bs_plain(*bs, plan=plan)
    ref_bs = jp.fused_eval_assemble_bs(*map(_j, bs), interpret=True)
    for want in (dk.eval_assemble_bs_plain(*bs), ref_bs):
        _check(got_bs, want)
    if case == "K8_all_fixed":  # no camera rows at all
        assert not got[1].any() and not got_bs[1].any()


def test_blocked_plain_b_without_landmarks():
    """L = 0: no block; red and the cost are zeros, as the kernel's
    finishing pass writes them."""
    seed, _, _ = _b_inputs("K8")
    empty = tuple(x[..., :0].contiguous() if x.dim() > 1 and i in (1, 2, 3, 4, 5, 8)
                  else x for i, x in enumerate(seed))
    plan = dk.dense_eval_plan(8, 0, 8, N_SM)
    assert plan.blocks == 0 and plan.scratch_bytes == 0
    cost, red, Vu, gp, W = dk.eval_assemble_plain(*empty, plan=plan)
    assert float(cost) == 0.0 and red.shape == (8, 27) and not red.any()
    assert Vu.shape == (6, 0) and gp.shape == (3, 0) and W.shape == (6, 3, 8, 0)


def _unit_blocks(plan, L):
    """The block of each landmark under the plan, as the kernel walks them."""
    unit = np.arange(L) // (32 // plan.lanes)
    return (unit % (plan.blocks * plan.warps)) // plan.warps


PLAN_SHAPES = [
    # (K, L, O): the chip's shapes, and small and ragged ones
    (8, 1_024, 8), (64, 10_000, 16), (128, 100_000, 8), (600, 3_000, 16),
    (2_100, 3_000, 16), (71, 10_842, 72), (1, 10, 1), (8, 147, 3), (128, 129, 8),
    (129, 5_000, 33), (8, 0, 8),
]


@pytest.mark.parametrize("K,L,O", PLAN_SHAPES)
def test_dense_eval_plan_invariants(K, L, O):
    plan = dk.dense_eval_plan(K, L, O, N_SM)
    S, G = plan.lanes, 32 // plan.lanes
    assert S & (S - 1) == 0 and S <= 32 and (S == 1 or S < 2 * O)
    assert plan.units == -(-L // G)
    # the tiles cover each camera once, and a block's tables fit in shared memory
    assert plan.n_tiles * plan.tile >= K > (plan.n_tiles - 1) * plan.tile
    assert plan.tile <= dk.DENSE_TILE_MAX
    assert plan.smem_bytes == dk.dense_eval_smem_bytes(plan.warps, plan.tile)
    assert plan.smem_bytes <= dk.SMEM_MAX_BYTES
    assert plan.scratch_bytes == 4 * plan.n_tiles * plan.blocks * (27 * plan.tile + 1)
    if L == 0:
        assert plan.blocks == 0
        return
    # every unit on one warp, at most `rounds` a warp, and every block busy
    nw = plan.blocks * plan.warps
    assert plan.rounds == -(-plan.units // nw) and (plan.blocks - 1) * plan.warps < plan.units
    assert set(_unit_blocks(plan, L).tolist()) == set(range(plan.blocks))
    assert (plan.blocks * plan.n_tiles * plan.warps
            <= max(N_SM * dk.DENSE_SM_WARPS, plan.n_tiles * plan.warps))


@pytest.mark.parametrize("K,L,O", [(8, 1_024, 8), (8, 700, 8), (64, 10_000, 16),
                                   (128, 100_000, 8), (600, 3_000, 16)])
def test_dense_eval_plan_fills_the_card(K, L, O):
    """The pipeline's final BA (8 cameras, ~700-1,000 landmarks, O = 8) and
    the solve shapes give at least one block an SM."""
    plan = dk.dense_eval_plan(K, L, O, N_SM)
    assert plan.blocks * plan.n_tiles >= N_SM


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------


def _hamming_case(rng, case):
    """(q [1, M1, 8], t [B, M2, 8], valid [B, M2], plan) as numpy / plan."""
    B, m1, m2 = {"tie_across_chunks": (1, 300, 1000), "chunk_without_valid": (1, 200, 1000),
                 "below_one_chunk": (1, 90, 40), "ragged_chunks": (1, 130, 997),
                 "batch_25_shared_queries": (25, 64, 300)}[case]
    t = rng.integers(0, 2**32, (B, m2, 8), dtype=np.uint32)
    q = t[0, rng.integers(0, m2, m1)].copy()
    q[::2] ^= rng.integers(0, 2**32, q[::2].shape, dtype=np.uint32) & np.uint32(0x00110011)
    valid = rng.random((B, m2)) > 0.1
    plan = th.hamming_plan(B, m1, m2, N_SM)
    if case == "tie_across_chunks":
        # a query's nearest row twinned across every chunk and quarter border
        for a, e in th.hamming_pieces(m2, plan)[1:]:
            if e > a:
                t[:, a] = t[:, a - 1]
                valid[:, a] = valid[:, a - 1] = True
                q[a % m1] = t[0, a]
    elif case == "chunk_without_valid":
        valid[:, plan.chunk:3 * plan.chunk] = False
    return q[None], t, valid, plan


HAMMING_CASES = ["tie_across_chunks", "chunk_without_valid", "below_one_chunk",
                 "ragged_chunks", "batch_25_shared_queries"]


@pytest.mark.parametrize("case", HAMMING_CASES)
def test_chunked_plain_a_matches_plain_and_pallas(rng, case):
    q, t, valid, plan = _hamming_case(rng, case)
    if case == "below_one_chunk":
        assert plan.n_chunks == 1 and t.shape[1] < th.HAM_CHUNK_MIN
    else:
        assert plan.n_chunks > 1
    if case == "ragged_chunks":
        assert t.shape[1] % plan.chunk
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    args = (as_t(q), as_t(t), torch.from_numpy(valid))
    got = th.hamming_top2_plain(*args, plan=plan)
    flat = th.hamming_top2_plain(*args)
    for g, f in zip(got, flat):
        assert torch.equal(g, f)
    for b in range(t.shape[0]):
        ref = hamming_top2_pallas(jnp.asarray(q[0]), jnp.asarray(t[b]),
                                  jnp.asarray(valid[b].astype(np.int32)), interpret=True)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))
    if case == "tie_across_chunks":  # ties resolved to the lower index, second == best
        a = th.hamming_pieces(t.shape[1], plan)[1][0]
        assert int(got[2][0, a % q.shape[1]]) == a - 1
        assert float(got[1][0, a % q.shape[1]]) == float(got[0][0, a % q.shape[1]]) == 0.0


def test_chunked_plain_a_without_any_valid_row(rng):
    q, t, valid, plan = _hamming_case(rng, "ragged_chunks")
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    best, second, idx = th.hamming_top2_plain(as_t(q), as_t(t),
                                              torch.zeros(valid.shape, dtype=torch.bool),
                                              plan=plan)
    assert (idx == -1).all() and torch.isinf(best).all() and torch.isinf(second).all()


@pytest.mark.parametrize("B,M1,M2", [(1, 1000, 1000), (25, 1000, 1000), (25, 64, 300),
                                     (1, 90, 40), (1, 130, 997), (3, 5, 5000), (1, 1, 1)])
def test_hamming_plan_invariants(B, M1, M2):
    plan = th.hamming_plan(B, M1, M2, N_SM)
    assert plan.chunk <= th.HAM_CHUNK_MAX
    assert plan.n_chunks * plan.chunk >= M2 > (plan.n_chunks - 1) * plan.chunk
    assert plan.blocks == plan.q_tiles * plan.n_chunks * B
    assert plan.q_tiles * plan.q_tile >= M1
    # the chunk's rows, their flags and the warps' top-2s in static shared memory
    assert 33 * th.HAM_CHUNK_MAX + 12 * th.HAM_WARPS * plan.q_tile <= 48 * 1024
    pieces = th.hamming_pieces(M2, plan)
    assert pieces[0][0] == 0 and pieces[-1][1] == M2
    assert all(e0 == a1 for (_, e0), (a1, _) in zip(pieces, pieces[1:]))
    if M1 >= 1000:  # the tracking call and the neighbour search fill the card
        assert plan.blocks >= N_SM
