"""Dense-BA kernels B (eval + assembly, optional back-substitution), C
(Schur-S with the folded damped U), K5 (C's unfolded per-shard partial) and
D (Schur prepare), with their plain PyTorch versions.

Port of `bundleadjustment_tpu/solvers/pallas_dense_eval.py`:

- `eval_assemble` / `eval_assemble_bs` replace `fused_eval_assemble` /
  `fused_eval_assemble_bs` (`csrc/dense_eval.cu`, with a back-substitution
  flag: warps of (landmark, slot) lanes and per-block slabs of the
  per-camera rows, laid out by the host plan `dense_eval_plan`);
- `schur_prepare_s` replaces `fused_schur_prepare_s(..., red27=...,
  cam_fixed=...)`, the single-device `fold_u=True` path, in float32
  (`csrc/schur_s.cu`: tiles of S in shared memory, laid out by the host
  plan `schur_s_plan`, whose blocking `_qqt_tiled` repeats on the CPU);
- `schur_qqt_partial` replaces `fused_schur_prepare_s(...)` without red27,
  the sharded engine's `fold_u=False` path (K5; kernel C's passes with
  nothing folded in, in C's (i, k) order);
- `schur_prepare` replaces `fused_schur_prepare` (K6; `csrc/
  schur_prepare.cu`: warps of (landmark, slot chunk) units and per-block
  slabs of red6, laid out by the host plan `schur_prepare_plan`), whose G
  feeds the outside `pf_index_add` / `qqt` product for large O.

Each wrapper dispatches on the device of its tensors: CPU tensors run the
plain version below it, CUDA tensors launch the kernel or raise. Inputs and
outputs use the reference's component-major layouts, so a test can hand the
same arrays to both packages.

Tolerances against the plain versions (and against the JAX kernels): the
kernels sum per-camera rows (B and D: per-warp tables, then per-block slabs
in a fixed order, laid out by the host plans `dense_eval_plan` and
`schur_prepare_plan`, whose blocking `plan=` repeats on the CPU) and S
entries (C, K5: shared-memory atomics within a block, then the chunks in a
fixed order) in another order than the plain versions (and, for C and K5,
in an order that changes from run to run); cost agrees to rtol 1e-5, the
block outputs to rtol 2e-4 / atol 2e-3 relative to each block's own
magnitude.
"""

from __future__ import annotations

import torch

from collections import namedtuple

from bundleadjustment_tpu_torch import kernels
from bundleadjustment_tpu_torch.solvers.chol import chol_solve, chol_solve_plain
from bundleadjustment_tpu_torch.solvers.schur import cholesky_solve_nan

N_RED = 27  # 21 upper-triangle U rows + 6 gradient rows per camera


# ---------------------------------------------------------------------------
# kernel B: eval + assembly (+ landmark back-substitution)
# ---------------------------------------------------------------------------


def _backsub_plain(cam_t, dc, Xt, W18_prev, vinv6, gp_prev, pt_valid):
    """Xt_new = Xt - V^-1 (g_p + sum_o W_o^T dc[cam_o]) for valid points."""
    dcg = dc[cam_t.long()]  # [O, L, 6]
    y = [torch.sum(sum(W18_prev[i * 3 + j] * dcg[..., i] for i in range(6)), 0)
         for j in range(3)]
    a = [gp_prev[j] + y[j] for j in range(3)]
    v = vinv6
    dp = [-(v[0] * a[0] + v[1] * a[1] + v[2] * a[2]),
          -(v[1] * a[0] + v[3] * a[1] + v[4] * a[2]),
          -(v[2] * a[0] + v[4] * a[1] + v[5] * a[2])]
    dp = torch.stack(dp)
    dp = torch.where(pt_valid[None, :], dp, torch.zeros_like(dp))
    return Xt + dp


# Kernel B's blocking (csrc/dense_eval.cu): warps a block at most, cameras a
# tile at most, warps an SM the plan aims at when it picks the lanes a
# landmark and the grid, the shared memory of an SM, and the finishing
# pass's strided partial sums an entry.
DENSE_WARPS = 4
DENSE_TILE_MAX = 128
DENSE_FILL_WARPS = 8
DENSE_SM_WARPS = 16
SMEM_SM_BYTES = 233_472  # 228 KB
DENSE_PARTS = 16

DensePlan = namedtuple("DensePlan", "lanes warps blocks rounds tile n_tiles units "
                       "smem_bytes scratch_bytes")


def dense_eval_smem_bytes(warps, tile):
    """Dynamic shared memory of a dense_eval_units block: a [tile][27] table
    and a cost a warp."""
    return 4 * (warps * tile * N_RED + warps)


def dense_eval_plan(K, L, O, n_sm):
    """Kernel B's launch plan, from the shapes and the SM count alone.

    - lanes S: lanes a landmark, a power of two, at most 32 and at most O
      rounded up to one; the smallest that gives ceil(L S / 32) warp units
      >= DENSE_FILL_WARPS warps an SM;
    - tile, n_tiles: the cameras in n_tiles = ceil(K / DENSE_TILE_MAX)
      tiles of T = ceil(K / n_tiles), each a grid row of its own;
    - warps: warps a block, DENSE_WARPS, halved while the units would give
      less than a block an SM;
    - blocks, rounds: the grid (blocks x n_tiles) holds at most
      DENSE_SM_WARPS warps an SM (and what shared memory allows), at least
      one block a tile; each warp takes `rounds` units at most, and blocks
      = ceil(units / (warps rounds)) a tile; 0 when L = 0;
    - scratch_bytes: the slabs, 27 T + 1 floats a block and tile."""
    S_max = min(32, 1 << max(0, O - 1).bit_length())
    S = 1
    while S < S_max and -(-L * S // 32) < DENSE_FILL_WARPS * n_sm:
        S *= 2
    units = -(-L // (32 // S))
    n_tiles = max(1, -(-K // DENSE_TILE_MAX))
    T = max(1, -(-K // n_tiles))
    warps = DENSE_WARPS
    while warps > 1 and units < warps * n_sm:
        warps //= 2
    smem = dense_eval_smem_bytes(warps, T)
    per_sm = max(1, min(DENSE_SM_WARPS // warps, SMEM_SM_BYTES // (smem + 1024)))
    per_tile = max(1, n_sm * per_sm // n_tiles)  # the tiles share the grid
    if L == 0:
        rounds = blocks = 0
    else:
        rounds = -(-units // (warps * per_tile))
        blocks = -(-units // (warps * rounds))
    return DensePlan(S, warps, blocks, rounds, T, n_tiles, units, smem,
                     4 * n_tiles * blocks * (N_RED * T + 1))


def _blocked_sum(slabs):
    """The finishing pass's order: DENSE_PARTS strided partial sums of the
    block slabs (block b in part b % DENSE_PARTS, in increasing b), then
    the parts in order."""
    parts = []
    for p in range(DENSE_PARTS):
        acc = torch.zeros_like(slabs[0])
        for x in slabs[p::DENSE_PARTS]:
            acc = acc + x
        parts.append(acc)
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    return total


def _red_cost_blocked(cam_t, n_cams, rho, r, Jc, plan):
    """red [K,27] and the cost summed in kernel B's blocking: per block of
    the plan (landmark l in unit l // (32 / S), unit u on warp u % (blocks
    warps), warp w in block w // warps), then over the blocks as the
    finishing pass sums them."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import camera_rows

    L = cam_t.shape[1]
    rows = camera_rows(r, Jc)
    unit = torch.arange(L, device=cam_t.device) // (32 // plan.lanes)
    block = (unit % max(1, plan.blocks * plan.warps)) // plan.warps
    reds, costs = [], []
    for b in range(plan.blocks):
        sel = torch.nonzero(block == b).flatten()
        reds.append(torch.zeros((n_cams, N_RED), dtype=rows.dtype,
                                device=rows.device).index_add_(
            0, cam_t[:, sel].reshape(-1).long(), rows[:, :, sel].reshape(N_RED, -1).T))
        costs.append(torch.sum(rho[:, sel]))
    if not reds:
        return (torch.zeros((n_cams, N_RED), dtype=rho.dtype, device=rho.device),
                torch.zeros((), dtype=rho.dtype, device=rho.device))
    return _blocked_sum(reds), _blocked_sum(costs)


def eval_assemble_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t,
                        Xt, robust=True, plan=None):
    """Plain version of kernel B without back-substitution.
    Returns (cost, red [K,27], Vu [6,L], g_p [3,L], W [6,3,O,L]). With a
    `plan` (dense_eval_plan) red and the cost are summed in the kernel's
    blocking: block by block, then the blocks in its finishing order."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import _assemble_cm, _eval_cm

    rho, r, Jc, Jp = _eval_cm(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t,
                              R, t, Xt, robust)
    red, Vu, g_p, W = _assemble_cm(cam_t, R.shape[0], r, Jc, Jp)
    if plan is None:
        return torch.sum(rho), red, Vu, g_p, W
    red, cost = _red_cost_blocked(cam_t, R.shape[0], rho, r, Jc, plan)
    return cost, red, Vu, g_p, W


def eval_assemble_bs_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R,
                           t, dc, Xt, W18_prev, vinv6, gp_prev, pt_valid,
                           robust=True, plan=None):
    """Plain version of kernel B with back-substitution: evaluates at the
    trial landmarks. Returns (cost, red, Vu, g_p, W, Xt_new [3,L]); `plan`
    as eval_assemble_plain."""
    Xt_new = _backsub_plain(cam_t, dc, Xt, W18_prev, vinv6, gp_prev, pt_valid)
    out = eval_assemble_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t,
                              R, t, Xt_new, robust, plan)
    return (*out, Xt_new)


def _launch_eval(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t, Xt,
                 robust, bs):
    O, L = cam_t.shape
    K = R.shape[0]
    dev = cam_t.device
    f32 = torch.float32
    kernels.check_cuda("K4", K4, f32, (4,))
    kernels.check_cuda("R", R, f32, (K, 3, 3))
    kernels.check_cuda("t", t, f32, (K, 3))
    kernels.check_cuda("cam_t", cam_t, torch.int32, (O, L))
    kernels.check_cuda("uv_t", uv_t, f32, (2, O, L))
    kernels.check_cuda("inv_sigma_t", inv_sigma_t, f32, (O, L))
    kernels.check_cuda("valid_t", valid_t, torch.bool, (O, L))
    kernels.check_cuda("fixed_t", fixed_t, torch.bool, (O, L))
    kernels.check_cuda("Xt", Xt, f32, (3, L))
    if bs is not None:
        dc, W18_prev, vinv6, gp_prev, pt_valid = bs
        kernels.check_cuda("dc", dc, f32, (K, 6))
        kernels.check_cuda("W18_prev", W18_prev, f32, (18, O, L))
        kernels.check_cuda("vinv6", vinv6, f32, (6, L))
        kernels.check_cuda("gp_prev", gp_prev, f32, (3, L))
        kernels.check_cuda("pt_valid", pt_valid, torch.bool, (L,))
        bs_ptrs = [x.data_ptr() for x in bs]
    else:
        bs_ptrs = [None] * 5
    plan = dense_eval_plan(K, L, O, torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
    slab = torch.empty((max(1, plan.scratch_bytes // 4),), dtype=f32, device=dev)
    red = torch.empty((K, N_RED), dtype=f32, device=dev)
    cost = torch.empty((), dtype=f32, device=dev)
    Vu = torch.empty((6, L), dtype=f32, device=dev)
    g_p = torch.empty((3, L), dtype=f32, device=dev)
    W = torch.empty((18, O, L), dtype=f32, device=dev)
    Xt_new = torch.empty((3, L), dtype=f32, device=dev) if bs is not None else None
    dc_ptr, w_ptr, v_ptr, gp_ptr, ptv_ptr = bs_ptrs
    code = kernels.lib("dense_eval").dense_eval_assemble(
        K4.data_ptr(), R.data_ptr(), t.data_ptr(), dc_ptr, cam_t.data_ptr(),
        uv_t.data_ptr(), inv_sigma_t.data_ptr(), valid_t.data_ptr(),
        fixed_t.data_ptr(), Xt.data_ptr(), w_ptr, v_ptr, gp_ptr, ptv_ptr,
        O, L, K, int(bool(robust)), int(bs is not None),
        plan.lanes.bit_length() - 1, plan.warps, plan.blocks, plan.tile,
        plan.n_tiles, slab.data_ptr(), red.data_ptr(), cost.data_ptr(),
        Vu.data_ptr(), g_p.data_ptr(), W.data_ptr(),
        None if Xt_new is None else Xt_new.data_ptr(), kernels.stream_of(cam_t))
    kernels.check(code, "dense_eval_assemble")
    name = "dense_eval_assemble" if bs is None else "dense_eval_assemble_bs"
    kernels.LAUNCHES[name] += 1
    out = (cost, red, Vu, g_p, W.reshape(6, 3, O, L))
    return out if bs is None else (*out, Xt_new)


def eval_assemble(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t, Xt,
                  robust=True):
    """Kernel B seed eval: (cost, red [K,27], Vu [6,L], g_p [3,L],
    W [6,3,O,L]) at (R, t, Xt)."""
    if not cam_t.is_cuda:
        return eval_assemble_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t,
                                   fixed_t, R, t, Xt, robust)
    return _launch_eval(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t,
                        Xt, robust, None)


def eval_assemble_bs(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t, dc,
                     Xt, W18_prev, vinv6, gp_prev, pt_valid, robust=True):
    """Kernel B with fused back-substitution: (cost, red, Vu, g_p, W, Xt_new)
    evaluated at the trial landmarks Xt_new."""
    if not cam_t.is_cuda:
        return eval_assemble_bs_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t,
                                      fixed_t, R, t, dc, Xt, W18_prev, vinv6,
                                      gp_prev, pt_valid, robust)
    return _launch_eval(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t,
                        Xt, robust, (dc, W18_prev, vinv6, gp_prev, pt_valid))


# ---------------------------------------------------------------------------
# kernel C: Schur prepare + S with the folded damped U
# ---------------------------------------------------------------------------


def point_inverse_plain(lam, Vu, g_p, pt_valid):
    """Damped V (identity for invalid points), its closed-form inverse as
    the six entries (00, 01, 02, 11, 12, 22) vinv6 [6, L], and zv = V^-1 g_p
    [3, L] (the reference's `_damp_blocks_cm` + `_sym3_inv_cm`)."""
    v00, v01, v02, v11, v12, v22 = (Vu[i] for i in range(6))
    v00 = v00 + lam * torch.clamp(v00, min=1e-6)
    v11 = v11 + lam * torch.clamp(v11, min=1e-6)
    v22 = v22 + lam * torch.clamp(v22, min=1e-6)
    one, zero = torch.ones_like(v00), torch.zeros_like(v00)
    v00, v11, v22 = (torch.where(pt_valid, v, one) for v in (v00, v11, v22))
    v01, v02, v12 = (torch.where(pt_valid, v, zero) for v in (v01, v02, v12))
    A = v11 * v22 - v12 * v12
    B = v02 * v12 - v01 * v22
    Cc = v01 * v12 - v02 * v11
    det = v00 * A + v01 * B + v02 * Cc
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20,
                                torch.full_like(det, 1e-20), det)
    D = v00 * v22 - v02 * v02
    E = v01 * v02 - v00 * v12
    F = v00 * v11 - v01 * v01
    i00, i01, i02 = A * inv_det, B * inv_det, Cc * inv_det
    i11, i12, i22 = D * inv_det, E * inv_det, F * inv_det
    vinv6 = torch.stack([i00, i01, i02, i11, i12, i22])
    gp = g_p
    zv = torch.stack([i00 * gp[0] + i01 * gp[1] + i02 * gp[2],
                      i01 * gp[0] + i11 * gp[1] + i12 * gp[2],
                      i02 * gp[0] + i12 * gp[1] + i22 * gp[2]])
    return vinv6, zv


def _point_prepare_plain(lam, Vu, g_p, pt_valid):
    """`point_inverse_plain` and chol(V^-1) as a nested list C[j][m]:
    (vinv6, C, zv)."""
    vinv6, zv = point_inverse_plain(lam, Vu, g_p, pt_valid)
    i00, i01, i02, i11, i12, i22 = vinv6
    zero = torch.zeros_like(i00)
    l00 = torch.sqrt(torch.clamp(i00, min=1e-20))
    l10 = i01 / l00
    l20 = i02 / l00
    l11 = torch.sqrt(torch.clamp(i11 - l10 * l10, min=1e-20))
    l21 = (i12 - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(i22 - l20 * l20 - l21 * l21, min=1e-20))
    C = [[l00, zero, zero], [l10, l11, zero], [l20, l21, l22]]
    return vinv6, C, zv


def damped_u(lam, red27, cam_fixed):
    """The LM-damped camera blocks U [K,6,6] and g_c [K,6] from the
    undamped rows red27 [K,27] (the reference's `_damp_U_cm`: identity
    blocks and zero gradients for fixed cameras)."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import sym6_index

    U = red27[:, sym6_index(red27.device)]  # [K, 6, 6]
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    dU = torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=1e-6)
    U = U + (lam * dU)[..., None] * eye6
    U = torch.where(cam_fixed[:, None, None], eye6, U)
    g_c = torch.where(cam_fixed[:, None], torch.zeros_like(red27[:, 21:]),
                      red27[:, 21:])
    return U, g_c


def damped_system(lam, red27, cam_fixed, S_qqt, red6):
    """The damped Schur system (S, b) of one LM iteration from the undamped
    camera rows red27 [K,27] and the point terms S_qqt = +Q Q^T [6K,6K] and
    red6 = sum W zv [6,K]: S = the block-diagonal damped U (identity blocks
    for fixed cameras, the reference's `_damp_U_cm`) + 1e-8 I - S_qqt and
    b = -(g_c - red6) (g_c zero for fixed cameras), all in (i, k) order (row
    i*K + k), so the solution comes back as [6, K]."""
    K = red27.shape[0]
    U, g_c = damped_u(lam, red27, cam_fixed)
    E = torch.zeros((6, K, 6, K), dtype=U.dtype, device=U.device)
    ar = torch.arange(K, device=U.device)
    E[:, ar, :, ar] = U
    S = (E.reshape(6 * K, 6 * K)
         + 1e-8 * torch.eye(6 * K, dtype=U.dtype, device=U.device) - S_qqt)
    return S, -(g_c.T - red6).reshape(-1)


def _wz_plain(W18, zv):
    """(W zv) [6, O, L]: each slot's terms of the camera rhs rows."""
    return torch.stack([sum(W18[i * 3 + j] * zv[j][None, :] for j in range(3))
                        for i in range(6)])


def _red6_plain(wz, cam_t, n_cams):
    # index_add_ along dim 0, then [6, K]: along dim 1 it is slower on the
    # card and sums in another order
    return torch.zeros((n_cams, 6), dtype=wz.dtype, device=wz.device).index_add_(
        0, cam_t.reshape(-1).long(), wz.reshape(6, -1).T).T.contiguous()


def schur_prepare_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams, plan=None):
    """Plain version of kernel D. Returns (G [18,O,L] = W chol(V^-1) in rows
    i*3 + m, zv [3,L], vinv6 [6,L], red6 [6,K] = sum W zv per camera). With
    a `plan` (schur_prepare_plan) red6 is summed in the kernel's blocking:
    block by block, then the blocks in its finishing order."""
    vinv6, C, zv = _point_prepare_plain(lam, Vu, g_p, pt_valid)
    G = torch.stack([sum(W18[i * 3 + j] * C[j][m][None, :] for j in range(3))
                     for i in range(6) for m in range(3)])  # [18, O, L]
    wz = _wz_plain(W18, zv)
    if plan is None:
        return G, zv, vinv6, _red6_plain(wz, cam_t, n_cams)
    return G, zv, vinv6, _red6_blocked(wz, cam_t, n_cams, plan)


# Kernel D's blocking (csrc/schur_prepare.cu): warps a block at most, warps
# an SM the plan aims at when it cuts a landmark's slots into chunks, warps
# an SM the grid holds at most, and cameras a tile at most.
PREP_WARPS = 8
PREP_FILL_WARPS = 16
PREP_SM_WARPS = 32
PREP_TILE_MAX = 512
PREP_SCRATCH_CAP = 16 << 20

PreparePlan = namedtuple("PreparePlan", "slots chunks warps blocks rounds tile "
                         "n_tiles units smem_bytes scratch_bytes")


def schur_prepare_smem_bytes(warps, tile):
    """Dynamic shared memory of a schur_prepare_units block: a [tile][6]
    table a warp."""
    return 4 * warps * tile * 6


def schur_prepare_plan(K, L, O, n_sm):
    """Kernel D's launch plan, from the shapes and the SM count alone.

    - tile, n_tiles: the cameras in n_tiles = ceil(K / PREP_TILE_MAX) tiles
      of T = ceil(K / n_tiles), each a grid row of its own that walks every
      unit;
    - units: 32 consecutive landmarks (a lane each) over a chunk of `slots`
      consecutive slots; a landmark's O slots are cut into `chunks` chunks,
      as few as give ceil(L / 32) * chunks * n_tiles >= PREP_FILL_WARPS
      warps an SM (at most O), so one landmark takes `chunks` warps a tile;
    - warps: warps a block, PREP_WARPS, halved while the units of every tile
      would give less than a block an SM;
    - blocks, rounds: the grid (blocks x n_tiles) holds at most
      PREP_SM_WARPS warps an SM (and what shared memory allows), at least
      one block a tile; each warp takes `rounds` units at most (unit u on
      warp u % (blocks warps)), and blocks = ceil(units / (warps rounds)) a
      tile, and no more blocks than PREP_SCRATCH_CAP holds slabs of (at
      least one); 0 when L = 0;
    - scratch_bytes: the slabs, 6 T floats a block and tile."""
    groups = -(-L // 32)
    n_tiles = max(1, -(-K // PREP_TILE_MAX))
    T = max(1, -(-K // n_tiles))
    split = max(1, min(O, -(-PREP_FILL_WARPS * n_sm // max(1, groups * n_tiles))))
    slots = max(1, -(-O // split))
    chunks = max(1, -(-O // slots))
    units = groups * chunks
    warps = PREP_WARPS
    while warps > 1 and units * n_tiles < warps * n_sm:
        warps //= 2
    smem = schur_prepare_smem_bytes(warps, T)
    per_sm = max(1, min(PREP_SM_WARPS // warps, SMEM_SM_BYTES // (smem + 1024)))
    per_tile = max(1, n_sm * per_sm // n_tiles)  # the tiles share the grid
    per_tile = min(per_tile, max(1, PREP_SCRATCH_CAP // (24 * n_tiles * T)))
    if L == 0:
        rounds = blocks = 0
    else:
        rounds = -(-units // (warps * per_tile))
        blocks = -(-units // (warps * rounds))
    return PreparePlan(slots, chunks, warps, blocks, rounds, T, n_tiles, units,
                       smem, 4 * n_tiles * blocks * 6 * T)


def _red6_blocked(wz, cam_t, n_cams, plan):
    """red6 [6,K] summed in kernel D's blocking: per block of the plan (slot
    o of landmark l in unit (l // 32) chunks + o // slots, unit u on warp u %
    (blocks warps), warp w in block w // warps), then over the blocks as the
    finishing pass sums them."""
    O, L = cam_t.shape
    if plan.blocks == 0:
        return torch.zeros((6, n_cams), dtype=wz.dtype, device=wz.device)
    o = torch.arange(O, device=cam_t.device)[:, None]
    l = torch.arange(L, device=cam_t.device)[None, :]
    unit = (l // 32) * plan.chunks + o // plan.slots
    block = (unit % (plan.blocks * plan.warps)) // plan.warps  # [O, L]
    reds = []
    for b in range(plan.blocks):
        sel = block == b
        reds.append(_red6_plain(wz[:, sel], cam_t[sel], n_cams))
    return _blocked_sum(reds)


def pf_index_add(G, cam_t, n_cams):
    """Pf [L*K, 18]: Pf[l*K + k] = sum_o [cam_o == k] G[:, o, l] (one
    index_add_; the reference's one-hot Pf contraction)."""
    L = cam_t.shape[1]
    slot = (torch.arange(L, device=cam_t.device)[None, :] * n_cams
            + cam_t.long()).reshape(-1)
    return torch.zeros((L * n_cams, 18), dtype=G.dtype,
                       device=G.device).index_add_(0, slot, G.reshape(18, -1).T)


def qqt_factor(Pf, n_cams):
    """Q [6K, 3L] from Pf [L*K, 18] (columns i*3 + m), rows in (i, k) order
    (row i*K + k)."""
    K = n_cams
    L = Pf.shape[0] // K
    return Pf.reshape(L, K, 6, 3).permute(2, 1, 0, 3).reshape(6 * K, 3 * L)


def qqt(Pf, n_cams):
    """Q Q^T [6K, 6K] from Pf [L*K, 18]; a plain matrix product."""
    Q = qqt_factor(Pf, n_cams)
    return Q @ Q.T


# Kernel C / K5's blocking (csrc/schur_s.cu): warps a block, landmarks a
# scan unit (landmark l is in chunk (l // SCHUR_UNIT) % chunks), floats a
# staged slot, staged slots a batch at least; the shared memory a block may
# take on an H100, and the bound on the scratch slabs.
SCHUR_WARPS = 16
SCHUR_UNIT = 32
SCHUR_GS = 25
SCHUR_SLOTS = 384
SMEM_MAX_BYTES = 232_448  # 227 KB
SCHUR_SCRATCH_CAP = 64 << 20

SchurPlan = namedtuple("SchurPlan", "tile n_tiles pairs chunks slots smem_bytes "
                       "scratch_bytes")


def schur_tile_bytes(T, slots=SCHUR_SLOTS, O=32):
    """Dynamic shared memory of one schur_tiles block at tile size T with
    `slots` staged observation slots and O slots a landmark (csrc/
    schur_s.cu: tile_smem_bytes)."""
    n6 = 6 * T
    mw = -(-O // 32)
    return (4 * (n6 * (n6 + 2) + SCHUR_WARPS * n6 + slots * SCHUR_GS
                 + SCHUR_WARPS * SCHUR_UNIT * (2 + 2 * mw) + SCHUR_WARPS + 1)
            + 5 * slots)


def schur_tile_max(slots=SCHUR_SLOTS, O=32):
    """The largest tile whose block fits in SMEM_MAX_BYTES (0: none)."""
    return max((T for T in range(1, 6 * SCHUR_WARPS + 1)
                if schur_tile_bytes(T, slots, O) <= SMEM_MAX_BYTES), default=0)



def schur_s_plan(K, L, O, n_sm, tile=None):
    """Kernel C / K5's launch plan, from the shapes and the SM count alone.

    - slots: staged observation slots a batch: SCHUR_SLOTS or one
      landmark's O if more, then as many more as fit beside the tile, up to
      64 landmarks' worth;
    - tile T: the cameras are cut into n_tiles = ceil(K / T_max) tiles of
      T = ceil(K / n_tiles) (`tile` overrides T), so the 6T x 6T float tile
      and the staged slots sit in a block's shared memory: one tile up to
      K = schur_tile_max() (35 for O <= 32);
    - pairs: the tile pairs (I, J), I <= J: the diagonal pairs first, then
      the others in row-major order;
    - chunks: the landmark chunks of every pair, one block each. One chunk
      once the pairs alone hold half the SMs; else two waves at most
      (2 n_sm // pairs), at most one chunk a unit of SCHUR_UNIT landmarks,
      and at most what SCHUR_SCRATCH_CAP holds (at least 1); 0 when L = 0;
    - scratch_bytes: the chunk slabs of every pair and the rhs rows of every
      tile, at most max(SCHUR_SCRATCH_CAP, one chunk's slabs)."""
    slots = max(SCHUR_SLOTS, O)
    t_max = schur_tile_max(slots, O)
    if t_max == 0:
        raise ValueError(f"O = {O}: a landmark's slots do not fit in shared memory")
    T = tile or max(1, -(-K // max(1, -(-K // t_max))))
    # then as many slots as fit beside the tile, up to 64 landmarks' worth
    while (slots + 32 <= max(SCHUR_SLOTS, 64 * O)
           and schur_tile_bytes(T, slots + 32, O) <= SMEM_MAX_BYTES):
        slots += 32
    nt = max(1, -(-K // T))
    pairs = [(i, i) for i in range(nt)] + [(i, j) for i in range(nt)
                                           for j in range(i + 1, nt)]
    per_chunk = 4 * (len(pairs) * 36 * T * T + nt * 6 * T)
    if L == 0:
        chunks = 0
    else:
        chunks = max(1, 2 * n_sm // len(pairs)) if len(pairs) < n_sm // 2 else 1
        chunks = min(chunks, -(-L // SCHUR_UNIT))
        chunks = max(1, min(chunks, SCHUR_SCRATCH_CAP // per_chunk))
    return SchurPlan(T, nt, pairs, chunks, slots, schur_tile_bytes(T, slots, O),
                     chunks * per_chunk)


def _qqt_tiled(G, wz, cam_t, n_cams, plan):
    """S_qqt [6K,6K] and red6 [6,K] summed in the kernel's blocking: for
    each tile pair, its chunks' partials in chunk order, mirrored into the
    lower pairs; red6 chunk by chunk."""
    K = n_cams
    L = cam_t.shape[1]
    T, chunks = plan.tile, plan.chunks
    S = torch.zeros((6 * K, 6 * K), dtype=G.dtype, device=G.device)
    red6 = torch.zeros((6, K), dtype=G.dtype, device=G.device)
    chunk_of = (torch.arange(L, device=cam_t.device) // SCHUR_UNIT) % max(chunks, 1)
    rows = [torch.tensor([i * K + k for i in range(6)
                          for k in range(I * T, min(K, (I + 1) * T))],
                         dtype=torch.long, device=G.device)
            for I in range(plan.n_tiles)]
    Qs, reds = [], []
    for c in range(chunks):
        sel = torch.nonzero(chunk_of == c).flatten()
        Qs.append(qqt_factor(pf_index_add(G[:, :, sel], cam_t[:, sel], K), K))
        reds.append(torch.zeros((K, 6), dtype=wz.dtype, device=wz.device).index_add_(
            0, cam_t[:, sel].reshape(-1).long(), wz[:, :, sel].reshape(6, -1).T).T)
    for I, J in plan.pairs:
        rI, rJ = rows[I], rows[J]
        acc = torch.zeros((len(rI), len(rJ)), dtype=G.dtype, device=G.device)
        for Q in Qs:
            acc = acc + Q[rI] @ Q[rJ].T
        S[rI[:, None], rJ[None, :]] = acc
        if I != J:
            S[rJ[:, None], rI[None, :]] = acc.T
    for r in reds:
        red6 = red6 + r
    return S, red6


def schur_qqt_partial_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams,
                            plan=None):
    """Plain version of K5. Returns (S_qqt [6K,6K] = +Q Q^T, zv [3,L],
    vinv6 [6,L], red6 [6,K]), in (i, k) order. With a `plan`
    (schur_s_plan) the sums follow the kernel's blocking: tile pair by tile
    pair and chunk by chunk."""
    G, zv, vinv6, red6 = schur_prepare_plain(lam, Vu, g_p, pt_valid, W18,
                                             cam_t, n_cams)
    if plan is not None:
        S_qqt, red6 = _qqt_tiled(G, _wz_plain(W18, zv), cam_t, n_cams, plan)
        return S_qqt, zv, vinv6, red6
    return qqt(pf_index_add(G, cam_t, n_cams), n_cams), zv, vinv6, red6


def schur_prepare_s_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams, red27,
                          cam_fixed, plan=None):
    """Plain version of kernel C. Returns (S [6K,6K], zv [3,L], vinv6 [6,L],
    b [6K]), S = U_damped_embed + 1e-8 I - Q Q^T and b = -(g_c - sum W zv),
    both in (i, k) order (row i*K + k); `plan` as schur_qqt_partial_plain."""
    S_qqt, zv, vinv6, red6 = schur_qqt_partial_plain(lam, Vu, g_p, pt_valid,
                                                     W18, cam_t, n_cams, plan)
    S, b = damped_system(lam, red27, cam_fixed, S_qqt, red6)
    return S, zv, vinv6, b


def _check_prepare_args(lam, Vu, g_p, pt_valid, W18, cam_t):
    O, L = cam_t.shape
    f32 = torch.float32
    kernels.check_cuda("lam", lam, f32, ())
    kernels.check_cuda("Vu", Vu, f32, (6, L))
    kernels.check_cuda("g_p", g_p, f32, (3, L))
    kernels.check_cuda("pt_valid", pt_valid, torch.bool, (L,))
    kernels.check_cuda("W18", W18, f32, (18, O, L))
    kernels.check_cuda("cam_t", cam_t, torch.int32, (O, L))
    return O, L


def _schur_buffers(cam_t, K, L, O):
    """Kernel C / K5's plan for this card, its scratch slabs (Sp, Rp) and
    outputs (S [6K,6K], rhs [6K], zv [3,L], vinv6 [6,L]), all torch.empty."""
    dev = cam_t.device
    plan = schur_s_plan(K, L, O, torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    f32 = torch.float32
    n6 = 6 * plan.tile
    Sp = torch.empty((len(plan.pairs) * plan.chunks * n6 * n6,), dtype=f32, device=dev)
    Rp = torch.empty((plan.n_tiles * plan.chunks * n6,), dtype=f32, device=dev)
    return (plan, Sp, Rp, torch.empty((6 * K, 6 * K), dtype=f32, device=dev),
            torch.empty((6 * K,), dtype=f32, device=dev),
            torch.empty((3, L), dtype=f32, device=dev),
            torch.empty((6, L), dtype=f32, device=dev))


def schur_prepare_s(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams, red27,
                    cam_fixed):
    """Kernel C: the damped Schur system of one LM iteration.

    lam: 0-d float32 tensor (stays on the device); Vu [6,L]; g_p [3,L];
    pt_valid [L] bool; W18 [18,O,L]; cam_t [O,L] int32; red27 [K,27];
    cam_fixed [K] bool. Returns (S, zv, vinv6, b) as the plain version.
    """
    if not cam_t.is_cuda:
        return schur_prepare_s_plain(lam, Vu, g_p, pt_valid, W18, cam_t,
                                     n_cams, red27, cam_fixed)
    O, L = _check_prepare_args(lam, Vu, g_p, pt_valid, W18, cam_t)
    K = n_cams
    kernels.check_cuda("red27", red27, torch.float32, (K, N_RED))
    kernels.check_cuda("cam_fixed", cam_fixed, torch.bool, (K,))
    plan, Sp, Rp, S, b, zv, vinv6 = _schur_buffers(cam_t, K, L, O)
    code = kernels.lib("schur_s").schur_prepare_s(
        lam.data_ptr(), red27.data_ptr(), cam_fixed.data_ptr(), Vu.data_ptr(),
        g_p.data_ptr(), pt_valid.data_ptr(), W18.data_ptr(), cam_t.data_ptr(),
        O, L, K, plan.tile, plan.chunks, plan.slots, Sp.data_ptr(),
        Rp.data_ptr(), S.data_ptr(), b.data_ptr(), zv.data_ptr(),
        vinv6.data_ptr(), kernels.stream_of(cam_t))
    kernels.check(code, "schur_prepare_s")
    kernels.LAUNCHES["schur_prepare_s"] += 1
    return S, zv, vinv6, b


def schur_qqt_partial(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams):
    """K5: the per-shard Schur partial of the sharded engine.

    Same inputs as kernel D. Returns (S_qqt [6K,6K] = +Q Q^T, zv [3,L],
    vinv6 [6,L], red6 [6,K] = sum W zv), S_qqt and red6 in (i, k) order as
    kernel C's: no U, no g_c, no jitter (the caller all-reduces them and
    folds in the replicated damped U, `damped_system`)."""
    if not cam_t.is_cuda:
        return schur_qqt_partial_plain(lam, Vu, g_p, pt_valid, W18, cam_t,
                                       n_cams)
    O, L = _check_prepare_args(lam, Vu, g_p, pt_valid, W18, cam_t)
    K = n_cams
    plan, Sp, Rp, S, red6, zv, vinv6 = _schur_buffers(cam_t, K, L, O)
    code = kernels.lib("schur_s").schur_qqt_partial(
        lam.data_ptr(), Vu.data_ptr(), g_p.data_ptr(), pt_valid.data_ptr(),
        W18.data_ptr(), cam_t.data_ptr(), O, L, K, plan.tile, plan.chunks,
        plan.slots, Sp.data_ptr(), Rp.data_ptr(), S.data_ptr(),
        red6.data_ptr(), zv.data_ptr(), vinv6.data_ptr(),
        kernels.stream_of(cam_t))
    kernels.check(code, "schur_qqt_partial")
    kernels.LAUNCHES["schur_qqt_partial"] += 1
    return S, zv, vinv6, red6.reshape(6, K)


def schur_prepare(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams):
    """Kernel D: the Schur prepare of one LM iteration, G to memory.

    lam: 0-d float32 tensor; Vu [6,L]; g_p [3,L]; pt_valid [L] bool;
    W18 [18,O,L]; cam_t [O,L] int32. Returns (G [18,O,L], zv [3,L],
    vinv6 [6,L], red6 [6,K]) as the plain version."""
    if not cam_t.is_cuda:
        return schur_prepare_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams)
    O, L = _check_prepare_args(lam, Vu, g_p, pt_valid, W18, cam_t)
    K = n_cams
    dev = cam_t.device
    f32 = torch.float32
    plan = schur_prepare_plan(K, L, O, torch.cuda.get_device_properties(dev)
                              .multi_processor_count)
    slab = torch.empty((max(1, plan.scratch_bytes // 4),), dtype=f32, device=dev)
    G = torch.empty((18, O, L), dtype=f32, device=dev)
    zv = torch.empty((3, L), dtype=f32, device=dev)
    vinv6 = torch.empty((6, L), dtype=f32, device=dev)
    red6 = torch.empty((6, K), dtype=f32, device=dev)
    code = kernels.lib("schur_prepare").schur_prepare(
        lam.data_ptr(), Vu.data_ptr(), g_p.data_ptr(), pt_valid.data_ptr(),
        W18.data_ptr(), cam_t.data_ptr(), O, L, K, plan.slots, plan.chunks,
        plan.warps, plan.blocks, plan.tile, plan.n_tiles, slab.data_ptr(),
        G.data_ptr(), zv.data_ptr(), vinv6.data_ptr(), red6.data_ptr(),
        kernels.stream_of(cam_t))
    kernels.check(code, "schur_prepare")
    kernels.LAUNCHES["schur_prepare"] += 1
    return G, zv, vinv6, red6


# The per-iteration functions of the dense LM solve. `dense_ba_solve` takes
# the dispatching wrappers by default; a comparison on the card can pass
# PLAIN_OPS to run the same solve through the plain versions. The camera
# system S x = b goes to the library call (`cholesky_solve_nan`) in both, as
# the reference's `solve_fused` keeps XLA's Cholesky; the *_CHOL tables
# differ in that field only and solve it with kernel E (`chol.chol_solve`)
# or its plain version.
DenseOps = namedtuple("DenseOps", "eval_assemble eval_assemble_bs "
                      "schur_prepare_s schur_qqt_partial schur_prepare "
                      "chol_solve")
KERNEL_OPS = DenseOps(eval_assemble, eval_assemble_bs, schur_prepare_s,
                      schur_qqt_partial, schur_prepare, cholesky_solve_nan)
PLAIN_OPS = DenseOps(eval_assemble_plain, eval_assemble_bs_plain,
                     schur_prepare_s_plain, schur_qqt_partial_plain,
                     schur_prepare_plain, cholesky_solve_nan)
KERNEL_OPS_CHOL = KERNEL_OPS._replace(chol_solve=chol_solve)
PLAIN_OPS_CHOL = PLAIN_OPS._replace(chol_solve=chol_solve_plain)
