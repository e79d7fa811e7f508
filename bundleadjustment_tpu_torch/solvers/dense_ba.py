"""Dense landmark-major bundle adjustment (exact Schur, Cholesky).

Port of `bundleadjustment_tpu/solvers/dense_ba.py`. Observations are
grouped by landmark into `[L, O]` slots (validity-masked) and carried in the
reference's component-major `[..., O, L]` layout (`_CM`), so the kernels and
their plain versions take exactly the arrays the Pallas kernels take.

One LM iteration (`dense_ba_solve`):

1. the Schur step, by the reference's three routes (`solve_fused`):
   (a) one device, O <= 64: kernel C (`schur_prepare_s`): damped point
   blocks, V^-1, chol(V^-1), the camera rhs and the full damped Schur
   matrix S in (i, k) row order;
   (b) sharded (`reduce` given), O <= 64: K5 (`schur_qqt_partial`), the
   +Q Q^T partial and rhs rows, all-reduced, then the damped U folded in
   (`dense_kernels.damped_system`, (i, k) order as (a); the reference
   folds it in (k, i) order, which changes nothing but the rounding);
   (c) O > 64, either mode: kernel D (`schur_prepare`), Pf by `index_add_`
   and Q Q^T by a plain matrix product, all-reduced, then U as in (b);
2. the camera system S x = b: `ops.chol_solve`, by default `cholesky_ex` +
   `cholesky_solve` (outside any kernel, as the JAX package solves it with
   XLA; a non-PD S gives a NaN step), or kernel E (`solvers/chol.py`) with
   `dense_kernels.KERNEL_OPS_CHOL`;
3. kernel B with back-substitution (`eval_assemble_bs`): the trial landmarks
   Xt - V^-1 (g_p + W^T dc) and the eval + block assembly at the trial point;
4. accept / reject with `torch.where`: no host sync inside the loop.

The LM semantics are the reference's: a fixed `max_iters`, state frozen once
`done` is set, lambda / 3 on accept and lambda * nu on reject. Kernel B seeds
the loop without the back-substitution. On CPU tensors both kernels run
their plain PyTorch versions (`solvers/dense_kernels.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat, rotmat_to_aa
from bundleadjustment_tpu_torch.solvers.lm import (
    CHEIRALITY_PENALTY,
    LMConfig,
    check_solver,
)
from bundleadjustment_tpu_torch.solvers.residuals import HUBER_DELTA


@dataclass
class DenseBAProblem:
    K4: torch.Tensor  # [4]
    cam_idx: torch.Tensor  # [L, O] int32
    uv: torch.Tensor  # [L, O, 2]
    sigma2: torch.Tensor  # [L, O]
    valid: torch.Tensor  # [L, O] bool
    cam_fixed: torch.Tensor  # [K] bool
    pt_valid: torch.Tensor  # [L] bool


def densify_numpy(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
                  n_points, max_obs=16):
    """Host-side regrouping of a flat observation table by landmark.

    Observations beyond `max_obs` per landmark are dropped; the O axis is
    trimmed to the slots actually used (rounded up to a multiple of 8).
    Returns (dict of numpy arrays with DenseBAProblem's fields, n_dropped).
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    sigma2 = np.asarray(sigma2)
    valid = np.asarray(valid)
    L = n_points
    vi = np.nonzero(valid)[0]
    p = pt_idx[vi]
    order = np.argsort(p, kind="stable")
    vi = vi[order]
    p = p[order]
    if len(p):
        starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1]])
        sizes = np.diff(np.r_[starts, len(p)])
        ranks = np.arange(len(p)) - np.repeat(starts, sizes)
    else:
        ranks = np.zeros(0, np.int64)
    keep = ranks < max_obs
    dropped = int(len(p) - keep.sum())
    used = int(ranks[keep].max()) + 1 if keep.any() else 1
    max_obs = min(max_obs, max(8, ((used + 7) // 8) * 8))
    ci = np.zeros((L, max_obs), np.int32)
    uvd = np.zeros((L, max_obs, 2), np.float32)
    sg = np.ones((L, max_obs), np.float32)
    vd = np.zeros((L, max_obs), bool)
    lk, sk, nk = p[keep], ranks[keep], vi[keep]
    ci[lk, sk] = cam_idx[nk]
    uvd[lk, sk] = uv[nk]
    sg[lk, sk] = sigma2[nk]
    vd[lk, sk] = True
    slots = np.bincount(lk, minlength=L)
    arrays = dict(K4=np.asarray(K4, np.float32), cam_idx=ci, uv=uvd, sigma2=sg,
                  valid=vd, cam_fixed=np.asarray(cam_fixed, bool),
                  pt_valid=slots > 0)
    return arrays, dropped


def to_problem(arrays, device):
    """numpy dict (from `densify_numpy`) -> DenseBAProblem on `device`."""
    device = resolve_device(device)
    return DenseBAProblem(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                             for k, v in arrays.items()})


def densify_problem(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
                    n_points, max_obs=16, device="cuda"):
    """`densify_numpy` returning tensors: (DenseBAProblem, n_dropped)."""
    arrays, dropped = densify_numpy(K4, cam_idx, pt_idx, uv, sigma2, valid,
                                    cam_fixed, n_points, max_obs)
    return to_problem(arrays, device), dropped


def densify_problem_auto(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
                         n_points, max_obs=16, max_obs_cap=512, device="cuda"):
    """`densify_problem` with max_obs doubled (up to max_obs_cap) until no
    observation is dropped. Returns (DenseBAProblem, n_dropped, O)."""
    while True:
        arrays, dropped = densify_numpy(K4, cam_idx, pt_idx, uv, sigma2, valid,
                                        cam_fixed, n_points, max_obs)
        if dropped == 0 or max_obs >= max_obs_cap:
            return (to_problem(arrays, device), dropped,
                    int(arrays["cam_idx"].shape[1]))
        max_obs *= 2


# ---------------------------------------------------------------------------
# component-major layout and the plain eval / assembly math
# ---------------------------------------------------------------------------


@dataclass
class _CM:
    """The dense problem in component-major [.., O, L] layout."""

    K4: torch.Tensor  # [4]
    cam_t: torch.Tensor  # [O, L] int32
    uv_t: torch.Tensor  # [2, O, L]
    inv_sigma_t: torch.Tensor  # [O, L]
    valid_t: torch.Tensor  # [O, L] bool
    fixed_t: torch.Tensor  # [O, L] bool (the observation's camera is fixed)
    cam_fixed: torch.Tensor  # [K] bool
    pt_valid: torch.Tensor  # [L] bool


def _to_cm(prob: DenseBAProblem) -> _CM:
    sigma2 = torch.clamp(prob.sigma2, min=1e-12)
    return _CM(
        K4=prob.K4.contiguous(),
        cam_t=prob.cam_idx.T.contiguous(),
        uv_t=prob.uv.permute(2, 1, 0).contiguous(),
        inv_sigma_t=(1.0 / torch.sqrt(sigma2)).T.contiguous(),
        valid_t=prob.valid.T.contiguous(),
        fixed_t=prob.cam_fixed[prob.cam_idx.long()].T.contiguous(),
        cam_fixed=prob.cam_fixed.contiguous(),
        pt_valid=prob.pt_valid.contiguous(),
    )


TRIU6 = [(i, j) for i in range(6) for j in range(i, 6)]  # 21 entries
TRIU3 = [(i, j) for i in range(3) for j in range(i, 3)]  # 6 entries
SYM6_IDX = np.zeros((6, 6), np.int64)
for _n, (_i, _j) in enumerate(TRIU6):
    SYM6_IDX[_i, _j] = SYM6_IDX[_j, _i] = _n


def _eval_cm(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t, Xt, robust):
    """Projection, whitened residuals, Huber weights, cheirality penalty and
    analytic Jacobians for every observation slot (the math of the
    reference's `_eval_tile_body`). Returns (rho [O,L], r [2][O,L],
    Jc [2][6][O,L], Jp [2][3][O,L]) as nested lists of planes."""
    cam = cam_t.long()
    g = torch.cat([R.reshape(-1, 9), t], 1)[cam]  # [O, L, 12]
    g = [g[..., c] for c in range(12)]
    X0, X1, X2 = Xt[0][None, :], Xt[1][None, :], Xt[2][None, :]
    RX = [g[3 * i] * X0 + g[3 * i + 1] * X1 + g[3 * i + 2] * X2 for i in range(3)]
    x0 = RX[0] + g[9]
    x1 = RX[1] + g[10]
    z = RX[2] + g[11]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    inv_z = 1.0 / zs
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    isig = inv_sigma_t
    r0 = (fx * x0 * inv_z + cx - uv_t[0]) * isig
    r1 = (fy * x1 * inv_z + cy - uv_t[1]) * isig
    r2 = r0 * r0 + r1 * r1
    if robust:
        nrm2 = torch.sqrt(torch.clamp(r2, min=1e-20))
        rho = torch.where(nrm2 <= HUBER_DELTA, 0.5 * r2,
                          HUBER_DELTA * (nrm2 - 0.5 * HUBER_DELTA))
    else:
        rho = 0.5 * r2
    rho = torch.where(z > 1e-6, rho, torch.full_like(rho, CHEIRALITY_PENALTY))
    mval = valid_t.to(rho.dtype)
    rho = rho * mval

    a = fx * inv_z * isig
    b = fy * inv_z * isig
    zero = torch.zeros_like(a)
    duv = [[a, zero, -a * x0 * inv_z], [zero, b, -b * x1 * inv_z]]
    ns = [[zero, RX[2], -RX[1]], [-RX[2], zero, RX[0]], [RX[1], -RX[0], zero]]
    J_phi = [[sum(duv[al][m] * ns[m][j] for m in range(3)) for j in range(3)]
             for al in range(2)]
    Jp = [[sum(duv[al][m] * g[3 * m + j] for m in range(3)) for j in range(3)]
          for al in range(2)]
    Jc = [J_phi[0] + duv[0], J_phi[1] + duv[1]]

    mask = mval * (z > 1e-6).to(rho.dtype)
    w = mask
    if robust:
        nrm = torch.sqrt(torch.clamp(r2, min=1e-24))
        w = w * torch.where(nrm <= HUBER_DELTA, torch.ones_like(nrm),
                            HUBER_DELTA / nrm)
    sw = torch.sqrt(w)
    r = [r0 * sw * mask, r1 * sw * mask]
    sw_free = sw * (~fixed_t).to(sw.dtype)
    Jc = [[Jc[al][i] * sw_free for i in range(6)] for al in range(2)]
    Jp = [[Jp[al][j] * sw for j in range(3)] for al in range(2)]
    return rho, r, Jc, Jp


def camera_rows(r, Jc):
    """Each slot's 27 camera rows [27, O, L]: the 21 upper-triangle entries
    of Jc^T Jc and the 6 of Jc^T r."""
    rows = [Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j] for i, j in TRIU6]
    rows += [Jc[0][i] * r[0] + Jc[1][i] * r[1] for i in range(6)]
    return torch.stack(rows)


def _assemble_cm(cam_t, n_cams, r, Jc, Jp):
    """Undamped block reductions: red [K,27] (21 upper U rows + 6 g_c rows,
    summed per camera), Vu [6,L], g_p [3,L], W [6,3,O,L]."""
    stacked = camera_rows(r, Jc).reshape(27, -1)
    red = torch.zeros((n_cams, 27), dtype=stacked.dtype,
                      device=stacked.device).index_add_(
        0, cam_t.reshape(-1).long(), stacked.T)
    Vu = torch.stack([torch.sum(Jp[0][i] * Jp[0][j] + Jp[1][i] * Jp[1][j], 0)
                      for i, j in TRIU3])
    g_p = torch.stack([torch.sum(Jp[0][i] * r[0] + Jp[1][i] * r[1], 0)
                       for i in range(3)])
    W = torch.stack([torch.stack([Jc[0][i] * Jp[0][j] + Jc[1][i] * Jp[1][j]
                                  for j in range(3)]) for i in range(6)])
    return red, Vu, g_p, W


# ---------------------------------------------------------------------------
# the LM solve
# ---------------------------------------------------------------------------


# The largest O that the Schur-S kernel routes (C single-device, K5
# sharded) take; above it the reference's route is its prepare kernel (K6,
# here kernel D) plus a plain Pf / Q Q^T product. The reference's gate
# (`pallas_dense_eval.py:773-779`) also rejects K > 128 and shapes whose S
# and landmark tile overflow VMEM: that is TPU mechanics (S must fit the
# core's VMEM), and the port's kernel C has no K limit (S lives in device
# memory and L2), so only the O term is kept.
S_KERNEL_MAX_O = 64


def schur_route(O):
    """"s" (the Schur-S kernel: C, or K5 when sharded) or "prepare" (kernel
    D + Pf + Q Q^T) for a problem with O observation slots per landmark."""
    return "s" if O <= S_KERNEL_MAX_O else "prepare"


def _solve_unfolded(dk, route, lam, Vu, g_p, W18, cm, red, reduce):
    """Branches (b) and (c) of the reference's `solve_fused`: the +Q Q^T
    partial and red6 (K5, or kernel D + Pf + Q Q^T), all-reduced, then the
    damped U and 1e-8 I folded in and the Cholesky solve, in (i, k) order
    as route (a). Returns (dc [K, 6], vinv6)."""
    from bundleadjustment_tpu_torch.solvers.dense_kernels import (
        damped_system,
        pf_index_add,
        qqt,
    )

    K = cm.cam_fixed.shape[0]
    if route == "s":
        S_qqt, _zv, vinv6, red6 = dk.schur_qqt_partial(
            lam, Vu, g_p, cm.pt_valid, W18, cm.cam_t, K)
    else:
        G, _zv, vinv6, red6 = dk.schur_prepare(lam, Vu, g_p, cm.pt_valid, W18,
                                               cm.cam_t, K)
        S_qqt = qqt(pf_index_add(G, cm.cam_t, K), K)
    S, b = damped_system(lam, red, cm.cam_fixed, reduce(S_qqt), reduce(red6))
    return dk.chol_solve(S, b).reshape(6, K).T, vinv6


def dense_ba_solve(prob: DenseBAProblem, cam_rt6, points, config=LMConfig(),
                   ops=None, reduce=None):
    """LM / exact-Schur solve in the dense landmark-major layout.

    cam_rt6 [K, 6], points [L, 3] on the problem's device. Returns
    (cam_rt6', points', info) with info's values as device tensors. `ops`
    (default `dense_kernels.KERNEL_OPS`, which dispatch on the device) picks
    the implementations of the kernels and of the camera-system solve.

    `reduce` is the cross-shard reduction hook (the reference's `psum`): a
    function that sums a tensor over every landmark shard and returns it.
    None means one device: the Schur step is kernel C with the folded U
    (O <= 64). Given (the sharded engine, even with one shard), the Schur
    step all-reduces the unfolded partial: K5 for O <= 64. Above O = 64
    both take kernel D + Pf + Q Q^T (`schur_route`). The cost and the
    per-camera rows are reduced after every eval.
    """
    from bundleadjustment_tpu_torch.solvers import dense_kernels

    dk = dense_kernels.KERNEL_OPS if ops is None else ops
    check_solver(config)
    single = reduce is None
    if single:
        reduce = lambda x: x  # noqa: E731
    cm = _to_cm(prob)
    K = cm.cam_fixed.shape[0]
    O, L = cm.cam_t.shape
    route = schur_route(O)
    R = aa_to_rotmat(cam_rt6[:, :3]).contiguous()
    t = cam_rt6[:, 3:].contiguous()
    Xt = points.T.contiguous()
    args = (cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t)
    cost, red, Vu, g_p, W = dk.eval_assemble(*args, R, t, Xt,
                                             robust=config.robust)
    cost, red = reduce(cost), reduce(red)
    cost0 = cost
    dev, dt_ = cost.device, cost.dtype
    lam = torch.tensor(config.lam0, dtype=dt_, device=dev)
    nu = torch.tensor(2.0, dtype=dt_, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    fixed = cm.cam_fixed[:, None]
    zero = torch.zeros((), dtype=dt_, device=dev)
    hist = []
    for _ in range(config.max_iters):
        W18 = W.reshape(18, O, L)
        if single and route == "s":
            S, _zv, vinv6, b = dk.schur_prepare_s(
                lam, Vu, g_p, cm.pt_valid, W18, cm.cam_t, K, red, cm.cam_fixed)
            # S and b are in (i, k) order: the solution comes back as [6, K]
            dc = dk.chol_solve(S, b).reshape(6, K).T
        else:
            dc, vinv6 = _solve_unfolded(dk, route, lam, Vu, g_p, W18, cm, red,
                                        reduce)
        dc = torch.where(fixed, zero, dc).contiguous()
        R_new = (aa_to_rotmat(dc[:, :3]) @ R).contiguous()
        t_new = (t + dc[:, 3:]).contiguous()
        new_cost, red_n, Vu_n, gp_n, W_n, Xt_n = dk.eval_assemble_bs(
            *args, R_new, t_new, dc, Xt, W18, vinv6, g_p, cm.pt_valid,
            robust=config.robust)
        new_cost, red_n = reduce(new_cost), reduce(red_n)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        take = accept & ~done
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        R = torch.where(take, R_new, R)
        t = torch.where(take, t_new, t)
        Xt = torch.where(take, Xt_n, Xt)
        lam, nu = (
            torch.where(done, lam, torch.where(accept, lam / 3.0, lam * nu)),
            torch.where(done, nu, torch.where(accept, torch.full_like(nu, 2.0),
                                              nu * 2.0)),
        )
        cost = torch.where(take, new_cost, cost)
        done = done | (accept & (rel < config.rtol))
        red = torch.where(take, red_n, red)
        Vu = torch.where(take, Vu_n, Vu)
        g_p = torch.where(take, gp_n, g_p)
        W = torch.where(take, W_n, W)
        hist.append(new_cost)
    cams_out = torch.cat([rotmat_to_aa(R), t], -1)
    info = {"cost0": cost0, "cost": cost,
            "cost_history": torch.stack(hist) if hist else cost[None][:0]}
    return cams_out, Xt.T, info
