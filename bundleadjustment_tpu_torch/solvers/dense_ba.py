"""Dense landmark-major bundle adjustment (exact Schur + Cholesky, or PCG).

Port of `bundleadjustment_tpu/solvers/dense_ba.py`. Observations are
grouped by landmark into `[L, O]` slots (validity-masked) and carried in the
reference's component-major `[..., O, L]` layout (`_CM`), so the kernels and
their plain versions take exactly the arrays the Pallas kernels take.

One LM iteration (`dense_ba_solve`), `solver="dense"`:

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

With `solver="pcg"` the step is the reference's non-fused branch
(`_pcg_system`): the damped U and V^-1 in PyTorch, PCG on the camera system
with one `reduce` of the [K, 6] back-projection per matvec (`schur.pcg`),
the landmark back-substitution in PyTorch, then kernel B without the
back-substitution (`eval_assemble`) at the trial point. It launches no C,
K5, D or E.

The LM semantics are the reference's: a fixed `max_iters`, state frozen once
`done` is set, lambda / 3 on accept and lambda * nu on reject. Kernel B seeds
the loop without the back-substitution. On CPU tensors both kernels run
their plain PyTorch versions (`solvers/dense_kernels.py`).

Two paths run the same iteration, written once as four segment functions
(`_schur_system`, `_camera_step`, `_trial`, `_lm_update`):

- eager (`_solve_eager`): each iteration calls the segments and rebinds
  their results, every route, PCG and sharded;
- graphed (`_LoopGraphs`): steps 1, 3 and 4 are each captured once as a
  `torch.cuda.CUDAGraph`, which reads and writes static buffers (the loop
  state, the step dc, S and b, the trial point; `_lm_update` writes the
  state in place), and each iteration replays them around step 2, which
  stays eager. The host then issues three graph launches and the camera
  solve's few ops an iteration, where the eager path issues about 80, so
  the card, not the host, sets the pace.

The camera solve stays outside the graphs: its Cholesky stays a host op of
its own, to which a profiler links the Cholesky's kernels (the benchmark's
Schur roofline closes each iteration's window there), and `ops.chol_solve`
stays free to be the library call or kernel E.

The graphed path engages (`graph_engages`) on CUDA tensors, one device
(`reduce` None) and the exact solver, when the call repeats the key
(`graph_key`) of one of the last `GRAPHS.SIZE` such calls: the problem's
tensors (identity, data pointer, `_version`, shape), the route, the
settings baked into the graphs and `ops`. The first call of a key runs
eager, and is the warm-up that capture needs (kernels loaded, library
workspaces made); the second captures, then replays. A problem edited in
place has a new `_version`, so a new key. Each captured key has its own
memory pool, freed when the key leaves the cache or one of its problem's
tensors dies. A new problem each call (the pipeline's BAs), the sharded
engine, PCG and CPU tensors always run eager.

Each solve is a span `ba.solve` of the module's `TIMER`, and steps 1-4 of
each iteration are its child spans `ba.schur`, `ba.camera_solve`, `ba.eval`
and `ba.lm_update`, on every route, with PCG and in both paths. A graphed
solve's iterations lie inside a span `ba.graph`, and a capture is a span
`ba.capture`, so a solve's record says which path ran it.
`kernels.LAUNCHES["graph_replay"]` counts the replays; the kernels'
own counts stay those of their wrappers' launches, which a capture does
not add to.
"""

from __future__ import annotations

import functools
import weakref
from collections import OrderedDict, namedtuple
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
from bundleadjustment_tpu_torch.solvers.schur import block_jacobi, pcg
from bundleadjustment_tpu_torch.utils.profiling import PhaseTimer


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
SYM3_IDX = np.zeros((3, 3), np.int64)
for _n, (_i, _j) in enumerate(TRIU3):
    SYM3_IDX[_i, _j] = SYM3_IDX[_j, _i] = _n


@functools.lru_cache(maxsize=None)
def sym6_index(device):
    """SYM6_IDX as a tensor on `device`, copied there once: a copy from the
    host inside the LM loop would wait for the host (and cannot be captured
    in a CUDA graph)."""
    return torch.from_numpy(SYM6_IDX).to(device)


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


# The solve's spans (module docstring), always on. They time the host's
# issue of the work, since the solve does not synchronise; the records of the
# last 64 solves stay in memory, and under a profiler the spans join its
# trace.
TIMER = PhaseTimer()


def _system_unfolded(dk, route, lam, Vu, g_p, W18, cm, red, reduce):
    """Branches (b) and (c) of the reference's `solve_fused` up to the camera
    system: the +Q Q^T partial and red6 (K5, or kernel D + Pf + Q Q^T),
    all-reduced, then the damped U and 1e-8 I folded in, in (i, k) order as
    route (a). Returns (S, b, vinv6)."""
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
    return S, b, vinv6


def _pcg_system(lam, red, Vu, g_p, W18, cm, reduce):
    """The camera system of the reference's non-fused PCG branch
    (`solve_cameras`, `bundleadjustment_tpu/solvers/dense_ba.py:465-529`),
    which `schur.pcg` solves. Each product over a landmark's slots is one
    einsum (the reference's unrolled sums, in another summation order).
    Returns (matvec, b [K, 6], U [K, 6, 6] for the preconditioner, vinv6
    [6, L] for the back-substitution)."""
    from bundleadjustment_tpu_torch.solvers.dense_kernels import (
        damped_u,
        point_inverse_plain,
    )

    K = cm.cam_fixed.shape[0]
    O, L = cm.cam_t.shape
    cam = cm.cam_t.long()
    cam_flat = cam.reshape(-1)
    W = W18.reshape(6, 3, O, L)
    U, g_c = damped_u(lam, red, cm.cam_fixed)
    vinv6, zv = point_inverse_plain(lam, Vu, g_p, cm.pt_valid)
    V_inv = vinv6[torch.from_numpy(SYM3_IDX).to(vinv6.device)]  # [3, 3, L]

    def to_cams(z_pt):
        """sum_o W_o z_pt per camera, [K, 6] (the reference's
        `_reduce_cams(_w_apply(W, z))`), all-reduced."""
        wz = torch.einsum("ijol,jl->iol", W, z_pt).reshape(6, -1)
        return reduce(torch.zeros((K, 6), dtype=wz.dtype, device=wz.device)
                      .index_add_(0, cam_flat, wz.T))

    def matvec(x):
        y = torch.einsum("ijol,oli->jl", W, x[cam])  # W^T x per landmark
        return (torch.einsum("kij,kj->ki", U, x)
                - to_cams(torch.einsum("jml,ml->jl", V_inv, y)))

    b = -(g_c - to_cams(zv))
    return matvec, b, U, vinv6


# The LM loop's state, and an iteration's trial point (cameras as R [K,3,3]
# and t [K,3], landmarks as Xt [3,L], the cost and the reductions of kernel
# B at them; lam, nu and done 0-d).
LMState = namedtuple("LMState", "R t Xt cost red Vu g_p W lam nu done")
Trial = namedtuple("Trial", "R t Xt cost red Vu g_p W")


def _same(x):
    """The `reduce` of one device: nothing to sum over."""
    return x


def _eval_args(cm):
    return (cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t)


def _lm_start(dk, cm, cam_rt6, points, config, reduce):
    """The loop's start: the state at (cam_rt6, points) by kernel B without
    the back-substitution, lam0, nu = 2, not done."""
    R = aa_to_rotmat(cam_rt6[:, :3]).contiguous()
    t = cam_rt6[:, 3:].contiguous()
    Xt = points.T.contiguous()
    cost, red, Vu, g_p, W = dk.eval_assemble(*_eval_args(cm), R, t, Xt,
                                             robust=config.robust)
    cost, red = reduce(cost), reduce(red)
    dev, dt_ = cost.device, cost.dtype
    return LMState(R, t, Xt, cost, red, Vu, g_p, W,
                   torch.tensor(config.lam0, dtype=dt_, device=dev),
                   torch.tensor(2.0, dtype=dt_, device=dev),
                   torch.zeros((), dtype=torch.bool, device=dev))


def _schur_system(dk, cm, route, single, st, reduce):
    """Step 1, exact: (S, b, vinv6) of the damped Schur system at the state,
    by kernel C (one device, route (s)) or `_system_unfolded`."""
    K = cm.cam_fixed.shape[0]
    O, L = cm.cam_t.shape
    W18 = st.W.reshape(18, O, L)
    if single and route == "s":
        S, _zv, vinv6, b = dk.schur_prepare_s(st.lam, st.Vu, st.g_p, cm.pt_valid, W18,
                                              cm.cam_t, K, st.red, cm.cam_fixed)
        return S, b, vinv6
    return _system_unfolded(dk, route, st.lam, st.Vu, st.g_p, W18, cm, st.red, reduce)


def _camera_step(dk, S, b, fixed, zero, out=None):
    """Step 2, exact: the camera step dc [K, 6] = S^-1 b by `dk.chol_solve`,
    zero for the fixed cameras (`fixed` [K, 1]); written into `out` where
    given."""
    # S and b are in (i, k) order: the solution comes back as [6, K]
    x = dk.chol_solve(S, b).reshape(6, -1).T
    if out is None:
        return torch.where(fixed, zero, x).contiguous()
    return torch.where(fixed, zero, x, out=out)


def _trial(dk, cm, config, st, dc, vinv6, reduce, pcg_mode=False):
    """Step 3: the trial point of the step dc and kernel B there: with the
    landmarks' back-substitution fused (exact), or after it (PCG)."""
    from bundleadjustment_tpu_torch.solvers.dense_kernels import _backsub_plain

    O, L = cm.cam_t.shape
    W18 = st.W.reshape(18, O, L)
    args = _eval_args(cm)
    R_new = (aa_to_rotmat(dc[:, :3]) @ st.R).contiguous()
    t_new = (st.t + dc[:, 3:]).contiguous()
    if pcg_mode:
        Xt_n = _backsub_plain(cm.cam_t, dc, st.Xt, W18, vinv6, st.g_p,
                              cm.pt_valid).contiguous()
        cost, red, Vu, g_p, W = dk.eval_assemble(*args, R_new, t_new, Xt_n,
                                                 robust=config.robust)
    else:
        cost, red, Vu, g_p, W, Xt_n = dk.eval_assemble_bs(
            *args, R_new, t_new, dc, st.Xt, W18, vinv6, st.g_p, cm.pt_valid,
            robust=config.robust)
    return Trial(R_new, t_new, Xt_n, reduce(cost), reduce(red), Vu, g_p, W)


def _lm_update(st, tr, rtol, out=None):
    """Step 4: accept the trial where its cost is lower and finite and the
    loop is not done; lambda / 3 on accept, lambda * nu on reject; done once
    an accepted step gains less than `rtol`. Returns the new state, written
    into `out` where given: `out` may be `st` itself, as each write reads
    nothing that an earlier write has changed."""
    o = LMState(*[None] * len(LMState._fields)) if out is None else out
    accept = (tr.cost < st.cost) & torch.isfinite(tr.cost)
    take = accept & ~st.done
    rel = (st.cost - tr.cost) / torch.clamp(st.cost, min=1e-20)
    R = torch.where(take, tr.R, st.R, out=o.R)
    t = torch.where(take, tr.t, st.t, out=o.t)
    Xt = torch.where(take, tr.Xt, st.Xt, out=o.Xt)
    lam = torch.where(st.done, st.lam,
                      torch.where(accept, st.lam / 3.0, st.lam * st.nu), out=o.lam)
    nu = torch.where(st.done, st.nu,
                     torch.where(accept, torch.full_like(st.nu, 2.0), st.nu * 2.0),
                     out=o.nu)
    cost = torch.where(take, tr.cost, st.cost, out=o.cost)
    done = torch.bitwise_or(st.done, accept & (rel < rtol), out=o.done)
    red = torch.where(take, tr.red, st.red, out=o.red)
    Vu = torch.where(take, tr.Vu, st.Vu, out=o.Vu)
    g_p = torch.where(take, tr.g_p, st.g_p, out=o.g_p)
    W = torch.where(take, tr.W, st.W, out=o.W)
    return LMState(R, t, Xt, cost, red, Vu, g_p, W, lam, nu, done)


def _solve_eager(dk, cm, route, single, st, config, reduce, span):
    """The eager path: `config.max_iters` iterations from the state `st`.
    Returns (the last state, the trial costs [max_iters])."""
    O, L = cm.cam_t.shape
    fixed = cm.cam_fixed[:, None]
    zero = torch.zeros((), dtype=st.cost.dtype, device=st.cost.device)
    hist = []
    pcg_mode = config.solver == "pcg"
    for _ in range(config.max_iters):
        with span("ba.schur"):
            if pcg_mode:
                matvec, b, U, vinv6 = _pcg_system(st.lam, st.red, st.Vu, st.g_p,
                                                  st.W.reshape(18, O, L), cm, reduce)
            else:
                S, b, vinv6 = _schur_system(dk, cm, route, single, st, reduce)
        with span("ba.camera_solve"):
            if pcg_mode:
                dc = pcg(matvec, b, block_jacobi(U), config.pcg_iters)
                dc = torch.where(fixed, zero, dc).contiguous()
            else:
                dc = _camera_step(dk, S, b, fixed, zero)
        with span("ba.eval"):
            tr = _trial(dk, cm, config, st, dc, vinv6, reduce, pcg_mode)
        with span("ba.lm_update"):
            st = _lm_update(st, tr, config.rtol)
            hist.append(tr.cost)
    return st, torch.stack(hist) if hist else st.cost[None][:0]


def _capture(fn, pool):
    """(graph, fn's outputs): fn() captured as a CUDA graph whose memory
    comes from `pool`. Nothing runs; each replay runs the captured work on
    the same buffers, and so writes the same output tensors."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    return graph, out


class _LoopGraphs:
    """One key's LM iteration as three CUDA graphs, steps 1, 3 and 4, which
    replay around the eager step 2 (module docstring), with the static
    buffers they read and write: the loop state `st`, the step `dc`, the
    Schur system (S, b, vinv6) and the trial point. The three share one
    memory pool and replay in the order of their capture."""

    def __init__(self, dk, cm, route, config, st0):
        from bundleadjustment_tpu_torch import kernels

        self.dk, self.cm = dk, cm
        self.st = LMState(*(x.clone() for x in st0))
        self.dc = torch.zeros((cm.cam_fixed.shape[0], 6), dtype=st0.cost.dtype,
                              device=st0.cost.device)
        self.zero = torch.zeros((), dtype=st0.cost.dtype, device=st0.cost.device)
        self.fixed = cm.cam_fixed[:, None]
        pool = torch.cuda.graph_pool_handle()
        counts = kernels.launch_counts()
        try:  # a wrapper called while capturing launches nothing
            schur, (self.S, self.b, self.vinv6) = _capture(
                lambda: _schur_system(dk, cm, route, True, self.st, _same), pool)
            trial, self.trial = _capture(
                lambda: _trial(dk, cm, config, self.st, self.dc, self.vinv6, _same),
                pool)
            update, _ = _capture(
                lambda: _lm_update(self.st, self.trial, config.rtol, out=self.st), pool)
        finally:
            kernels.LAUNCHES.update(counts)
        self.graphs = (schur, trial, update)

    def solve(self, st0, max_iters, span):
        """`max_iters` replayed iterations from the state `st0`. Returns (the
        last state, the trial costs [max_iters]), in tensors that no later
        solve writes."""
        from bundleadjustment_tpu_torch import kernels

        st = self.st
        for x, x0 in zip(st, st0):
            x.copy_(x0)
        hist = torch.empty((max_iters,), dtype=st.cost.dtype, device=st.cost.device)
        schur, trial, update = self.graphs
        with span("ba.graph"):
            for i in range(max_iters):
                with span("ba.schur"):
                    schur.replay()
                with span("ba.camera_solve"):
                    _camera_step(self.dk, self.S, self.b, self.fixed, self.zero,
                                 out=self.dc)
                with span("ba.eval"):
                    trial.replay()
                with span("ba.lm_update"):
                    update.replay()
                    hist[i].copy_(self.trial.cost)
        kernels.LAUNCHES["graph_replay"] += 3 * max_iters
        return LMState(*(x.clone() for x in st)), hist


def _problem_tensors(prob):
    return (prob.K4, prob.cam_idx, prob.uv, prob.sigma2, prob.valid, prob.cam_fixed,
            prob.pt_valid)


def graph_key(prob, cam_rt6, points, config, ops):
    """The key of a call (module docstring): what its captured iteration
    reads by address or bakes in. Each of the problem's tensors by identity,
    data pointer, `_version` (bumped by every in-place edit), shape and
    dtype; the start's dtypes; the route; the settings that the graphs take
    as constants (robust cost, rtol, TF32 in the library's Q Q^T); `ops`."""
    tensors = _problem_tensors(prob)
    return (tuple((id(x), x.data_ptr(), x._version, tuple(x.shape), x.dtype)
                  for x in tensors),
            prob.uv.device, cam_rt6.dtype, points.dtype,
            schur_route(prob.cam_idx.shape[1]), bool(config.robust),
            float(config.rtol), torch.backends.cuda.matmul.allow_tf32, ops)


def graph_engages(device, reduce, solver, seen):
    """The rule of the graphed path: CUDA tensors, one device (no
    `reduce`), the exact solver, and a key seen in an earlier call."""
    return (torch.device(device).type == "cuda" and reduce is None
            and solver == "dense" and seen)


class _GraphEntry:
    """A key's entry: weak references to its problem's tensors and, from the
    key's second call on, its captured iteration."""

    __slots__ = ("refs", "loop")

    def __init__(self, tensors):
        self.refs = tuple(weakref.ref(x) for x in tensors)
        self.loop = None

    def alive(self):
        return all(r() is not None for r in self.refs)


class GraphCache:
    """The keys of the last `SIZE` graph-eligible calls, oldest first. An
    entry whose problem has lost a tensor lapses (the key's identities could
    then be another problem's), and a dropped entry frees its graphs and
    their pool."""

    SIZE = 4

    def __init__(self):
        self._entries = OrderedDict()

    def visit(self, key, tensors):
        """(the key's entry, whether an earlier call made it); makes it the
        newest."""
        for k in [k for k, e in self._entries.items() if not e.alive()]:
            del self._entries[k]
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            return entry, True
        entry = self._entries[key] = _GraphEntry(tensors)
        while len(self._entries) > self.SIZE:
            self._entries.popitem(last=False)
        return entry, False

    def captured(self):
        """How many of the entries hold a captured iteration."""
        return sum(e.loop is not None for e in self._entries.values())

    def clear(self):
        self._entries.clear()


GRAPHS = GraphCache()


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
    per-camera rows are reduced after every eval. With `config.solver ==
    "pcg"` every route gives way to `_pcg_system` and `schur.pcg` (one
    reduce per matvec) and kernel B without back-substitution.

    A repeated call on one device replays the iteration as CUDA graphs
    (module docstring); the outputs are the eager path's.
    """
    span = TIMER.phase
    with span("ba.solve"):
        from bundleadjustment_tpu_torch.solvers import dense_kernels

        dk = dense_kernels.KERNEL_OPS if ops is None else ops
        check_solver(config)
        device = prob.uv.device
        entry, seen = None, False
        if graph_engages(device, reduce, config.solver, True):
            entry, seen = GRAPHS.visit(graph_key(prob, cam_rt6, points, config, dk),
                                       _problem_tensors(prob))
        if graph_engages(device, reduce, config.solver, seen):
            with torch.cuda.device(device):
                cm = _to_cm(prob) if entry.loop is None else entry.loop.cm
                st0 = _lm_start(dk, cm, cam_rt6, points, config, _same)
                if entry.loop is None:
                    with span("ba.capture"):
                        entry.loop = _LoopGraphs(dk, cm, schur_route(cm.cam_t.shape[0]),
                                                 config, st0)
                st, hist = entry.loop.solve(st0, config.max_iters, span)
        else:
            single = reduce is None
            if single:
                reduce = _same
            cm = _to_cm(prob)
            st0 = _lm_start(dk, cm, cam_rt6, points, config, reduce)
            st, hist = _solve_eager(dk, cm, schur_route(cm.cam_t.shape[0]), single, st0,
                                    config, reduce, span)
        cams_out = torch.cat([rotmat_to_aa(st.R), st.t], -1)
        info = {"cost0": st0.cost, "cost": st.cost, "cost_history": hist}
        return cams_out, st.Xt.T, info
