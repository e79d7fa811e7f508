"""Landmark-sharded flat-table BA (matrix-free PCG) over torch.distributed.

Port of `bundleadjustment_tpu/parallel/sharded_ba.py`. Landmarks are dealt
round-robin to the ranks of a process group, each with all of its
observations, so the point blocks, point gradients, point updates and the
back-substitution stay on their rank. Only camera-side terms are summed
over the group, each with one `all_reduce` (the reference's `lax.psum`
inside `shard_map`), per LM iteration:

- the undamped camera blocks U [K, 6, 6] and the gradient g_c [K, 6];
- the Schur rhs term red [K, 6];
- one [K, 6] back-projection per PCG matvec (`pcg_iters` of them);
- the trial cost (a scalar) for the accept test;

that is `all_reduces_per_iter(pcg_iters)` collectives and
`all_reduce_bytes_per_iter(K, pcg_iters)` bytes, plus one for the seed
cost. Cameras are replicated and every rank takes the same step.

Where the reference stacks the shards as [D, ...] arrays for one program
over a mesh, each rank here holds its own slice (`shard_problem(...,
rank)`). With no group nothing is communicated (one shard); a group of one
still issues every collective, counted in `multihost.COLLECTIVES`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu_torch.parallel.multihost import (
    all_gather_rows,
    all_reduce_hook,
)
from bundleadjustment_tpu_torch.solvers import residuals as res
from bundleadjustment_tpu_torch.solvers.lm import LMConfig, robust_cost
from bundleadjustment_tpu_torch.solvers.schur import (
    _segment_sum,
    block_jacobi,
    pcg,
    sym3_inv,
)


@dataclass
class ShardedBAProblem:
    """One rank's slice of a landmark-partitioned observation table. pt_idx
    is local to this rank's points; cam_idx is global (cameras are
    replicated)."""

    K4: torch.Tensor  # [4]
    cam_idx: torch.Tensor  # [Ns] int64
    pt_idx: torch.Tensor  # [Ns] int64 (local)
    uv: torch.Tensor  # [Ns, 2]
    sigma2: torch.Tensor  # [Ns]
    valid: torch.Tensor  # [Ns] bool
    cam_fixed: torch.Tensor  # [K] bool
    points: torch.Tensor  # [Ls, 3] this rank's landmarks
    pt_valid: torch.Tensor  # [Ls] bool (padding mask)


def shard_arrays(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed, points,
                 n_shards):
    """Host-side partition of a flat BA problem, numpy, all shards: the
    reference's `shard_problem`. Landmark l goes to shard l % n_shards at
    local index l // n_shards; every shard's arrays are padded to the
    largest shard (Ns observations, Ls landmarks). Returns (dict of [D, ...]
    arrays with ShardedBAProblem's fields, shard_of [L], local_of [L])."""
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    sigma2 = np.asarray(sigma2)
    valid = np.asarray(valid)
    points = np.asarray(points)
    L = points.shape[0]
    shard_of = np.arange(L) % n_shards
    local_of = np.arange(L) // n_shards
    Ls = (L + n_shards - 1) // n_shards
    obs_shard = shard_of[pt_idx]
    per_shard = [np.nonzero((obs_shard == d) & valid)[0] for d in range(n_shards)]
    Ns = max(max(len(sel) for sel in per_shard), 1)
    ci = np.zeros((n_shards, Ns), np.int32)
    pi = np.zeros((n_shards, Ns), np.int32)
    uv_s = np.zeros((n_shards, Ns, 2), np.float32)
    sg = np.ones((n_shards, Ns), np.float32)
    vd = np.zeros((n_shards, Ns), bool)
    pts_s = np.zeros((n_shards, Ls, 3), np.float32)
    pv = np.zeros((n_shards, Ls), bool)
    for d, sel in enumerate(per_shard):
        n = len(sel)
        ci[d, :n] = cam_idx[sel]
        pi[d, :n] = local_of[pt_idx[sel]]
        uv_s[d, :n] = uv[sel]
        sg[d, :n] = sigma2[sel]
        vd[d, :n] = True
        mine = np.nonzero(shard_of == d)[0]
        pts_s[d, :len(mine)] = points[mine]
        pv[d, :len(mine)] = True
    arrays = dict(K4=np.asarray(K4, np.float32), cam_idx=ci, pt_idx=pi, uv=uv_s,
                  sigma2=sg, valid=vd, cam_fixed=np.asarray(cam_fixed, bool),
                  points=pts_s, pt_valid=pv)
    return arrays, shard_of, local_of


_SHARDED_FIELDS = ("cam_idx", "pt_idx", "uv", "sigma2", "valid", "points",
                   "pt_valid")


def problem_of_shard(arrays, rank, device="cuda"):
    """Shard `rank` of `shard_arrays`'s dict (or of the JAX package's
    ShardedBAProblem fields, as numpy) as a ShardedBAProblem on `device`."""
    device = resolve_device(device)

    def put(name, a):
        a = np.asarray(a)
        if name in _SHARDED_FIELDS:
            a = a[rank]
        t = torch.from_numpy(np.array(a))
        if name in ("cam_idx", "pt_idx"):
            t = t.to(torch.int64)
        return t.to(device)

    return ShardedBAProblem(**{f: put(f, arrays[f]) for f in
                               ("K4", "cam_idx", "pt_idx", "uv", "sigma2",
                                "valid", "cam_fixed", "points", "pt_valid")})


def shard_problem(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed, points,
                  n_shards, rank=0, device="cuda"):
    """This rank's ShardedBAProblem of a round-robin landmark partition:
    (problem, shard_of [L], local_of [L])."""
    arrays, shard_of, local_of = shard_arrays(K4, cam_idx, pt_idx, uv, sigma2,
                                              valid, cam_fixed, points, n_shards)
    return problem_of_shard(arrays, rank, device), shard_of, local_of


def unshard_points(points_shard, shard_of, local_of, group=None):
    """Every rank's solved points [Ls, 3] back in the flat landmark order:
    numpy [L, 3] on every rank (one all_gather with a group)."""
    return all_gather_rows(points_shard, group).cpu().numpy()[shard_of, local_of]


def all_reduces_per_iter(pcg_iters):
    """All-reduces of one LM iteration: U, g_c, red, one per PCG matvec and
    the trial cost."""
    return 4 + pcg_iters


def all_reduce_bytes_per_iter(n_cams, pcg_iters):
    """Bytes all-reduced in one LM iteration (float32): U [K, 36], g_c,
    red and pcg_iters back-projections [K, 6], the cost."""
    K = n_cams
    return 4 * (36 * K + 6 * K + 6 * K + 6 * K * pcg_iters + 1)


def _local_problem(p: ShardedBAProblem):
    return res.BAProblem(
        K4=p.K4, cam_idx=p.cam_idx, pt_idx=p.pt_idx, uv=p.uv, sigma2=p.sigma2,
        valid=p.valid, cam_fixed=p.cam_fixed,
        pt_fixed=torch.zeros(p.points.shape[0], dtype=torch.bool,
                             device=p.points.device))


def sharded_ba_solve(problem: ShardedBAProblem, cams_rt6, config=None,
                     group=None):
    """Landmark-sharded LM solve of this rank's shard (the camera system by
    PCG, whatever `config.solver` says, as the reference's). Every rank of
    `group` calls it with the same cameras and config; None is the
    reference's default `LMConfig(max_iters=10, solver="pcg")`. Returns
    (cams [K, 6] replicated, this rank's points [Ls, 3], info)."""
    if config is None:
        config = LMConfig(max_iters=10, solver="pcg")
    reduce = all_reduce_hook(group)
    p = problem
    prob = _local_problem(p)
    K = cams_rt6.shape[0]
    Ls = p.points.shape[0]
    ci, pi = p.cam_idx, p.pt_idx
    dev, dt_ = cams_rt6.device, cams_rt6.dtype
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    zero = torch.zeros((), dtype=dt_, device=dev)
    fixed = p.cam_fixed[:, None]

    def build(R, t, points, lam):
        r, Jc, Jp, _ = res.residuals_and_jacobians(prob, R, t, points,
                                                   robust=config.robust)
        U = reduce(_segment_sum(torch.einsum("nri,nrj->nij", Jc, Jc), ci, K))
        g_c = reduce(_segment_sum(torch.einsum("nri,nr->ni", Jc, r), ci, K))
        V = _segment_sum(torch.einsum("nri,nrj->nij", Jp, Jp), pi, Ls)
        g_p = _segment_sum(torch.einsum("nri,nr->ni", Jp, r), pi, Ls)
        W = torch.einsum("nri,nrj->nij", Jc, Jp)
        dU = torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=1e-6)
        dV = torch.clamp(torch.diagonal(V, dim1=-2, dim2=-1), min=1e-6)
        U = U + (lam * dU)[..., None] * eye6
        V = V + (lam * dV)[..., None] * eye3
        U = torch.where(p.cam_fixed[:, None, None], eye6, U)
        V = torch.where(p.pt_valid[:, None, None], V, eye3)
        g_c = torch.where(fixed, zero, g_c)
        return U, sym3_inv(V), W, g_c, g_p

    def cost_of(R, t, points):
        return reduce(robust_cost(prob, R, t, points, config.robust))

    R, t = res.cams_to_Rt(cams_rt6)
    points = p.points
    cost = cost_of(R, t, points)
    cost0 = cost
    lam = torch.tensor(config.lam0, dtype=dt_, device=dev)
    nu = torch.tensor(2.0, dtype=dt_, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    hist = []
    for _ in range(config.max_iters):
        U, V_inv, W, g_c, g_p = build(R, t, points, lam)

        def matvec(x):
            y = _segment_sum(torch.einsum("nij,ni->nj", W, x[ci]), pi, Ls)
            z = torch.einsum("lij,lj->li", V_inv, y)
            back = _segment_sum(torch.einsum("nij,nj->ni", W, z[pi]), ci, K)
            return torch.einsum("kij,kj->ki", U, x) - reduce(back)

        z = torch.einsum("lij,lj->li", V_inv, g_p)
        red = reduce(_segment_sum(torch.einsum("nij,nj->ni", W, z[pi]), ci, K))
        dc = pcg(matvec, -(g_c - red), block_jacobi(U), config.pcg_iters)
        y = _segment_sum(torch.einsum("nij,ni->nj", W, dc[ci]), pi, Ls)
        dp = -torch.einsum("lij,lj->li", V_inv, g_p + y)
        R_new = aa_to_rotmat(torch.where(fixed, zero, dc[:, :3])) @ R
        t_new = t + torch.where(fixed, zero, dc[:, 3:])
        pts_new = points + torch.where(p.pt_valid[:, None], dp, zero)
        new_cost = cost_of(R_new, t_new, pts_new)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        take = accept & ~done
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        R = torch.where(take, R_new, R)
        t = torch.where(take, t_new, t)
        points = torch.where(take, pts_new, points)
        lam, nu = (
            torch.where(done, lam, torch.where(accept, lam / 3.0, lam * nu)),
            torch.where(done, nu, torch.where(accept, torch.full_like(nu, 2.0),
                                              nu * 2.0)),
        )
        cost = torch.where(take, new_cost, cost)
        done = done | (accept & (rel < config.rtol))
        hist.append(new_cost)
    info = {"cost0": cost0, "cost": cost,
            "cost_history": torch.stack(hist) if hist else cost[None][:0]}
    return res.Rt_to_cams(R, t), points, info
