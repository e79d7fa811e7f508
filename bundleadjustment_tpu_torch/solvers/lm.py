"""Levenberg-Marquardt engines: the flat BA engine and batched motion-only BA.

Port of `bundleadjustment_tpu/solvers/lm.py`. The JAX `lax.scan` iterations
become Python loops whose accept/reject decisions stay on the device as
`torch.where` selects: no host sync inside a solve, a fixed iteration count,
and state frozen once `done` is set.

- `ba_solve`: flat observation-table engine (Nielsen gain-ratio damping,
  dense Schur + Cholesky, or matrix-free PCG with `solver="pcg"`); the
  pipeline uses it for problems under `ba_layout_auto_min_obs`
  observations.
- `motion_only_ba`: per-camera 6x6 LM with chi2 pruning between outer
  rounds; the JAX `vmap` is an explicit leading batch axis here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat, rotmat_to_aa
from bundleadjustment_tpu_torch.solvers import residuals as res
from bundleadjustment_tpu_torch.solvers import schur as schur_mod


@dataclass(frozen=True)
class LMConfig:
    max_iters: int = 10
    lam0: float = 1e-4
    solver: str = "dense"  # "dense" (Cholesky) | "pcg" (matrix-free CG)
    pcg_iters: int = 50
    pcg_tol: float = 1e-6  # stops nothing, as in the reference (schur.pcg)
    robust: bool = True
    rtol: float = 1e-9  # relative cost-decrease tolerance for the freeze


# Fixed cost of an observation whose point is behind the camera (no gradient):
# LM never accepts a step that pushes points behind the cameras.
CHEIRALITY_PENALTY = 1.0e4


SOLVERS = ("dense", "pcg")


def check_solver(config):
    if config.solver not in SOLVERS:
        raise ValueError(f"unknown solver {config.solver!r}; one of {SOLVERS}")


def _huber_rho(r2, robust):
    if not robust:
        return 0.5 * r2
    d = res.HUBER_DELTA
    nrm = torch.sqrt(torch.clamp(r2, min=1e-20))
    return torch.where(nrm <= d, 0.5 * r2, d * (nrm - 0.5 * d))


def robust_cost(problem, R, t, points, robust=True):
    """Total Huber cost with the cheirality penalty."""
    r, z = res.reprojection_residuals(problem, R, t, points)
    rho = _huber_rho(torch.sum(r * r, -1), robust)
    rho = torch.where(z > 1e-6, rho, torch.full_like(rho, CHEIRALITY_PENALTY))
    return torch.sum(torch.where(problem.valid, rho, torch.zeros_like(rho)))


def _apply_update(R, t, points, dc, dp, cam_fixed, pt_fixed):
    zero = torch.zeros((), dtype=dc.dtype, device=dc.device)
    dphi = torch.where(cam_fixed[:, None], zero, dc[:, :3])
    dt = torch.where(cam_fixed[:, None], zero, dc[:, 3:])
    dX = torch.where(pt_fixed[:, None], zero, dp)
    return aa_to_rotmat(dphi) @ R, t + dt, points + dX


def ba_solve(problem, cam_rt6, points, config=LMConfig()):
    """Run LM on a `BAProblem`. Returns (cam_rt6', points', info)."""
    check_solver(config)
    R, t = res.cams_to_Rt(cam_rt6)
    cost = robust_cost(problem, R, t, points, config.robust)
    cost0 = cost
    n_cams, n_pts = cam_rt6.shape[0], points.shape[0]
    dev, dt_ = cost.device, cost.dtype
    lam = torch.tensor(config.lam0, dtype=dt_, device=dev)
    nu = torch.tensor(2.0, dtype=dt_, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    hist = []
    for _ in range(config.max_iters):
        r, Jc, Jp, _w = res.residuals_and_jacobians(
            problem, R, t, points, robust=config.robust)
        blocks = schur_mod.build_blocks(
            r, Jc, Jp, problem.cam_idx, problem.pt_idx, n_cams, n_pts, lam,
            problem.cam_fixed, problem.pt_fixed)
        if config.solver == "dense":
            dc = schur_mod.solve_schur_dense(blocks)
        else:
            dc = schur_mod.solve_schur_pcg(blocks, config.pcg_iters,
                                           config.pcg_tol)
        dp = schur_mod.back_substitute(blocks, dc)
        R_new, t_new, pts_new = _apply_update(
            R, t, points, dc, dp, problem.cam_fixed, problem.pt_fixed)
        new_cost = robust_cost(problem, R_new, t_new, pts_new, config.robust)

        # Nielsen gain ratio; predicted decrease 0.5 dx^T (lam dx - g)
        pred = 0.5 * (lam * (torch.sum(dc * dc) + torch.sum(dp * dp))
                      - torch.sum(dc * blocks.g_c) - torch.sum(dp * blocks.g_p))
        pred = torch.clamp(pred, min=1e-20)
        rho = (cost - new_cost) / pred
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        take = accept & ~done
        R = torch.where(take, R_new, R)
        t = torch.where(take, t_new, t)
        points = torch.where(take, pts_new, points)
        lam, nu = (
            torch.where(done, lam, torch.where(accept, lam_acc, lam * nu)),
            torch.where(done, nu, torch.where(accept, torch.full_like(nu, 2.0),
                                              nu * 2.0)),
        )
        cost = torch.where(take, new_cost, cost)
        done = done | (accept & (rel < config.rtol))
        hist.append(cost)
    info = {"cost0": cost0, "cost": cost, "lam": lam,
            "cost_history": torch.stack(hist) if hist else cost[None][:0]}
    return res.Rt_to_cams(R, t), points, info


# ---------------------------------------------------------------------------
# batched motion-only BA (tracking)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MotionOnlyConfig:
    outer_iters: int = 4
    inner_iters: int = 10
    lam0: float = 1e-3
    chi2_max: float = res.CHI2_2D
    robust: bool = True


def _project_batch(K4, R, t, X):
    """R [B,3,3], t [B,3], X [B,M,3] -> (x_cam [B,M,3], RX, u, v, z)."""
    RX = X @ R.transpose(-1, -2)
    x_cam = RX + t[:, None, :]
    z = x_cam[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = K4[0] * x_cam[..., 0] / zs + K4[2]
    v = K4[1] * x_cam[..., 1] / zs + K4[3]
    return x_cam, RX, u, v, z, zs


def _motion_residuals(K4, R, t, X, uv, sigma2, valid, robust):
    """Whitened residuals [B,M,2] and Jacobian [B,M,2,6] for each camera."""
    x_cam, RX, _, _, z, zs = _project_batch(K4, R, t, X)
    inv_z = 1.0 / zs
    u = K4[0] * x_cam[..., 0] * inv_z + K4[2]
    v = K4[1] * x_cam[..., 1] * inv_z + K4[3]
    inv_sigma = 1.0 / torch.sqrt(torch.clamp(sigma2, min=1e-12))
    r = torch.stack([u - uv[..., 0], v - uv[..., 1]], -1) * inv_sigma[..., None]
    duv = res._duv_dx(K4, x_cam, inv_z, inv_sigma)
    Jc = torch.cat([duv @ res._neg_skew(RX), duv], -1)
    mask = valid & (z > 1e-6)
    w = mask.to(r.dtype)
    if robust:
        w = w * res.huber_weights(r)
    sw = torch.sqrt(w)
    return r * sw[..., None], Jc * sw[..., None, None]


def _motion_cost(K4, R, t, X, uv, sigma2, valid, robust):
    _, _, u, v, z, _ = _project_batch(K4, R, t, X)
    r2 = ((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2) \
        / torch.clamp(sigma2, min=1e-12)
    rho = _huber_rho(r2, robust)
    rho = torch.where(z > 1e-6, rho, torch.full_like(rho, CHEIRALITY_PENALTY))
    return torch.sum(torch.where(valid, rho, torch.zeros_like(rho)), -1)


def motion_only_ba(K4, cam_rt6, points, uv, sigma2, valid,
                   cfg=MotionOnlyConfig()):
    """Batched motion-only BA.

    K4 [4]; cam_rt6 [B,6] initial extrinsics; points [B,M,3] fixed landmarks;
    uv [B,M,2]; sigma2 [B,M]; valid [B,M] bool.
    Returns (cam_rt6' [B,6], inlier_mask [B,M]).
    """
    B = cam_rt6.shape[0]
    dev, dt_ = cam_rt6.device, cam_rt6.dtype
    R = aa_to_rotmat(cam_rt6[:, :3])
    t = cam_rt6[:, 3:]
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    valid_cur = valid
    for _ in range(cfg.outer_iters):
        lam = torch.full((B,), cfg.lam0, dtype=dt_, device=dev)
        nu = torch.full((B,), 2.0, dtype=dt_, device=dev)
        cost = _motion_cost(K4, R, t, points, uv, sigma2, valid_cur, cfg.robust)
        for _ in range(cfg.inner_iters):
            r, Jc = _motion_residuals(K4, R, t, points, uv, sigma2, valid_cur,
                                      cfg.robust)
            H = torch.einsum("bmri,bmrj->bij", Jc, Jc)
            g = torch.einsum("bmri,bmr->bi", Jc, r)
            dH = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)
            Hd = H + lam[:, None, None] * torch.diag_embed(dH) + 1e-9 * eye6
            dx = -torch.linalg.solve_ex(Hd, g)[0]
            R_new = aa_to_rotmat(dx[:, :3]) @ R
            t_new = t + dx[:, 3:]
            c_new = _motion_cost(K4, R_new, t_new, points, uv, sigma2,
                                 valid_cur, cfg.robust)
            accept = (c_new < cost) & torch.isfinite(c_new)
            R = torch.where(accept[:, None, None], R_new, R)
            t = torch.where(accept[:, None], t_new, t)
            lam, nu = (torch.where(accept, lam / 3.0, lam * nu),
                       torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0))
            cost = torch.where(accept, c_new, cost)
        # chi2 prune between outer rounds (never un-prunes an original invalid)
        _, _, u, v, z, _ = _project_batch(K4, R, t, points)
        chi2 = ((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2) \
            / torch.clamp(sigma2, min=1e-12)
        valid_cur = valid & (chi2 <= cfg.chi2_max) & (z > 1e-6)
    return torch.cat([rotmat_to_aa(R), t], -1), valid_cur
