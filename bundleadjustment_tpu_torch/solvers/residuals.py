"""Reprojection residuals with analytic Jacobians, flat observation table.

Port of `bundleadjustment_tpu/solvers/residuals.py`. A problem is the flat
table cam_idx/pt_idx/uv/sigma2/valid plus camera and point state. Camera
increments are left-multiplicative: x_cam = exp([dphi]x) R X + t + dt.
Residuals are whitened by 1/sigma and robustified by Huber-IRLS with
delta = sqrt(5.991).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat, rotmat_to_aa

CHI2_2D = 5.991
HUBER_DELTA = 2.4477  # sqrt(5.991)


@dataclass
class BAProblem:
    """A padded, masked bundle-adjustment problem (tensors on one device)."""

    K4: torch.Tensor  # [4]
    cam_idx: torch.Tensor  # [N] int64
    pt_idx: torch.Tensor  # [N] int64
    uv: torch.Tensor  # [N, 2]
    sigma2: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool
    cam_fixed: torch.Tensor  # [K] bool (gauge anchors)
    pt_fixed: torch.Tensor  # [L] bool


def cams_to_Rt(cam_rt6):
    """[K,6] axis-angle+t -> (R [K,3,3], t [K,3])."""
    return aa_to_rotmat(cam_rt6[..., :3]), cam_rt6[..., 3:]


def Rt_to_cams(R, t):
    return torch.cat([rotmat_to_aa(R), t], -1)


def _rsqrt(x):
    return 1.0 / torch.sqrt(torch.clamp(x, min=1e-12))


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def reprojection_residuals(problem, R, t, points):
    """Whitened residuals r [N,2] and depths z [N]; invalid rows give r = 0."""
    Rc = R[problem.cam_idx]
    tc = t[problem.cam_idx]
    X = points[problem.pt_idx]
    x_cam = (Rc @ X[..., None])[..., 0] + tc
    z = x_cam[..., 2]
    zs = _safe_z(z)
    K4 = problem.K4
    u = K4[0] * x_cam[..., 0] / zs + K4[2]
    v = K4[1] * x_cam[..., 1] / zs + K4[3]
    r = torch.stack([u - problem.uv[..., 0], v - problem.uv[..., 1]], -1)
    r = r * _rsqrt(problem.sigma2)[..., None]
    r = torch.where(problem.valid[..., None], r, torch.zeros_like(r))
    return r, z


def huber_weights(r, delta=HUBER_DELTA):
    """IRLS weights of the Huber loss on the residual 2-norm."""
    nrm = torch.linalg.norm(r, dim=-1)
    return torch.where(nrm <= delta, torch.ones_like(nrm),
                       delta / torch.clamp(nrm, min=1e-12))


def _neg_skew(RX):
    x, y, z = RX[..., 0], RX[..., 1], RX[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([
        torch.stack([o, z, -y], -1),
        torch.stack([-z, o, x], -1),
        torch.stack([y, -x, o], -1),
    ], -2)


def _duv_dx(K4, x_cam, inv_z, inv_sigma):
    fx, fy = K4[0], K4[1]
    o = torch.zeros_like(inv_z)
    d = torch.stack([
        torch.stack([fx * inv_z, o, -fx * x_cam[..., 0] * inv_z * inv_z], -1),
        torch.stack([o, fy * inv_z, -fy * x_cam[..., 1] * inv_z * inv_z], -1),
    ], -2)
    return d * inv_sigma[..., None, None]


def residuals_and_jacobians(problem, R, t, points, robust=True):
    """(r [N,2], Jc [N,2,6], Jp [N,2,3], w [N]); Jc columns [dphi, dt], all
    whitened and masked (cheirality z <= 1e-6 gets weight 0)."""
    Rc = R[problem.cam_idx]
    tc = t[problem.cam_idx]
    X = points[problem.pt_idx]
    RX = (Rc @ X[..., None])[..., 0]
    x_cam = RX + tc
    z = x_cam[..., 2]
    inv_z = 1.0 / _safe_z(z)
    K4 = problem.K4
    u = K4[0] * x_cam[..., 0] * inv_z + K4[2]
    v = K4[1] * x_cam[..., 1] * inv_z + K4[3]
    inv_sigma = _rsqrt(problem.sigma2)
    r = torch.stack([u - problem.uv[..., 0], v - problem.uv[..., 1]], -1)
    r = r * inv_sigma[..., None]

    duv = _duv_dx(K4, x_cam, inv_z, inv_sigma)
    Jc = torch.cat([duv @ _neg_skew(RX), duv], -1)
    Jp = duv @ Rc

    mask = problem.valid & (z > 1e-6)
    w = mask.to(r.dtype)
    if robust:
        w = w * huber_weights(r)
    sw = torch.sqrt(w)[..., None]
    r = r * sw
    Jc = Jc * sw[..., None]
    Jp = Jp * sw[..., None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    Jc = torch.where(problem.cam_fixed[problem.cam_idx][:, None, None], zero, Jc)
    Jp = torch.where(problem.pt_fixed[problem.pt_idx][:, None, None], zero, Jp)
    r = torch.where(mask[..., None], r, zero)
    return r, Jc, Jp, w


def chi2_errors(problem, R, t, points):
    """Per-observation chi2 = |r|^2 and depths."""
    r, z = reprojection_residuals(problem, R, t, points)
    return torch.sum(r * r, -1), z


def prune_outliers(problem, R, t, points, chi2_max=CHI2_2D):
    """Post-solve validity mask: chi2 gate + cheirality, cameras as (R, t)."""
    chi2, z = chi2_errors(problem, R, t, points)
    return problem.valid & (chi2 <= chi2_max) & (z > 0)


def prune_outliers_cams(problem, cams_rt6, points, chi2_max=CHI2_2D):
    """`prune_outliers` taking axis-angle cameras [K, 6]."""
    R, t = cams_to_Rt(cams_rt6)
    return prune_outliers(problem, R, t, points, chi2_max)
