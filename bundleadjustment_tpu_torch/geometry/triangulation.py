"""Batched two-view DLT triangulation with the SfM acceptance gates.

Port of `bundleadjustment_tpu/geometry/triangulation.py`: cheirality in both
views, per-view chi2 reprojection gates (5.991), and the distance-ratio scale
consistency gate. Batched over N candidate matches (and any leading batch
dims of the second view); returns masks instead of erasing. Also the median
scene depth of a camera (`median_scene_depth`).
"""

from __future__ import annotations

import torch

from bundleadjustment_tpu_torch.geometry.projection import intrinsics_matrix, project
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat

CHI2_2D = 5.991


def projection_matrix(K4, rt_extr):
    """[...,4], [...,6] -> [...,3,4]  P = K [R|t]."""
    K = intrinsics_matrix(K4)
    R = aa_to_rotmat(rt_extr[..., :3])
    Rt = torch.cat([R, rt_extr[..., 3:, None]], -1)
    return K @ Rt


def triangulate_dlt(P1, P2, uv1, uv2):
    """Homogeneous DLT: P1, P2 [..., 3, 4]; uv1, uv2 [..., N, 2] -> [..., N, 3]
    from the smallest right singular vector of the 4x4 system."""
    P1 = P1[..., None, :, :].expand(uv1.shape[:-1] + (3, 4))
    P2 = P2[..., None, :, :].expand(uv2.shape[:-1] + (3, 4))
    rows = torch.stack([
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], -2)
    _, _, vt = torch.linalg.svd(rows)
    Xh = vt[..., 3, :]
    w = Xh[..., 3]
    tiny = torch.where(w < 0, -1e-12, 1e-12) * torch.ones_like(w)
    w = torch.where(torch.abs(w) < 1e-12, tiny, w)
    return Xh[..., :3] / w[..., None]


def triangulate_gated(K4, extr1, extr2, uv1, uv2, sigma2_1, sigma2_2, valid,
                      chi2_max=CHI2_2D):
    """Triangulate matches and compute the acceptance mask.

    K4 [4]; extr1 [6] (shared); extr2 [..., 6]; uv1, uv2 [..., N, 2];
    sigma2_* [..., N]; valid [..., N] bool. Returns (points [..., N, 3],
    ok [..., N]) with rejected points zeroed.
    """
    P1 = projection_matrix(K4, extr1)
    P2 = projection_matrix(K4, extr2)
    X = triangulate_dlt(P1, P2, uv1, uv2)

    R1 = aa_to_rotmat(extr1[..., :3])
    R2 = aa_to_rotmat(extr2[..., :3])
    xc1 = X @ R1.transpose(-1, -2) + extr1[..., None, 3:]
    xc2 = X @ R2.transpose(-1, -2) + extr2[..., None, 3:]
    uv1p, z1 = project(K4, xc1)
    uv2p, z2 = project(K4, xc2)

    finite = torch.all(torch.isfinite(X), dim=-1)
    cheir = (z1 > 0) & (z2 > 0)
    e1 = torch.sum((uv1p - uv1) ** 2, -1) / torch.clamp(sigma2_1, min=1e-12)
    e2 = torch.sum((uv2p - uv2) ** 2, -1) / torch.clamp(sigma2_2, min=1e-12)
    reproj_ok = (e1 < chi2_max) & (e2 < chi2_max)

    d1 = torch.linalg.norm(xc1, dim=-1)
    d2 = torch.linalg.norm(xc2, dim=-1)
    ratio = d1 / torch.clamp(d2, min=1e-12)
    sigma_ratio = torch.sqrt(torch.clamp(sigma2_1, min=1e-12)
                             / torch.clamp(sigma2_2, min=1e-12))
    factor = 1.5 * sigma_ratio
    scale_ok = (ratio < factor) & (ratio > 1.0 / torch.clamp(factor, min=1e-12))

    ok = valid & finite & cheir & reproj_ok & scale_ok
    X = torch.where(ok[..., None], X, torch.zeros_like(X))
    return X, ok


def median_scene_depth(extr, points, valid):
    """Median depth of the valid points [N, 3] in the camera `extr` [6]
    (world -> camera); the lower median for an even count, +inf with no
    valid point."""
    R = aa_to_rotmat(extr[:3])
    z = points @ R[2, :] + extr[5]
    zs = torch.sort(torch.where(valid, z, torch.full_like(z, float("inf")))).values
    n = int(valid.sum())
    return zs[(n - 1) // 2] if n else zs.new_tensor(float("inf"))
