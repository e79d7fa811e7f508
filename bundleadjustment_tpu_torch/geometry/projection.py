"""Pinhole projection / back-projection on tensors.

Port of `bundleadjustment_tpu/geometry/projection.py`. Intrinsics are packed
as `[fx, fy, cx, cy]`; extrinsics map world -> camera.
"""

from __future__ import annotations

import torch

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat


def make_intrinsics(fx, fy, cx, cy, dtype=torch.float32, device="cuda"):
    """The packed intrinsics [fx, fy, cx, cy] as a tensor on `device`."""
    return torch.tensor([fx, fy, cx, cy], dtype=dtype, device=resolve_device(device))


def intrinsics_matrix(K4):
    """[..., 4] -> [..., 3, 3]."""
    fx, fy, cx, cy = K4[..., 0], K4[..., 1], K4[..., 2], K4[..., 3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, z, cx], -1),
        torch.stack([z, fy, cy], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def project(K4, x_cam, eps=1e-9):
    """Camera-frame points [..., 3] -> (uv [..., 2], z [...]); z <= 0 still
    gives finite uv (guarded divide), callers gate on z."""
    z = x_cam[..., 2]
    zs = torch.where(torch.abs(z) < eps,
                     torch.where(z < 0, -eps, eps) * torch.ones_like(z), z)
    u = K4[..., 0] * x_cam[..., 0] / zs + K4[..., 2]
    v = K4[..., 1] * x_cam[..., 1] / zs + K4[..., 3]
    return torch.stack([u, v], -1), z


def project_rt(K4, rt_extr, x_world):
    """Project world points through an rt6 extrinsic. Returns (uv, depth)."""
    R = aa_to_rotmat(rt_extr[..., :3])
    x_cam = (R @ x_world[..., None])[..., 0] + rt_extr[..., 3:]
    return project(K4, x_cam)


def backproject(K4, uv, depth):
    """Pixel + depth -> camera-frame point. [...,4],[...,2],[...] -> [...,3]."""
    x = (uv[..., 0] - K4[..., 2]) / K4[..., 0] * depth
    y = (uv[..., 1] - K4[..., 3]) / K4[..., 1] * depth
    return torch.stack([x, y, depth], -1)


def pixel_grid(height, width, dtype=torch.float32, device="cuda"):
    """[H, W, 2] grid of (u, v) pixel coordinates on `device`."""
    device = resolve_device(device)
    v, u = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                          torch.arange(width, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([u, v], -1)


def project_bal(cams9, x_world):
    """Snavely's projection of BAL's camera (Agarwal et al., ECCV 2010):
    cameras [..., 9] = (axis-angle w, t, f, k1, k2), world points [..., 3]
    -> (uv [..., 2] in pixels about the principal point, depth [...]).
    P = R(w) X + t; the camera looks down -z, so p = -P_xy / P_z and the
    depth is -P_z; uv = f (1 + k1 |p|^2 + k2 |p|^4) p."""
    R = aa_to_rotmat(cams9[..., :3])
    P = (R @ x_world[..., None])[..., 0] + cams9[..., 3:6]
    p = -P[..., :2] / P[..., 2:3]
    n2 = (p * p).sum(-1, keepdim=True)
    r = 1.0 + cams9[..., 7:8] * n2 + cams9[..., 8:9] * n2 * n2
    return cams9[..., 6:7] * r * p, -P[..., 2]
