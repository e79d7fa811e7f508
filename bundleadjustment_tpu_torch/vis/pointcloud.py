"""Depth-map back-projection and finite-difference normals on the device.

Port of `bundleadjustment_tpu/vis/pointcloud.py` (the reference's OpenMP
loops, `ba_project/src/model/PointCloud.h:46-135`): the whole depth map
deprojects in one elementwise expression; normals are the cross product of
the central differences of neighbouring camera-space points, invalid where
any of the four neighbours is invalid and on the one-pixel border (whose
neighbours wrap around through `torch.roll`, as in the source).

Both functions take numpy or tensors and return numpy arrays; `device`
says where the work runs.
"""

from __future__ import annotations

import numpy as np
import torch

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.geometry.projection import backproject, pixel_grid


def _camera_points(K4, depth):
    """[H, W] depth -> (camera-frame points [H, W, 3], valid [H, W])."""
    h, w = depth.shape
    uv = pixel_grid(h, w, depth.dtype, depth.device)
    valid = torch.isfinite(depth) & (depth > 0)
    d = torch.where(valid, depth, torch.ones_like(depth))
    return backproject(K4, uv, d), valid


def _inputs(K4, depth, device):
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(K4, np.float32), device=dev),
            torch.as_tensor(np.asarray(depth, np.float32), device=dev))


def backproject_depth(K4, depth, cam_to_world=None, stride=1, device="cuda"):
    """Depth map -> (points_world [M, 3], valid [M]) flattened with stride."""
    K4, depth = _inputs(K4, depth, device)
    if cam_to_world is None:
        cam_to_world = np.eye(4, dtype=np.float32)
    M = torch.as_tensor(np.asarray(cam_to_world, np.float32), device=depth.device)
    xc, valid = _camera_points(K4, depth)
    xw = xc @ M[:3, :3].T + M[:3, 3]
    xw = xw[::stride, ::stride].reshape(-1, 3)
    valid = valid[::stride, ::stride].reshape(-1)
    return xw.cpu().numpy(), valid.cpu().numpy()


def depth_normals(K4, depth, device="cuda"):
    """[H, W] depth -> (normals [H, W, 3] camera frame, valid [H, W])."""
    K4, depth = _inputs(K4, depth, device)
    xc, valid = _camera_points(K4, depth)
    dx = torch.roll(xc, -1, 1) - torch.roll(xc, 1, 1)
    dy = torch.roll(xc, -1, 0) - torch.roll(xc, 1, 0)
    n = torch.cross(dy, dx, dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    ok = (valid & torch.roll(valid, 1, 0) & torch.roll(valid, -1, 0)
          & torch.roll(valid, 1, 1) & torch.roll(valid, -1, 1))
    # border pixels have wrapped neighbours -> invalid
    ok[0, :] = False
    ok[-1, :] = False
    ok[:, 0] = False
    ok[:, -1] = False
    return n.cpu().numpy(), ok.cpu().numpy()
