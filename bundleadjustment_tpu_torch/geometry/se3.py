"""SO(3)/SE(3) utilities on axis-angle ("rt6") tensors.

Port of `bundleadjustment_tpu/geometry/se3.py`. An rt6 is `[rvec(3), tvec(3)]`
encoding `x -> R(rvec) @ x + tvec`. Every function broadcasts over leading
batch dimensions.
"""

from __future__ import annotations

import torch

from bundleadjustment_tpu_torch.device import resolve_device

_EPS = 1e-8


def skew(w):
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def aa_to_rotmat(rvec):
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Rodrigues, with the
    reference's eps-guarded theta so rvec = 0 is exact identity)."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (theta * theta)
    K = skew(rvec)
    KK = K @ K
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def rotmat_to_aa(R):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3] (log map with the
    reference's near-pi and tiny-angle branches)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    sin_t = torch.sin(theta)
    small = sin_t < 1e-5
    one = torch.ones_like(sin_t)
    scale_generic = theta / torch.where(small, one, 2.0 * sin_t)
    aa_generic = v * scale_generic[..., None]
    denom = torch.where(torch.abs(1.0 - cos_t) < 1e-9, one, 1.0 - cos_t)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis2 = torch.clamp((diag - cos_t[..., None]) / denom[..., None], 0.0, 1.0)
    axis_abs = torch.sqrt(axis2)
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    syz = R[..., 1, 2] + R[..., 2, 1]
    ax, ay, az = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    x_major = (ax >= ay) & (ax >= az)
    y_major = (~x_major) & (ay >= az)
    sign = torch.sign
    axis_pi = torch.where(
        x_major[..., None],
        torch.stack([ax, sign(sxy) * ay, sign(sxz) * az], -1),
        torch.where(
            y_major[..., None],
            torch.stack([sign(sxy) * ax, ay, sign(syz) * az], -1),
            torch.stack([sign(sxz) * ax, sign(syz) * ay, az], -1),
        ),
    )
    aa_pi = axis_pi * theta[..., None]
    near_pi = cos_t < -1.0 + 1e-5
    aa_tiny = 0.5 * v
    tiny = theta < 1e-6
    return torch.where(tiny[..., None], aa_tiny,
                       torch.where(near_pi[..., None], aa_pi, aa_generic))


def rt6_identity(dtype=torch.float32, device="cuda"):
    """The identity transform, zeros [6], on `device`."""
    return torch.zeros(6, dtype=dtype, device=resolve_device(device))


def rt6_apply(rt, x):
    """Apply transform: [..., 6], [..., 3] -> [..., 3]."""
    R = aa_to_rotmat(rt[..., :3])
    return (R @ x[..., None])[..., 0] + rt[..., 3:]


def rt6_inverse(rt):
    """Inverse transform: R^T, -R^T t."""
    R = aa_to_rotmat(rt[..., :3])
    Rt = R.transpose(-1, -2)
    return torch.cat([rotmat_to_aa(Rt), -(Rt @ rt[..., 3:, None])[..., 0]], -1)


def rt6_compose(a, b):
    """Compose: result applies b first then a."""
    Ra = aa_to_rotmat(a[..., :3])
    Rb = aa_to_rotmat(b[..., :3])
    t = (Ra @ b[..., 3:, None])[..., 0] + a[..., 3:]
    return torch.cat([rotmat_to_aa(Ra @ Rb), t], -1)


def rt6_to_mat44(rt):
    """[..., 6] -> [..., 4, 4] homogeneous matrix."""
    M = torch.zeros(rt.shape[:-1] + (4, 4), dtype=rt.dtype, device=rt.device)
    M[..., :3, :3] = aa_to_rotmat(rt[..., :3])
    M[..., :3, 3] = rt[..., 3:]
    M[..., 3, 3] = 1.0
    return M


def rt6_from_mat44(M):
    """[..., 4, 4] -> [..., 6]."""
    return torch.cat([rotmat_to_aa(M[..., :3, :3]), M[..., :3, 3]], -1)
