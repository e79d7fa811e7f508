"""Tiny numpy mirror of the rt6 SE(3) helpers for host-side bookkeeping.

The device-side versions live in `bundleadjustment_tpu_torch.geometry.se3`;
the pipeline driver keeps poses in the native map store (float64 numpy) and
only ships them to the device inside BA snapshots, so it needs cheap host
variants.

Copied from `bundleadjustment_tpu/geometry/np_se3.py` (numpy only; only this
docstring differs), so that the port runs where the JAX package is absent.
"""

from __future__ import annotations

import numpy as np


def aa_to_R(r):
    r = np.asarray(r, np.float64)
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def R_to_aa(R):
    R = np.asarray(R, np.float64)
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-10:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if np.pi - theta < 1e-6:
        # near pi: axis from R + I
        A = (R + np.eye(3)) / 2
        axis = np.sqrt(np.clip(np.diag(A), 0, 1))
        # fix signs using off-diagonals
        if axis[0] > 0:
            axis[1] = np.sign(A[0, 1]) * abs(axis[1])
            axis[2] = np.sign(A[0, 2]) * abs(axis[2])
        elif axis[1] > 0:
            axis[2] = np.sign(A[1, 2]) * abs(axis[2])
        return axis / max(np.linalg.norm(axis), 1e-12) * theta
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * theta / (2 * np.sin(theta))


def rt6_to_mat44(rt):
    M = np.eye(4)
    M[:3, :3] = aa_to_R(rt[:3])
    M[:3, 3] = rt[3:]
    return M


def mat44_to_rt6(M):
    return np.concatenate([R_to_aa(M[:3, :3]), M[:3, 3]])


def rt6_inverse(rt):
    R = aa_to_R(rt[:3])
    return np.concatenate([R_to_aa(R.T), -R.T @ rt[3:]])


def rt6_compose(a, b):
    """Apply b first, then a."""
    Ra, Rb = aa_to_R(a[:3]), aa_to_R(b[:3])
    return np.concatenate([R_to_aa(Ra @ Rb), Ra @ b[3:] + a[3:]])


def rt6_apply(rt, x):
    return np.asarray(x) @ aa_to_R(rt[:3]).T + rt[3:]
