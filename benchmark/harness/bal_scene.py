"""The BAL map of the global-BA cells with BAL's camera, made on the host
from a seed. The tests of the repository draw their BAL problems here too.

The scene: cameras on a ring around a built area, each facing a landmark
cloud (a vertical cylinder about the origin) from the distance at which the
cloud spans `fill` of its image's width at its own focal length; each
camera with its own f, k1 and k2; Snavely's projection (BAL's camera looks
down -z) plus pixel noise, in pixels about the principal point.

A landmark's track is drawn from the ring's neighbourhood of a random
camera: its cameras are distinct ring positions within `track_arc` of it,
so that a landmark is seen from one side of the area, as a photo
collection sees a facade. A track is drawn again (cameras and landmark)
until the rays of its two outermost cameras meet at MIN_RAY_DEG or more,
as a structure-from-motion pipeline keeps a point only where its rays meet
at an angle (Bundler's ray-angle threshold, COLMAP's least triangulation
angle), and until the landmark lies in front of every camera of its track
and inside its image. The cameras' indices are a random permutation of
their ring order: a BAL file numbers its photos in the order the pipeline
added them, not by where they stand.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_RAY_DEG = 2.0  # Bundler's ray-angle threshold


@dataclass
class BALData:
    cameras: np.ndarray  # [K, 9] (w, t, f, k1, k2)
    points: np.ndarray  # [L, 3]
    cam_idx: np.ndarray  # [N] int32
    pt_idx: np.ndarray  # [N] int32
    uv: np.ndarray  # [N, 2] pixels about the principal point


def _rotation_to_aa(R):
    """[3, 3] -> axis-angle [3], for angles below pi."""
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    s = np.linalg.norm(v)
    th = np.arctan2(s, cos)
    return v * (th / s if s > 1e-12 else 1.0)


def _aa_to_rotation(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def project_np(cameras, points):
    """Snavely's projection in numpy, float64: (uv [N, 2], depth -P_z [N])
    of points [N, 3] in cameras [N, 9]."""
    w = cameras[:, :3]
    th = np.linalg.norm(w, axis=1, keepdims=True)
    k = w / np.maximum(th, 1e-300)
    c, s = np.cos(th), np.sin(th)
    P = (points * c + np.cross(k, points) * s
         + k * (k * points).sum(1, keepdims=True) * (1 - c)) + cameras[:, 3:6]
    p = -P[:, :2] / P[:, 2:3]
    n2 = (p * p).sum(1, keepdims=True)
    r = 1.0 + cameras[:, 7:8] * n2 + cameras[:, 8:9] * n2 * n2
    return cameras[:, 6:7] * r * p, -P[:, 2]


def make_bal_scene(n_cams, n_pts, n_obs, max_track=64, width=1600, height=1200,
                   f_range=(1000.0, 2000.0), k1_abs=(0.05, 0.2), k2_abs=(0.02, 0.08),
                   radius=10.0, half_height=3.0, fill=0.75, pixel_noise=0.5,
                   track_arc=32, seed=0):
    """(BALData with noisy observations, ground truth BALData): `n_cams`
    cameras, `n_pts` landmarks, exactly `n_obs` observations.

    Landmarks lie in a vertical cylinder (`radius`, `half_height`) about the
    origin; cameras stand on a ring around it, each facing the origin with
    0.01 rad of jitter, at the distance where the cylinder spans `fill` of
    its image's width at its focal length f (uniform in `f_range`); k1 and
    k2 have random signs and magnitudes uniform in `k1_abs`, `k2_abs`.
    Track lengths are exponential about the mean n_obs / n_pts, clipped to
    2..max_track and nudged to the exact total; a track's cameras are
    distinct ring positions within `track_arc` positions of a random one
    (all cameras where the ring is shorter), drawn again with the landmark
    until the module docstring's conditions hold (MIN_RAY_DEG between the
    rays of its outermost ring positions). Camera indices are a random
    permutation of ring order. uv = Snavely's projection + N(0,
    pixel_noise) noise, about the principal point."""
    rng = np.random.default_rng(seed)
    K = n_cams
    arc = min(2 * track_arc + 1, K)  # ring positions a track draws from
    if not (2 <= max_track <= arc and 2 * n_pts <= n_obs <= max_track * n_pts):
        raise ValueError(f"{n_obs} observations cannot be split into {n_pts} tracks "
                         f"of 2..{max_track} cameras of {arc}")
    ring = np.zeros((K, 9))
    phi = 2 * np.pi * (np.arange(K) + rng.uniform(-0.3, 0.3, K)) / K
    f = rng.uniform(*f_range, K)
    tan_half = fill * (width / 2) / f
    dist = radius * np.sqrt(1.0 + 1.0 / tan_half ** 2)
    up = np.array([0.0, 1.0, 0.0])
    centres = np.zeros((K, 3))
    for k in range(K):
        C = np.array([dist[k] * np.sin(phi[k]), rng.uniform(-0.5, 0.5), dist[k] * np.cos(phi[k])])
        zc = C / np.linalg.norm(C)  # the camera looks down -z, at the origin
        xc = np.cross(up, zc)
        xc /= np.linalg.norm(xc)
        R = _aa_to_rotation(rng.normal(0, 0.01, 3)) @ np.stack([xc, np.cross(zc, xc), zc])
        ring[k, :3] = _rotation_to_aa(R)
        ring[k, 3:6] = -R @ C
        centres[k] = C
    ring[:, 6] = f
    ring[:, 7] = rng.choice([-1.0, 1.0], K) * rng.uniform(*k1_abs, K)
    ring[:, 8] = rng.choice([-1.0, 1.0], K) * rng.uniform(*k2_abs, K)

    lengths = np.clip(np.rint(rng.exponential(n_obs / n_pts - 2, n_pts)) + 2,
                      2, max_track).astype(np.int64)
    while lengths.sum() != n_obs:
        diff = n_obs - int(lengths.sum())
        ok = np.flatnonzero(lengths < max_track) if diff > 0 else np.flatnonzero(lengths > 2)
        pick = rng.choice(ok, min(abs(diff), len(ok)), replace=False)
        lengths[pick] += np.sign(diff)
    pt_idx = np.repeat(np.arange(n_pts), lengths)
    first = np.cumsum(lengths) - lengths
    run = np.arange(len(pt_idx)) - np.repeat(first, lengths)
    pos = np.zeros(len(pt_idx), np.int64)  # ring position of each observation

    def draw(n):
        r = radius * np.sqrt(rng.uniform(0, 1, n))
        a = rng.uniform(0, 2 * np.pi, n)
        return np.stack([r * np.cos(a), rng.uniform(-half_height, half_height, n),
                         r * np.sin(a)], -1)

    cos_min = np.cos(np.radians(MIN_RAY_DEG))
    points = np.zeros((n_pts, 3))
    redraw = np.arange(n_pts)
    for _ in range(200):
        sel = np.isin(pt_idx, redraw)
        # each redrawn track: a centre, and the first `length` of a random
        # order of the arc's positions about it
        order = rng.random((len(redraw), arc)).argsort(1)
        centre = rng.integers(0, K, len(redraw))
        row = np.searchsorted(redraw, pt_idx[sel])
        pos[sel] = (centre[row] + order[row, run[sel]] - arc // 2) % K
        points[redraw] = draw(len(redraw))
        uv, depth = project_np(ring[pos[sel]], points[pt_idx[sel]])
        bad_obs = ((depth <= 1e-6) | (np.abs(uv[:, 0]) >= width / 2)
                   | (np.abs(uv[:, 1]) >= height / 2))
        # the rays of the track's outermost ring positions
        off, starts = order[row, run[sel]], np.searchsorted(pt_idx[sel], redraw)
        X = points[redraw]
        a = X - centres[(centre + np.minimum.reduceat(off, starts) - arc // 2) % K]
        b = X - centres[(centre + np.maximum.reduceat(off, starts) - arc // 2) % K]
        cos_ab = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        redraw = np.union1d(np.unique(pt_idx[sel][bad_obs]), redraw[cos_ab > cos_min])
        if not len(redraw):
            break
    else:
        raise ValueError("landmarks keep failing their tracks' conditions")
    perm = rng.permutation(K)  # ring position -> camera index
    cams = np.zeros_like(ring)
    cams[perm] = ring
    cam_idx = perm[pos]
    uv, _ = project_np(cams[cam_idx], points[pt_idx])
    noisy = uv + rng.normal(0, pixel_noise, uv.shape)
    ci, pi = cam_idx.astype(np.int32), pt_idx.astype(np.int32)
    return (BALData(cams.copy(), points.copy(), ci, pi, noisy),
            BALData(cams, points, ci, pi, uv))
