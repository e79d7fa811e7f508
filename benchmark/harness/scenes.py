"""The keyframe maps of the global-BA cells, made on the host from a seed.

A frozen copy of `bundleadjustment_tpu_torch/data/track_scene.py`
(`make_track_scene`) and of the helpers it takes from `data/synthetic.py`
(`_aa_to_R`, `SyntheticScene`). The benchmark keeps its own copy so that a
change to the program's generator cannot change the work the benchmark
measures; `benchmark/tests/test_frozen_parity.py` holds the copy to the
original. One addition: `max_track`, the longest track of a landmark that
is not seen by every camera (the original clips at n_cams - 1, which is
what `max_track=None` gives).

The scene: `n_cams` cameras on a 2 m x 1 m patch facing +z, landmarks in a
box 4-8 m in front, so every landmark projects into every image; `n_all`
landmarks are observed by every camera and the others by a contiguous run
of cameras (a track, in camera order modulo n_cams), with lengths drawn
from a clipped exponential and nudged so that the total is exactly `n_obs`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _aa_to_R(r):
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


@dataclass
class SyntheticScene:
    K4: np.ndarray  # [4] fx fy cx cy
    extr_gt: np.ndarray  # [K, 6] world->camera ground truth
    points_gt: np.ndarray  # [L, 3]
    cam_idx: np.ndarray  # [N] int32
    pt_idx: np.ndarray  # [N] int32
    uv: np.ndarray  # [N, 2] noisy pixel observations
    sigma2: np.ndarray  # [N]
    valid: np.ndarray  # [N] bool
    extr_init: np.ndarray  # [K, 6] perturbed initialization
    points_init: np.ndarray  # [L, 3]
    is_outlier: np.ndarray  # [N] bool (GT corruption labels)
    width: int = 640
    height: int = 480


def make_track_scene(n_cams=71, n_pts=10_842, n_obs=156_774, n_all=500,
                     pixel_noise=0.5, seed=0, width=640, height=480,
                     fx=525.0, fy=525.0, max_track=None):
    """SyntheticScene with `n_cams` cameras, `n_pts` landmarks and exactly
    `n_obs` observations; landmarks 0..n_all-1 are seen by every camera,
    every other landmark by 2 to `max_track` (default n_cams - 1)
    consecutive cameras."""
    rng = np.random.default_rng(seed)
    K = n_cams
    hi = K - 1 if max_track is None else max_track
    n_rest = n_pts - n_all
    if not (0 <= n_all <= n_pts and 2 <= hi <= K - 1
            and 2 * n_rest <= n_obs - n_all * K <= hi * n_rest):
        raise ValueError(f"n_obs cannot be split into tracks of 2..{hi}")
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    K4 = np.array([fx, fy, cx, cy], np.float32)
    points = rng.uniform([-1.2, -0.9, 4.0], [1.2, 0.9, 8.0], size=(n_pts, 3))

    # cameras on a 2 m x 1 m patch facing +z: every landmark projects into
    # every image (half-field 0.61 rad at fx = 525, width 640)
    extr = np.zeros((K, 6))
    for k in range(K):
        rvec = rng.normal(0, 0.02, 3)
        center = np.array([rng.uniform(-1.0, 1.0), rng.uniform(-0.5, 0.5), 0.0])
        extr[k, :3] = rvec
        extr[k, 3:] = -_aa_to_R(rvec) @ center

    # track lengths: mean fixed by n_obs, then nudged to the exact total
    rest = n_obs - n_all * K
    lengths = np.clip(np.rint(rng.exponential(rest / max(n_rest, 1) - 2, n_rest)) + 2,
                      2, hi).astype(np.int64)
    while lengths.sum() != rest:
        diff = rest - int(lengths.sum())
        ok = np.flatnonzero(lengths < hi) if diff > 0 else np.flatnonzero(lengths > 2)
        pick = rng.choice(ok, min(abs(diff), len(ok)), replace=False)
        lengths[pick] += np.sign(diff)
    lengths = np.concatenate([np.full(n_all, K, np.int64), lengths])
    starts = rng.integers(0, K, n_pts)
    pt_idx = np.repeat(np.arange(n_pts), lengths)
    run = np.arange(len(pt_idx)) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    cam_idx = (np.repeat(starts, lengths) + run) % K

    R = np.stack([_aa_to_R(e[:3]) for e in extr])
    xc = np.einsum("nij,nj->ni", R[cam_idx], points[pt_idx]) + extr[cam_idx, 3:]
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], -1)
    uv += rng.normal(0, pixel_noise, size=uv.shape)

    extr_init = extr.copy()
    extr_init[1:, :3] += rng.normal(0, 0.02, size=(K - 1, 3))
    extr_init[1:, 3:] += rng.normal(0, 0.05, size=(K - 1, 3))
    points_init = points + rng.normal(0, 0.05, size=points.shape)
    n = len(cam_idx)
    return SyntheticScene(
        K4=K4, extr_gt=extr.astype(np.float32),
        points_gt=points.astype(np.float32),
        cam_idx=cam_idx.astype(np.int32), pt_idx=pt_idx.astype(np.int32),
        uv=uv.astype(np.float32), sigma2=np.ones(n, np.float32),
        valid=np.ones(n, bool), extr_init=extr_init.astype(np.float32),
        points_init=points_init.astype(np.float32),
        is_outlier=np.zeros(n, bool), width=width, height=height)
