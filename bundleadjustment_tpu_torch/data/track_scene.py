"""A synthetic BA problem with long landmark tracks: the shape of a global
BA over a map that a SLAM run built, where a tail of landmarks is seen by
every keyframe.

`make_synthetic_scene` (data/synthetic.py) places cameras on a wide arc, so
a landmark is seen by a handful of them and O stays small. The map-derived
global BA of the records (`BASELINE.md:681-685`: 71 keyframes, 10,842
landmarks, 156,774 observations, up to 71 observations per landmark, so
O = 72 after densify) has a long tail instead. This generator reproduces
that shape: cameras in a small cluster all see the whole landmark box;
`n_all` landmarks are observed by every camera and the others by a
contiguous run of cameras (a track), with lengths drawn so that the total is
exactly `n_obs`. Numpy only, from a seed, so tests can hand the same scene
to both packages.

The records give only the counts and the longest track. `n_all` (at least
1, for a track of n_cams observations) and the law of the other lengths
(exponential, clipped to 2..n_cams-1) are assumptions; the default
`n_all = 500` has no source. Costs that grow with long tracks (kernel C's
per-landmark pair loop) depend on them, so measure those at several
`n_all`.
"""

from __future__ import annotations

import numpy as np

from bundleadjustment_tpu_torch.data.synthetic import SyntheticScene, _aa_to_R


def make_track_scene(n_cams=71, n_pts=10_842, n_obs=156_774, n_all=500,
                     pixel_noise=0.5, seed=0, width=640, height=480,
                     fx=525.0, fy=525.0):
    """SyntheticScene with `n_cams` cameras, `n_pts` landmarks and exactly
    `n_obs` observations; landmarks 0..n_all-1 are seen by every camera,
    every other landmark by 2 to n_cams - 1 consecutive cameras."""
    rng = np.random.default_rng(seed)
    K = n_cams
    n_rest = n_pts - n_all
    if not (0 <= n_all <= n_pts and 2 * n_rest <= n_obs - n_all * K
            <= (K - 1) * n_rest):
        raise ValueError("n_obs cannot be split into tracks of 2..n_cams-1")
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
                      2, K - 1).astype(np.int64)
    while lengths.sum() != rest:
        diff = rest - int(lengths.sum())
        ok = np.flatnonzero(lengths < K - 1) if diff > 0 else np.flatnonzero(lengths > 2)
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
