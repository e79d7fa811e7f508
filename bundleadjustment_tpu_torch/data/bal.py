"""BAL problems: the text files of "Bundle Adjustment in the Large" (Agarwal,
Snavely, Seitz, Szeliski, ECCV 2010; grail.cs.washington.edu/projects/bal),
read and written.

The format: a header `n_cameras n_points n_observations`; one line
`camera point x y` an observation, x and y in pixels about the principal
point; then the nine values of each camera (axis-angle w, translation t,
focal f, radial k1, k2) and the three of each point, one value a line.
`BALData` holds a file's numbers in float64, and `dense_problem` hands them
to the dense solve (`solvers/dense_ba.densify_problem(...,
camera_model="bal")`, then `dense_ba_solve`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BALData:
    cameras: np.ndarray  # [K, 9] (w, t, f, k1, k2)
    points: np.ndarray  # [L, 3]
    cam_idx: np.ndarray  # [N] int32
    pt_idx: np.ndarray  # [N] int32
    uv: np.ndarray  # [N, 2] pixels about the principal point


def read_bal(path):
    """A BAL text file -> BALData."""
    with open(path) as f:
        n_cams, n_pts, n_obs = (int(x) for x in f.readline().split())
        vals = np.array(f.read().split(), dtype=np.float64)
    need = 4 * n_obs + 9 * n_cams + 3 * n_pts
    if vals.size != need:
        raise ValueError(f"{path}: {vals.size} values after the header, {need} expected")
    obs = vals[:4 * n_obs].reshape(n_obs, 4)
    rest = vals[4 * n_obs:]
    return BALData(cameras=rest[:9 * n_cams].reshape(n_cams, 9),
                   points=rest[9 * n_cams:].reshape(n_pts, 3),
                   cam_idx=obs[:, 0].astype(np.int32), pt_idx=obs[:, 1].astype(np.int32),
                   uv=obs[:, 2:].copy())


def write_bal(path, data):
    """BALData -> a BAL text file; numbers at 17 significant digits, so that
    `read_bal` gives them back exactly."""
    K, L, N = len(data.cameras), len(data.points), len(data.cam_idx)
    with open(path, "w") as f:
        f.write(f"{K} {L} {N}\n")
        for c, p, (x, y) in zip(data.cam_idx, data.pt_idx, np.asarray(data.uv, np.float64)):
            f.write(f"{int(c)} {int(p)} {x:.17g} {y:.17g}\n")
        for v in np.concatenate([np.asarray(data.cameras, np.float64).ravel(),
                                 np.asarray(data.points, np.float64).ravel()]):
            f.write(f"{v:.17g}\n")


def dense_problem(data, cam_fixed=None, sigma2=None, max_obs=64, device="cuda"):
    """The dense solve's problem of `data`, and its start: (DenseBAProblem,
    cameras [K, 9], points [L, 3] as float32 tensors on `device`,
    n_dropped). `cam_fixed` [K] bool (default: camera 0 fixed), `sigma2` [N]
    pixel variances (default 1); observations past `max_obs` a point are
    dropped (64 is the most the exact one-device route takes)."""
    import torch

    from bundleadjustment_tpu_torch.device import resolve_device
    from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem

    K, L, N = len(data.cameras), len(data.points), len(data.cam_idx)
    if cam_fixed is None:
        cam_fixed = np.arange(K) == 0
    if sigma2 is None:
        sigma2 = np.ones(N, np.float32)
    prob, dropped = densify_problem(
        None, data.cam_idx, data.pt_idx, np.asarray(data.uv, np.float32),
        np.asarray(sigma2, np.float32), np.ones(N, bool), cam_fixed, L,
        max_obs=max_obs, device=device, camera_model="bal")
    dev = resolve_device(device)
    cams = torch.from_numpy(np.asarray(data.cameras, np.float32)).to(dev)
    pts = torch.from_numpy(np.asarray(data.points, np.float32)).to(dev)
    return prob, cams, pts, dropped
