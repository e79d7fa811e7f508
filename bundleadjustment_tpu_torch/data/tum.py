"""TUM RGB-D dataset loader (Freiburg fr1/xyz, fr1/teddy, ...).

Reproduces the reference `VirtualSensor` conventions exactly
(`ba_project/src/data/VirtualSensor.h:133-182`):
- 640x480, fx = fy = 525.0, c = (319.5, 239.5) (hardcoded per dataset);
- depth PNG is 16-bit, scale 5000 -> meters; zero depth -> -inf (MINF,
  `VirtualSensor.h:203-209`);
- rgb/depth/groundtruth associated by nearest timestamp within 0.02 s
  (`VirtualSensor.h:211-224`, `src/metrics/associate.py:71-101`);
- ground-truth poses are parsed as TUM camera->world quaternions; the
  reference stores their inverses (`VirtualSensor.h:327-363`, inverse at
  `:356`) — we expose both.

Image decode is host-side (PIL); arrays feed straight into device buffers.

Copied unchanged from `bundleadjustment_tpu/data/tum.py` (numpy only), so
that the port runs where the JAX package is absent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

TUM_K4 = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
TUM_DEPTH_SCALE = 5000.0
MINF = -np.inf


def quat_to_rotmat(qx, qy, qz, qw):
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def rotmat_to_quat(R):
    """Returns (qx, qy, qz, qw)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return qx, qy, qz, qw


def read_file_list(path):
    """Parse 'timestamp data...' lines, skipping # comments (associate.py:50-68)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1:]))
    return out


def associate(a, b, max_difference=0.02, offset=0.0):
    """Greedy mutual nearest-timestamp association (associate.py:71-101).

    Candidate generation is O(N log M) via a searchsorted window over the
    (sorted) b timestamps instead of the reference's all-pairs double loop,
    which at ``--frames 2000`` scale would enumerate millions of pairs.
    Output is identical: same candidate set, same greedy order.
    """
    ta_arr = np.asarray([t for t, _ in a], dtype=np.float64)
    tb_arr = np.asarray([t for t, _ in b], dtype=np.float64) + offset
    order_b = np.argsort(tb_arr, kind="stable")
    tb_sorted = tb_arr[order_b]
    lo = np.searchsorted(tb_sorted, ta_arr - max_difference, side="left")
    hi = np.searchsorted(tb_sorted, ta_arr + max_difference, side="right")
    pairs = []
    for i in range(len(a)):
        for k in range(int(lo[i]), int(hi[i])):
            j = int(order_b[k])
            d = abs(ta_arr[i] - tb_arr[j])
            if d < max_difference:
                pairs.append((d, i, j))
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((i, j))
    out.sort()
    return out


def _nearest_pose(t, gt_ts, gt_poses, max_diff=0.1):
    k = int(np.argmin(np.abs(gt_ts - t)))
    if abs(gt_ts[k] - t) > max_diff:
        return None
    return gt_poses[k]


@dataclass
class FrameData:
    index: int
    timestamp: float
    gray: np.ndarray  # [H, W] float32 in [0, 1]
    depth: np.ndarray  # [H, W] float32 meters, invalid = -inf
    rgb: np.ndarray | None  # [H, W, 3] uint8
    gt_cam_to_world: np.ndarray | None  # [4, 4]


@dataclass
class TUMDataset:
    """Iterable TUM RGB-D sequence."""

    root: str
    K4: np.ndarray = field(default_factory=lambda: TUM_K4.copy())
    depth_scale: float = TUM_DEPTH_SCALE
    width: int = 640
    height: int = 480
    max_frames: int | None = None

    def __post_init__(self):
        rgb = read_file_list(os.path.join(self.root, "rgb.txt"))
        depth = read_file_list(os.path.join(self.root, "depth.txt"))
        gt_path = os.path.join(self.root, "groundtruth.txt")
        self._gt_ts = None
        self._gt_poses = None
        if os.path.exists(gt_path):
            gt = read_file_list(gt_path)
            self._gt_ts = np.array([t for t, _ in gt])
            poses = []
            for _, vals in gt:
                tx, ty, tz, qx, qy, qz, qw = map(float, vals[:7])
                M = np.eye(4)
                M[:3, :3] = quat_to_rotmat(qx, qy, qz, qw)
                M[:3, 3] = [tx, ty, tz]
                poses.append(M)
            self._gt_poses = poses
        pairs = associate(rgb, depth)
        self._frames = [
            (rgb[i][0], os.path.join(self.root, rgb[i][1][0]),
             os.path.join(self.root, depth[j][1][0]))
            for i, j in pairs
        ]
        if self.max_frames:
            self._frames = self._frames[: self.max_frames]

    def __len__(self):
        return len(self._frames)

    def __getitem__(self, idx) -> FrameData:
        ts, rgb_path, depth_path = self._frames[idx]
        rgb = np.asarray(Image.open(rgb_path).convert("RGB"), np.uint8)
        gray = (rgb @ np.array([0.299, 0.587, 0.114], np.float32)) / 255.0
        d16 = np.asarray(Image.open(depth_path), np.float64)
        depth = (d16 / self.depth_scale).astype(np.float32)
        depth[d16 == 0] = MINF
        gt = None
        if self._gt_ts is not None:
            gt = _nearest_pose(ts, self._gt_ts, self._gt_poses)
        return FrameData(idx, ts, gray.astype(np.float32), depth, rgb, gt)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def write_tum_trajectory(path, timestamps, cam_to_world_mats):
    """TUM trajectory writer: 'ts tx ty tz qx qy qz qw' with 4 decimals
    (reference BundleAdjustment.cpp:249-268)."""
    with open(path, "w") as f:
        for ts, M in zip(timestamps, cam_to_world_mats):
            t = M[:3, 3]
            qx, qy, qz, qw = rotmat_to_quat(M[:3, :3])
            f.write(
                f"{ts:.4f} {t[0]:.4f} {t[1]:.4f} {t[2]:.4f} "
                f"{qx:.4f} {qy:.4f} {qz:.4f} {qw:.4f}\n"
            )


def read_tum_trajectory(path):
    """Returns (timestamps [N], cam_to_world [N, 4, 4])."""
    entries = read_file_list(path)
    ts, mats = [], []
    for t, vals in entries:
        tx, ty, tz, qx, qy, qz, qw = map(float, vals[:7])
        M = np.eye(4)
        M[:3, :3] = quat_to_rotmat(qx, qy, qz, qw)
        M[:3, 3] = [tx, ty, tz]
        ts.append(t)
        mats.append(M)
    return np.array(ts), np.array(mats)
