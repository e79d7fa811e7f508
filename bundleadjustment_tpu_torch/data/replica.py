"""Replica RGB-D sequence loader (room0 et al.).

Reproduces the reference's `loadReplica`
(`ba_project/src/data/VirtualSensor.h:49-131`):
- 1200x680, fx = fy = 600.0, c = (599.5, 339.5), depth scale 6553.5
  (`VirtualSensor.h:100-116`);
- frames `results/frame%06d.jpg` + `results/depth%06d.png`;
- `traj.txt`: one row-major 4x4 camera->world matrix per line.

Copied from `bundleadjustment_tpu/data/replica.py` (numpy only), with its
imports pointed at this package, so that the port runs where the JAX
package is absent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

from bundleadjustment_tpu_torch.data.tum import MINF, FrameData

REPLICA_K4 = np.array([600.0, 600.0, 599.5, 339.5], np.float32)
REPLICA_DEPTH_SCALE = 6553.5


@dataclass
class ReplicaDataset:
    root: str
    K4: np.ndarray = field(default_factory=lambda: REPLICA_K4.copy())
    depth_scale: float = REPLICA_DEPTH_SCALE
    width: int = 1200
    height: int = 680
    max_frames: int | None = None
    frame_stride: int = 1

    def __post_init__(self):
        res = os.path.join(self.root, "results")
        self._dir = res if os.path.isdir(res) else self.root
        frames = sorted(
            f for f in os.listdir(self._dir) if f.startswith("frame") and f.endswith(".jpg")
        )
        self._ids = [int(f[5:11]) for f in frames][:: self.frame_stride]
        traj_path = os.path.join(self.root, "traj.txt")
        self._traj = None
        if os.path.exists(traj_path):
            rows = np.loadtxt(traj_path)
            self._traj = rows.reshape(-1, 4, 4)
        if self.max_frames:
            self._ids = self._ids[: self.max_frames]

    def __len__(self):
        return len(self._ids)

    def __getitem__(self, idx) -> FrameData:
        fid = self._ids[idx]
        rgb = np.asarray(
            Image.open(os.path.join(self._dir, f"frame{fid:06d}.jpg")).convert("RGB"),
            np.uint8,
        )
        gray = (rgb @ np.array([0.299, 0.587, 0.114], np.float32)) / 255.0
        d16 = np.asarray(
            Image.open(os.path.join(self._dir, f"depth{fid:06d}.png")), np.float64
        )
        depth = (d16 / self.depth_scale).astype(np.float32)
        depth[d16 == 0] = MINF
        gt = self._traj[fid] if self._traj is not None else None
        # timestamps: Replica has none; frame index at 30 Hz
        return FrameData(idx, fid / 30.0, gray.astype(np.float32), depth, rgb, gt)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
