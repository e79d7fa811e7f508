"""Live map visualization: background snapshot thread.

Replaces the reference's PCL viewer thread
(`ba_project/src/visualization/Visualizer.cpp`): a daemon thread polls the
SceneMap at a fixed rate and writes PLY snapshots — map points, estimated
cameras (red glyphs), and ground-truth cameras (green) aligned with the
estimated trajectory by the scale ratio of the first two keyframes
(reference `Visualizer.cpp:144-147`).  Headless environments get files
instead of a window; a final snapshot is dumped on close (`:45-49`).

Copied from `bundleadjustment_tpu/vis/live.py` (numpy only: the thread reads
the host map store and makes no torch call)."""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

from bundleadjustment_tpu_torch.geometry import np_se3
from bundleadjustment_tpu_torch.vis.mesh import camera_frustum_glyph, write_ply


class LiveVisualizer:
    def __init__(self, pipeline, out_dir, interval_s=0.5, keep_history=False):
        self.pipe = pipeline
        self.out_dir = out_dir
        self.interval_s = interval_s
        self.keep_history = keep_history
        self._stop = threading.Event()
        self._n = 0
        os.makedirs(out_dir, exist_ok=True)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.snapshot()
            except (ValueError, IndexError, KeyError) as e:
                # map mutating mid-snapshot (shape/index drift): retry next
                # tick, but leave a trace so a persistent failure is visible
                logging.getLogger(__name__).warning(
                    "live snapshot skipped: %s: %s", type(e).__name__, e)

    def _gt_scale_ratio(self):
        """Scale GT trajectory to the estimated one using the first two
        keyframes' baselines (reference Visualizer.cpp:144-147)."""
        m = self.pipe.map
        kfs = m.active_keyframes()
        if len(kfs) < 2:
            return 1.0
        a, b = int(kfs[0]), int(kfs[1])
        est_a = np_se3.rt6_inverse(m.kf_pose[a])[3:]
        est_b = np_se3.rt6_inverse(m.kf_pose[b])[3:]
        gt_a = m.kf_gt[a][:3, 3]
        gt_b = m.kf_gt[b][:3, 3]
        d_gt = np.linalg.norm(gt_b - gt_a)
        if d_gt < 1e-9:
            return 1.0
        return float(np.linalg.norm(est_b - est_a) / d_gt)

    def snapshot(self, path=None):
        m = self.pipe.map
        ids = m.active_points()
        pts = m.pt_pos[ids].copy()
        cols = m.pt_color[ids].copy()
        # landmarks with any outlier observation render red, like the
        # reference viewer's outlier cloud (Visualizer.cpp:79-89,116-121
        # and the final _with_outliers PLY, :38-49)
        bad = m.point_has_outlier_obs(ids)
        cols[bad] = (255, 0, 0)
        verts = [pts]
        colors = [cols]
        ratio = self._gt_scale_ratio()
        for kf in m.active_keyframes():
            kf = int(kf)
            est = np_se3.rt6_to_mat44(np_se3.rt6_inverse(m.kf_pose[kf]))
            v, _, _ = camera_frustum_glyph(est, scale=0.05)
            verts.append(v)
            colors.append(np.tile([255, 0, 0], (len(v), 1)).astype(np.uint8))
            gt = m.kf_gt[kf].copy()
            if np.abs(gt[3, 3] - 1.0) < 1e-9 and np.any(gt[:3, :3]):
                gt[:3, 3] *= ratio
                v2, _, _ = camera_frustum_glyph(gt, scale=0.05)
                verts.append(v2)
                colors.append(np.tile([0, 255, 0], (len(v2), 1)).astype(np.uint8))
        all_v = np.concatenate(verts) if verts else np.zeros((0, 3))
        all_c = np.concatenate(colors) if colors else np.zeros((0, 3), np.uint8)
        if path is None:
            name = f"map_{self._n:05d}.ply" if self.keep_history else "map_live.ply"
            path = os.path.join(self.out_dir, name)
        write_ply(path, all_v, colors=all_c)
        self._n += 1
        return path

    def close(self):
        """Stop the thread and dump the final cloud (Visualizer.cpp:45-49)."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        return self.snapshot(os.path.join(self.out_dir, "map_final.ply"))
