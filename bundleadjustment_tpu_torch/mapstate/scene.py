"""SceneMap — Python facade over the native C++ observation-graph runtime.

The graph topology (insert / observe / fuse / cull / covisibility) lives in
`bundleadjustment_tpu_torch/native/mapstore.cpp`; this layer provides numpy
zero-copy views over the store's SoA arrays and *snapshots* flat, padded
BA problems for the solvers.

Replaces the reference's `SceneMap`/`Frame`/`MapPoint` web
(`ba_project/src/model/`), but with arrays instead of pointers and masks
instead of erase — padding is bucketed (next power of two), as in the JAX
package, so both packages snapshot identical problems.

Copied from `bundleadjustment_tpu/mapstate/scene.py` (numpy only), with its
import pointed at this package's copy of the native store, so that the port
runs where the JAX package is absent.
"""

from __future__ import annotations

import ctypes

import numpy as np

from bundleadjustment_tpu_torch import native

COVIS_THRESHOLD = 10  # reference Frame.cpp:327


def _bucket(n, minimum=64):
    b = minimum
    while b < n:
        b *= 2
    return b


class BASnapshot:
    """A padded bundle-adjustment problem + the book-keeping to write back."""

    def __init__(self, kf_slots, pt_ids, cam_idx, pt_idx, uv, sigma2, valid,
                 cam_fixed, kp_idx, extr, points, K4):
        self.kf_slots = kf_slots  # [K_real] store slots, order = problem cam index
        self.pt_ids = pt_ids  # [L_real] store ids, order = problem pt index
        self.cam_idx = cam_idx  # padded [N]
        self.pt_idx = pt_idx
        self.uv = uv
        self.sigma2 = sigma2
        self.valid = valid
        self.cam_fixed = cam_fixed  # padded [K]
        self.kp_idx = kp_idx  # [N] keypoint index within frame (for outlier writeback)
        self.extr = extr  # padded [K, 6] float32
        self.points = points  # padded [L, 3] float32
        self.K4 = K4

    @property
    def n_cams(self):
        return len(self.kf_slots)

    @property
    def n_pts(self):
        return len(self.pt_ids)


class SceneMap:
    def __init__(self, max_frames=2048, max_points=262144, max_kp=2048,
                 desc_words=8, K4=None):
        self._lib = native.load()
        self._h = self._lib.map_create(max_frames, max_points, max_kp, desc_words)
        self.max_frames = max_frames
        self.max_points = max_points
        self.max_kp = max_kp
        self.desc_words = desc_words
        self.K4 = None if K4 is None else np.asarray(K4, np.float32)

        as_array = np.ctypeslib.as_array
        h = self._h
        self.pt_pos = as_array(self._lib.map_pt_pos_ptr(h), (max_points, 3))
        self.pt_active = as_array(self._lib.map_pt_active_ptr(h), (max_points,))
        self.pt_desc = as_array(self._lib.map_pt_desc_ptr(h), (max_points, desc_words))
        self.pt_first_kf = as_array(self._lib.map_pt_first_kf_ptr(h), (max_points,))
        self.kf_pose = as_array(self._lib.map_kf_pose_ptr(h), (max_frames, 6))
        self.kf_gt = as_array(self._lib.map_kf_gt_ptr(h), (max_frames, 4, 4))
        self.kf_active = as_array(self._lib.map_kf_active_ptr(h), (max_frames,))
        self.kf_is_keyframe = as_array(self._lib.map_kf_is_keyframe_ptr(h), (max_frames,))
        self.kf_timestamp = as_array(self._lib.map_kf_timestamp_ptr(h), (max_frames,))
        self.kf_nkp = as_array(self._lib.map_kf_nkp_ptr(h), (max_frames,))
        self.kp_pt = as_array(self._lib.map_kp_pt_ptr(h), (max_frames, max_kp))
        self.kp_outlier = as_array(self._lib.map_kp_outlier_ptr(h), (max_frames, max_kp))
        self.kp_xy = as_array(self._lib.map_kp_xy_ptr(h), (max_frames, max_kp, 2))
        self.kp_sigma2 = as_array(self._lib.map_kp_sigma2_ptr(h), (max_frames, max_kp))
        self.kp_octave = as_array(self._lib.map_kp_octave_ptr(h), (max_frames, max_kp))
        self.kp_desc = as_array(
            self._lib.map_kp_desc_ptr(h), (max_frames, max_kp, desc_words)
        )

        # scale-envelope bounds per landmark (reference MapPoint.cpp:7-27:
        # dmax = dist * 1.2^octave, dmin = dmax / 1.2^(n_levels-1));
        # Python-side companion arrays to the native store
        self.pt_dmin = np.zeros(max_points, np.float32)
        self.pt_dmax = np.full(max_points, np.inf, np.float32)
        # sub-pixel reference color sampled at landmark creation
        # (reference MapPoint.cpp:317-341)
        self.pt_color = np.full((max_points, 3), 200, np.uint8)

    def __del__(self):
        try:
            self._lib.map_destroy(self._h)
        except Exception:
            pass

    # -- frames ------------------------------------------------------------

    def add_frame(self, timestamp, pose_rt6, kp_xy, kp_octave, kp_sigma2,
                  kp_desc, gt_pose44=None):
        """Register a frame with its detected features.  Returns the slot."""
        pose = np.ascontiguousarray(pose_rt6, np.float64)
        gt = (
            np.ascontiguousarray(gt_pose44, np.float64)
            if gt_pose44 is not None
            else None
        )
        xy = np.ascontiguousarray(kp_xy, np.float32)
        octv = np.ascontiguousarray(kp_octave, np.int32)
        sig = np.ascontiguousarray(kp_sigma2, np.float32)
        dsc = np.ascontiguousarray(kp_desc, np.uint32)
        n_kp = len(xy)
        c = ctypes.POINTER
        kf = self._lib.map_add_frame(
            self._h,
            float(timestamp),
            pose.ctypes.data_as(c(ctypes.c_double)),
            gt.ctypes.data_as(c(ctypes.c_double)) if gt is not None else None,
            n_kp,
            xy.ctypes.data_as(c(ctypes.c_float)),
            octv.ctypes.data_as(c(ctypes.c_int32)),
            sig.ctypes.data_as(c(ctypes.c_float)),
            dsc.ctypes.data_as(c(ctypes.c_uint32)),
        )
        if kf < 0:
            raise RuntimeError("map frame capacity exceeded")
        return kf

    def set_keyframe(self, kf, flag=True):
        self._lib.map_set_keyframe(self._h, kf, int(flag))

    def set_pose(self, kf, pose_rt6):
        pose = np.ascontiguousarray(pose_rt6, np.float64)
        self._lib.map_set_pose(self._h, kf, pose.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    def erase_frame(self, kf):
        self._lib.map_erase_frame(self._h, kf)

    # -- landmarks ---------------------------------------------------------

    def add_point(self, pos, desc=None, first_kf=-1):
        pos = np.ascontiguousarray(pos, np.float32)
        d = None if desc is None else np.ascontiguousarray(desc, np.uint32)
        pt = self._lib.map_add_point(
            self._h,
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)) if d is not None else None,
            int(first_kf),
        )
        if pt < 0:
            raise RuntimeError("map point capacity exceeded")
        return pt

    def set_point_scale_bounds(self, pt, dist, octave, scale_factor=1.2,
                               n_levels=8):
        """Distance envelope from the creating observation's octave
        (reference MapPoint.cpp:7-27)."""
        level = scale_factor ** int(octave)
        dmax = float(dist) * level
        self.pt_dmax[pt] = dmax
        self.pt_dmin[pt] = dmax / (scale_factor ** (n_levels - 1))

    def point_view_dirs(self, pt_ids):
        """Mean viewing directions [n,3] (reference MapPoint.cpp:166-200):
        average of unit vectors from observing keyframe centers to the point.
        One native batched pass — no per-point Python loops."""
        ids = np.ascontiguousarray(np.asarray(pt_ids, np.int32))
        out = np.zeros((len(ids), 3), np.float64)
        if len(ids):
            self._lib.map_point_view_dirs(
                self._h,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(ids),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        return out

    def add_observation(self, pt, kf, kp):
        return self._lib.map_add_observation(self._h, pt, kf, kp)

    def remove_observation(self, pt, kf):
        self._lib.map_remove_observation(self._h, pt, kf)

    def erase_point(self, pt):
        self._lib.map_erase_point(self._h, pt)

    def fuse_points(self, keep, merge):
        self._lib.map_fuse_points(self._h, keep, merge)

    def set_outlier(self, kf, kp, flag=True):
        self._lib.map_set_outlier(self._h, kf, kp, int(flag))

    def point_obs_count(self, pt):
        return self._lib.map_point_obs_count(self._h, pt)

    def point_obs_counts(self, pt_ids):
        """Batched observation counts (one native call; invalid ids -> 0)."""
        ids = np.ascontiguousarray(np.asarray(pt_ids, np.int32))
        out = np.empty(len(ids), np.int32)
        self._lib.map_point_obs_counts(
            self._h,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(ids),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def point_observations(self, pt, cap=256):
        kfs = np.empty(cap, np.int32)
        kps = np.empty(cap, np.int32)
        n = self._lib.map_point_observations(
            self._h, pt,
            kfs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            kps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap,
        )
        n = min(n, cap)
        return kfs[:n].copy(), kps[:n].copy()

    # -- covisibility & culling --------------------------------------------

    def update_covisibility(self, kf, threshold=COVIS_THRESHOLD):
        self._lib.map_update_covisibility(self._h, kf, threshold)

    def best_covisible(self, kf, n=10):
        out = np.empty(n, np.int32)
        w = np.empty(n, np.int32)
        cnt = self._lib.map_best_covisible(
            self._h, kf, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out[:cnt].copy(), w[:cnt].copy()

    def cull_recent_points(self, current_kf, window=4, min_obs=3, cap=65536):
        """Reference SfMHelper::cullRecentMapPoints (SfMHelper.cpp:974-1003)."""
        out = np.empty(cap, np.int32)
        n = self._lib.map_cull_recent_points(
            self._h, current_kf, window, min_obs,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        return out[: min(n, cap)].copy()

    def cull_redundant_keyframes(self, redundant_frac=0.95, min_other=3,
                                 keep_first=2, cap=4096):
        """Reference SfMHelper::cullRedundantKeyframes (SfMHelper.cpp:1005-1077)."""
        out = np.empty(cap, np.int32)
        n = self._lib.map_cull_redundant_keyframes(
            self._h, float(redundant_frac), min_other, keep_first,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        return out[: min(n, cap)].copy()

    def window_closure(self, kf_slots, obs_cap=4096, pt_cap=262144):
        """(observer_kfs, tracked_pts) for a keyframe window — the local-BA
        fixed-camera closure (reference Optimizer.cpp:500-546) in one native
        pass."""
        kf_sel = np.ascontiguousarray(kf_slots, np.int32)
        obs = np.empty(obs_cap, np.int32)
        pts = np.empty(pt_cap, np.int32)
        cnt = ctypes.c_int32(0)
        P = ctypes.POINTER
        n_obs = self._lib.map_window_closure(
            self._h, kf_sel.ctypes.data_as(P(ctypes.c_int32)), len(kf_sel),
            obs.ctypes.data_as(P(ctypes.c_int32)), obs_cap,
            pts.ctypes.data_as(P(ctypes.c_int32)), pt_cap,
            ctypes.byref(cnt),
        )
        return obs[: min(n_obs, obs_cap)].copy(), pts[: min(cnt.value, pt_cap)].copy()

    # -- queries -----------------------------------------------------------

    def active_keyframes(self):
        cap = self.max_frames
        out = np.empty(cap, np.int32)
        n = self._lib.map_active_keyframes(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap
        )
        return out[:n].copy()

    def active_points(self):
        cap = self.max_points
        out = np.empty(cap, np.int32)
        n = self._lib.map_active_points(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap
        )
        return out[:n].copy()

    # -- BA snapshots -------------------------------------------------------

    def _export_obs(self, kf_slots, include_outliers=False):
        kf_sel = np.ascontiguousarray(kf_slots, np.int32)
        cap = 0
        P = ctypes.POINTER
        # first call with cap=0 returns the required count
        n = self._lib.map_export_observations(
            self._h, kf_sel.ctypes.data_as(P(ctypes.c_int32)), len(kf_sel),
            int(include_outliers), None, None, None, None, None, 0,
        )
        cap = int(n)
        cam = np.empty(cap, np.int32)
        pt = np.empty(cap, np.int32)
        uv = np.empty((cap, 2), np.float32)
        sig = np.empty(cap, np.float32)
        kp = np.empty(cap, np.int32)
        if cap:
            self._lib.map_export_observations(
                self._h, kf_sel.ctypes.data_as(P(ctypes.c_int32)), len(kf_sel),
                int(include_outliers),
                cam.ctypes.data_as(P(ctypes.c_int32)),
                pt.ctypes.data_as(P(ctypes.c_int32)),
                uv.ctypes.data_as(P(ctypes.c_float)),
                sig.ctypes.data_as(P(ctypes.c_float)),
                kp.ctypes.data_as(P(ctypes.c_int32)),
                cap,
            )
        return cam, pt, uv, sig, kp

    def snapshot_problem(self, kf_slots, fixed_mask=None, min_obs=2,
                         include_outliers=False, extra_fixed_slots=None):
        """Build a padded BAProblem snapshot over the given keyframes.

        - kf_slots: frames whose cameras are free (plus `extra_fixed_slots`
          cameras included as fixed — the local-BA "observers of window
          points" pattern, reference Optimizer.cpp:531-546).
        - fixed_mask: per-kf_slots bool; defaults to fixing the first.
        - points observed fewer than min_obs times within the selection are
          dropped (they would be underconstrained).
        """
        kf_slots = list(kf_slots)
        extra = list(extra_fixed_slots) if extra_fixed_slots else []
        all_slots = kf_slots + [s for s in extra if s not in kf_slots]
        cam, pt, uv, sig, kp = self._export_obs(all_slots, include_outliers)

        if fixed_mask is None:
            fixed = np.zeros(len(all_slots), bool)
            fixed[0] = True
        else:
            fixed = np.asarray(fixed_mask, bool)
            fixed = np.concatenate([fixed, np.ones(len(all_slots) - len(fixed), bool)])

        # compact point ids; drop under-observed points
        ids, inverse, counts = np.unique(pt, return_inverse=True, return_counts=True)
        keep_pt = counts >= min_obs
        # remap: kept points -> [0, L), dropped -> -1
        remap = np.full(len(ids), -1, np.int64)
        remap[keep_pt] = np.arange(keep_pt.sum())
        pt_local = remap[inverse]
        keep_obs = pt_local >= 0
        cam, pt_local, uv, sig, kp = (
            cam[keep_obs], pt_local[keep_obs], uv[keep_obs], sig[keep_obs], kp[keep_obs],
        )
        pt_ids = ids[keep_pt]

        K_real, L_real, N_real = len(all_slots), len(pt_ids), len(cam)
        Kp, Lp, Np = _bucket(max(K_real, 1), 8), _bucket(max(L_real, 1)), _bucket(max(N_real, 1))

        extr = np.zeros((Kp, 6), np.float32)
        extr[:K_real] = self.kf_pose[all_slots].astype(np.float32)
        points = np.zeros((Lp, 3), np.float32)
        points[:L_real] = self.pt_pos[pt_ids]
        cam_fixed = np.ones(Kp, bool)
        cam_fixed[:K_real] = fixed

        cam_p = np.zeros(Np, np.int32)
        cam_p[:N_real] = cam
        pt_p = np.zeros(Np, np.int32)
        pt_p[:N_real] = pt_local
        uv_p = np.zeros((Np, 2), np.float32)
        uv_p[:N_real] = uv
        sig_p = np.ones(Np, np.float32)
        sig_p[:N_real] = sig
        valid = np.zeros(Np, bool)
        valid[:N_real] = True
        kp_p = np.full(Np, -1, np.int32)
        kp_p[:N_real] = kp

        return BASnapshot(
            kf_slots=np.asarray(all_slots, np.int32),
            pt_ids=pt_ids.astype(np.int32),
            cam_idx=cam_p, pt_idx=pt_p, uv=uv_p, sigma2=sig_p, valid=valid,
            cam_fixed=cam_fixed, kp_idx=kp_p, extr=extr, points=points,
            K4=self.K4,
        )

    def writeback(self, snap: BASnapshot, extr_opt, points_opt, valid_opt=None):
        """Write optimized cameras/points (and outlier flags) back to the store.

        The pruned-validity mask marks observations as outliers, the analogue
        of the reference's post-solve pruneCorrespondences + eraseOutlier
        (Optimizer.cpp:270-277).
        """
        extr_opt = np.asarray(extr_opt, np.float64)
        for i, slot in enumerate(snap.kf_slots):
            if not snap.cam_fixed[i]:
                self.set_pose(int(slot), extr_opt[i])
        pts = np.asarray(points_opt, np.float32)[: snap.n_pts]
        self.pt_pos[snap.pt_ids] = pts
        if valid_opt is not None:
            valid_opt = np.asarray(valid_opt)
            newly_bad = snap.valid & ~valid_opt
            for n in np.nonzero(newly_bad)[0]:
                kf = int(snap.kf_slots[snap.cam_idx[n]])
                self.set_outlier(kf, int(snap.kp_idx[n]), True)

    def refresh_point_descriptor(self, pt):
        """Representative descriptor = min median Hamming distance among
        observations (reference MapPoint::computeDescriptor,
        src/model/MapPoint.cpp:202-252).  Native."""
        self.refresh_point_descriptors([pt])

    def refresh_point_descriptors(self, pt_ids):
        """Batched native representative-descriptor refresh."""
        ids = np.ascontiguousarray(np.asarray(pt_ids, np.int32))
        if len(ids):
            self._lib.map_refresh_point_descriptors(
                self._h,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(ids),
            )

    def point_has_outlier_obs(self, pt_ids):
        """Batched: True where any observation of the landmark is flagged
        outlier (the reference viewer's red-cloud partition,
        src/visualization/Visualizer.cpp:79-89)."""
        ids = np.ascontiguousarray(np.asarray(pt_ids, np.int32))
        out = np.zeros(len(ids), np.uint8)
        if len(ids):
            self._lib.map_point_has_outlier_obs(
                self._h,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(ids),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
        return out.astype(bool)

    def refresh_frame_points(self, kf):
        """Refresh the representative descriptor of every landmark tracked by
        frame `kf` — one native pass; invoked by the driver after a frame's
        observation writes (the reference refreshes on each addObservation /
        fuse, MapPoint.cpp:51-61,130-164)."""
        return self._lib.map_refresh_frame_points(self._h, int(kf))
