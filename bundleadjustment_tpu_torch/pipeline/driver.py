"""Tracking / mapping pipeline driver on tensors.

Port of `bundleadjustment_tpu/pipeline/driver.py`: gtdepth or standard
(two-view E/H, `geometry/epipolar.py`) initialization, tracking by
`estimation="ba"` or `"pnp"` (motion-only BA, robust or not, with the guided
local-map second pass) or `"essential_or_homography"` (two-view pose with
the constant-velocity scale), keyframe culling / triangulation / covisibility /
neighbourhood search and fusion, RGB-D depth seeding at keyframes
(`depth_landmarks`), local or global BA (`global_ba_mode="single"`, or
`"sharded"` / `"windowed"` over torch.distributed; `ba_solver="dense"` or
`"pcg"`), and `finalize` (the 3 x 100 global BA plus two rounds of
trajectory refinement), with the native C++ map store (`SceneMap`, copied
from the JAX package) holding the observation graph.

Device work (detection, matching, motion-only BA, triangulation, BA) runs on
`device`; host bookkeeping stays in numpy. Every Hamming top-2 search
(previous-frame match, guided local-map match, neighbour search) goes through
kernel A; dense BA goes through kernels B and C (K5 or kernel D in the
sharded global BA and for more than 64 observations per landmark; B alone
with PCG).

Differences from the JAX driver:

- tracking runs one frame at a time (`process_frames` has the per-frame
  and the predetect branches, not the microbatch); `track_batch` and
  `matcher` are accepted and ignored. The JAX CLI's default is the
  `process_frames` microbatch (`track_batch = 8`), whose guided local-map
  pass matches against a landmark snapshot frozen at the start of each
  batch, so its map and poses differ slightly from per-frame tracking.
  The port's per-frame run lies within the JAX package's own tolerance for
  that microbatch: statuses and keyframe counts equal, map sizes within
  2%, ATE within 0.01 m (tests/test_torch_pipeline.py,
  `test_default_tracking_matches_jax_default`). None of the differences
  below changes a result;
- no power-of-two shape buckets: they existed to reuse jit compilations
  (the two-view estimators get the real pairs and an all-true mask);
- the RANSAC samples come from a CPU `torch.Generator` seeded with
  `config.seed`, not from a JAX key: other samples, the same distribution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.geometry import np_se3
from bundleadjustment_tpu_torch.geometry.epipolar import (
    recover_pose_two_view,
    sample_indices,
)
from bundleadjustment_tpu_torch.geometry.triangulation import triangulate_gated
from bundleadjustment_tpu_torch.mapstate.scene import SceneMap
from bundleadjustment_tpu_torch.ops.features import FeatureConfig, detect_and_describe
from bundleadjustment_tpu_torch.ops.matching import (
    match_descriptors_batch,
    match_descriptors_fused,
)
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.solvers.dense_ba import (
    dense_ba_solve,
    densify_problem_auto,
)
from bundleadjustment_tpu_torch.solvers.lm import (
    SOLVERS,
    LMConfig,
    MotionOnlyConfig,
    ba_solve,
    motion_only_ba,
)
from bundleadjustment_tpu_torch.solvers.residuals import BAProblem, prune_outliers_cams
from bundleadjustment_tpu_torch.utils.profiling import PhaseTimer


def sample_color_bilinear(image, uv):
    """Sub-pixel color lookup. image [H,W] gray in [0,1] or [H,W,3] uint8;
    returns [N,3] uint8."""
    h, w = image.shape[:2]
    x = np.clip(uv[:, 0], 0, w - 1.001)
    y = np.clip(uv[:, 1], 0, h - 1.001)
    x0 = x.astype(int)
    y0 = y.astype(int)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    img = image.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None] * 255.0
    val = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
           + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    if val.shape[1] == 1:
        val = np.repeat(val, 3, axis=1)
    return np.clip(val, 0, 255).astype(np.uint8)


def sample_depth_bilinear(depth, uv):
    """Sub-pixel depth lookup; a sample is valid only if its 4 neighbours
    are finite (invalid -> nan)."""
    h, w = depth.shape
    x = np.clip(uv[:, 0], 0, w - 1.001)
    y = np.clip(uv[:, 1], 0, h - 1.001)
    x0 = x.astype(int)
    y0 = y.astype(int)
    fx = x - x0
    fy = y - y0
    d = [depth[y0, x0], depth[y0, x0 + 1], depth[y0 + 1, x0], depth[y0 + 1, x0 + 1]]
    ok = np.isfinite(d[0]) & np.isfinite(d[1]) & np.isfinite(d[2]) & np.isfinite(d[3])
    d00, d01, d10, d11 = (np.where(ok, v, 0.0) for v in d)
    val = (d00 * (1 - fx) * (1 - fy) + d01 * fx * (1 - fy)
           + d10 * (1 - fx) * fy + d11 * fx * fy)
    return np.where(ok & (val > 0), val, np.nan)


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def hamming_rows(a, b):
    """Hamming distances between paired rows of packed descriptors a, b
    [N, W] uint32: the set bits of a ^ b per row, counted a byte at a time
    through a 256-entry table (numpy's `bitwise_count` needs numpy >= 2)."""
    x = np.ascontiguousarray(np.bitwise_xor(a.astype(np.uint32),
                                            b.astype(np.uint32)))
    return _POPCOUNT8[x.view(np.uint8)].reshape(len(x), -1).sum(-1, dtype=np.int64)


@dataclass
class FrameFeatures:
    xy: np.ndarray
    octave: np.ndarray
    sigma2: np.ndarray
    desc: np.ndarray  # [M, 8] uint32
    valid: np.ndarray
    desc_dev: torch.Tensor | None = None  # [M, 8] int32 on the device
    valid_dev: torch.Tensor | None = None


@dataclass
class TrackRecord:
    timestamp: float
    slot: int
    extr: np.ndarray  # world->camera rt6 at tracking time
    is_keyframe: bool
    ref_kf: int | None = None  # most recent keyframe at tracking time
    rel: np.ndarray | None = None  # extr o inv(kf_pose[ref_kf])
    assoc_pt: np.ndarray | None = None
    assoc_uv: np.ndarray | None = None
    assoc_sig: np.ndarray | None = None
    feats: FrameFeatures | None = None
    assoc_kp: np.ndarray | None = None
    # set by `finalize` when a trajectory refinement accepted a re-solve:
    # the record's pose is then the refined one, already map-consistent
    refined: bool = False


def _pow2(n, minimum):
    """Smallest power of two times `minimum` that is >= n (the reference's
    `_pow2`, kept here so the sharded global BA buckets max_obs alike)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def check_config(cfg: PipelineConfig):
    """Raise ValueError for a mode the reference does not have."""
    if cfg.init_type not in ("gtdepth", "standard"):
        raise ValueError(f"unknown init_type {cfg.init_type!r}")
    if cfg.estimation not in ("ba", "pnp", "essential_or_homography"):
        raise ValueError(f"unknown estimation {cfg.estimation!r}")
    if cfg.ba_solver not in SOLVERS:
        raise ValueError(f"unknown ba_solver {cfg.ba_solver!r}")


def _feat_capacity(config: PipelineConfig):
    return config.n_features + 16 * config.n_levels


class BundleAdjustmentPipeline:
    def __init__(self, config: PipelineConfig, K4, width, height, device="cuda"):
        check_config(config)
        self.cfg = config
        self.device = resolve_device(device)
        self.K4 = np.asarray(K4, np.float32)
        self.K4_dev = torch.from_numpy(self.K4).to(self.device)
        self.width = width
        self.height = height
        self.map = SceneMap(max_frames=config.max_map_frames,
                            max_points=config.max_map_points,
                            max_kp=_feat_capacity(config), K4=self.K4)
        self.feat_cfg = FeatureConfig(n_features=config.n_features,
                                      n_levels=config.n_levels,
                                      scale_factor=config.scale_factor,
                                      detector=config.detector)
        # RANSAC sampler of the two-view estimators: on the CPU, so a run on
        # the card and a run on the CPU draw the same samples
        self._gen = torch.Generator(device="cpu")
        self._gen.manual_seed(config.seed)
        self.initialized = False
        self.ref_slot = None
        self.ref_feats: FrameFeatures | None = None
        self.last_slot = None
        self.last_feats: FrameFeatures | None = None
        self.prev_extr = None
        self.last_extr = None
        self.kf_counter = 0
        self.trajectory: list[TrackRecord] = []
        self.stats = {"frames": 0, "keyframes": 0, "tracking_failures": 0}
        self.timers = PhaseTimer()
        # (observations, engine) of every BA solve, in order: "flat",
        # "dense_landmark", "sharded" or "windowed"
        self.ba_solves: list[tuple[int, str]] = []
        self.windowed_runs: list[dict] = []  # info of every windowed global BA
        self._prev_track = None  # (xyz [M,3], trackable [M], ids [M])
        self._pending_seeds: list[int] = []  # 1-obs depth-seeded landmarks
        self._last_kf_slot = None
        self._kf_ref_inliers = None
        self._frames_since_kf = 0

    # ------------------------------------------------------------------
    # device helpers
    # ------------------------------------------------------------------

    def _t(self, a, dtype=None):
        """numpy -> tensor on the pipeline's device (uint32 keeps its bits
        as int32)."""
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.from_numpy(np.array(a)).to(self.device)
        return t if dtype is None else t.to(dtype)

    def _dev_desc(self, f: FrameFeatures):
        if f.desc_dev is None:
            f.desc_dev = self._t(f.desc)
            f.valid_dev = self._t(f.valid)
        return f.desc_dev, f.valid_dev

    def _features(self, f):
        """Device Features -> FrameFeatures (one host fetch)."""
        return FrameFeatures(
            xy=f.xy.cpu().numpy(), octave=f.octave.cpu().numpy(),
            sigma2=f.sigma2.cpu().numpy(),
            desc=f.desc.cpu().numpy().view(np.uint32),
            valid=f.valid.cpu().numpy(), desc_dev=f.desc, valid_dev=f.valid)

    def _gray(self, gray):
        return self._t(np.asarray(gray, np.float32))

    def detect(self, gray) -> FrameFeatures:
        with self.timers.phase("detect"):
            return self._features(detect_and_describe(self._gray(gray),
                                                      self.feat_cfg))

    def _match_prev(self, desc, valid, prev: FrameFeatures):
        """Match prev -> the current frame's device descriptors (kernel A)."""
        desc_p, valid_p = self._dev_desc(prev)
        return match_descriptors_fused(desc_p, desc, valid_a=valid_p,
                                       valid_b=valid, ratio=self.cfg.match_ratio)

    def detect_and_match(self, gray, prev: FrameFeatures):
        """Detect the current frame and match prev -> current."""
        with self.timers.phase("frontend"):
            f = detect_and_describe(self._gray(gray), self.feat_cfg)
            idx, dist = self._match_prev(f.desc, f.valid, prev)
            return self._features(f), idx.cpu().numpy(), dist.cpu().numpy()

    def _track_fused(self, gray, prev: FrameFeatures, pred_extr):
        """Detect + match + landmark association + motion-only BA of one
        tracked frame. Returns (feats, idx, dist, ok, rt6, inliers) on the
        host."""
        cfg = self.cfg
        with self.timers.phase("frontend"):
            xyz, okm, _ids = self._prev_track
            f = detect_and_describe(self._gray(gray), self.feat_cfg)
            idx, dist = self._match_prev(f.desc, f.valid, prev)
            safe = torch.clamp(idx, min=0).long()
            ok = (idx >= 0) & self._t(okm) & (dist < cfg.assoc_max_dist)
            ok = ok & (torch.cumsum(ok.to(torch.int64), 0) <= cfg.max_track_obs)
            mcfg = MotionOnlyConfig(outer_iters=cfg.motion_outer,
                                    inner_iters=cfg.motion_inner,
                                    robust=cfg.estimation == "ba")
            rt, inl = motion_only_ba(
                self.K4_dev, self._t(np.asarray(pred_extr, np.float32))[None],
                self._t(xyz)[None], f.xy[safe][None], f.sigma2[safe][None],
                ok[None], mcfg)
            feats = self._features(f)
            return (feats, idx.cpu().numpy(), dist.cpu().numpy(),
                    ok.cpu().numpy(), rt[0].cpu().numpy().astype(np.float64),
                    inl[0].cpu().numpy())

    def _capture_track_state(self, slot, feats):
        """Per-keypoint landmark state of the new last frame for the next
        frame's association: positions, the >= 2-observation mask, ids.
        None unless the fused step tracks the next frame (`fused_tracking`
        and estimation "ba" or "pnp"): else it takes the split path."""
        if not (self.cfg.fused_tracking
                and self.cfg.estimation in ("ba", "pnp")):
            self._prev_track = None
            return
        m = self.map
        M = len(feats.desc)
        kp_pt = m.kp_pt[slot, :M].astype(np.int64)
        has = kp_pt >= 0
        ok = has & (m.point_obs_counts(kp_pt) >= 2)
        xyz = np.zeros((M, 3), np.float32)
        xyz[has] = m.pt_pos[kp_pt[has]]
        self._prev_track = (xyz, ok, np.where(ok, kp_pt, -1))

    # ------------------------------------------------------------------
    # bundle adjustment
    # ------------------------------------------------------------------

    def _flat_problem(self, snap):
        return BAProblem(
            K4=self._t(snap.K4), cam_idx=self._t(snap.cam_idx, torch.int64),
            pt_idx=self._t(snap.pt_idx, torch.int64), uv=self._t(snap.uv),
            sigma2=self._t(snap.sigma2), valid=self._t(snap.valid),
            cam_fixed=self._t(snap.cam_fixed),
            pt_fixed=torch.zeros(snap.points.shape[0], dtype=torch.bool,
                                 device=self.device))

    def _lm_config(self, max_iters):
        """The LM settings of a pipeline BA solve: the configured solver and
        its PCG budget."""
        return LMConfig(max_iters=max_iters, solver=self.cfg.ba_solver,
                        pcg_iters=self.cfg.pcg_iters)

    def _solve_ba(self, snap, max_iters):
        with self.timers.phase("bundle_adjust"):
            n_obs = int(np.asarray(snap.valid).sum())
            layout = self.cfg.ba_layout
            if layout == "auto":
                layout = ("dense_landmark"
                          if n_obs >= self.cfg.ba_layout_auto_min_obs else "flat")
            self.ba_solves.append((n_obs, layout))
            lm_cfg = self._lm_config(max_iters)
            prob = self._flat_problem(snap)
            extr, points = self._t(snap.extr), self._t(snap.points)
            if layout == "dense_landmark":
                dense, _dropped, _O = densify_problem_auto(
                    snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2,
                    snap.valid, snap.cam_fixed, snap.points.shape[0],
                    max_obs=self.cfg.ba_max_obs_per_pt, device=self.device)
                cams, pts, info = dense_ba_solve(dense, extr, points, lm_cfg)
            else:
                cams, pts, info = ba_solve(prob, extr, points, lm_cfg)
            self._prune_writeback(snap, prob, cams, pts)
            return info

    def _prune_writeback(self, snap, prob, cams, pts):
        """Post-solve chi2 pruning in the flat layout, then one fetch and the
        map writeback."""
        new_valid = prune_outliers_cams(prob, cams, pts)
        self.map.writeback(snap, cams.cpu().numpy(), pts.cpu().numpy(),
                           new_valid.cpu().numpy())

    def global_ba(self, max_iters=None):
        """Global BA over all active keyframes (first one fixed), routed by
        cfg.global_ba_mode: "single" (`_solve_ba`), "windowed"
        (`_global_ba_windowed`, with 3 or more keyframes) or "sharded"
        (`_solve_ba_sharded`)."""
        kfs = self.map.active_keyframes().tolist()
        if len(kfs) < 2:
            return None
        if self.cfg.global_ba_mode == "windowed" and len(kfs) >= 3:
            return self._global_ba_windowed(max_iters or self.cfg.kf_ba_iters)
        snap = self.map.snapshot_problem(kfs, min_obs=2)
        if self.cfg.global_ba_mode == "sharded":
            return self._solve_ba_sharded(snap, max_iters or self.cfg.kf_ba_iters)
        return self._solve_ba(snap, max_iters or self.cfg.kf_ba_iters)

    def _global_ba_windowed(self, max_iters):
        """Windowed global BA + pose-graph stitch (parallel/windows.py), the
        windows dealt over the default process group's ranks when one is
        initialised. Returns its info dict; `windowed_runs` keeps them all."""
        from bundleadjustment_tpu_torch.parallel.multihost import default_group
        from bundleadjustment_tpu_torch.parallel.windows import windowed_global_ba

        with self.timers.phase("bundle_adjust"):
            info = windowed_global_ba(
                self.map, window=self.cfg.local_window,
                stride=max(self.cfg.local_window // 2, 1),
                config=self._lm_config(max_iters), group=default_group(),
                device=self.device)
            self.ba_solves.append((info["observations"], "windowed"))
            self.windowed_runs.append(info)
            return info

    def _solve_ba_sharded(self, snap, max_iters):
        """Landmark-sharded dense solve (parallel/sharded_dense_ba.py) over
        the default process group when one is initialised, else one shard:
        the per-shard Schur partials are all-reduced, everything landmark-
        side stays on its rank. Every rank writes back the same result."""
        from bundleadjustment_tpu_torch.parallel.multihost import default_group
        from bundleadjustment_tpu_torch.parallel.sharded_dense_ba import (
            gather_points,
            shard_dense_problem,
            sharded_dense_ba_solve,
        )

        with self.timers.phase("bundle_adjust"):
            self.ba_solves.append((int(np.asarray(snap.valid).sum()), "sharded"))
            group = default_group()
            n_shards = 1 if group is None else torch.distributed.get_world_size(group)
            rank = 0 if group is None else torch.distributed.get_rank(group)
            # max_obs: never drop a constraint: the true per-landmark maximum
            # rounded up to a power of two (the reference's bucket, so that
            # densify trims O to the same width)
            counts = np.bincount(np.asarray(snap.pt_idx)[np.asarray(snap.valid)],
                                 minlength=snap.points.shape[0])
            max_obs = _pow2(max(int(counts.max()) if counts.size else 1, 1),
                            self.cfg.ba_max_obs_per_pt)
            prob, pts_sh, shard_of, local_of = shard_dense_problem(
                snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2,
                snap.valid, snap.cam_fixed, snap.points, n_shards, rank,
                max_obs=max_obs, device=self.device)
            cfg = self._lm_config(max_iters)
            cams, pts_sh, info = sharded_dense_ba_solve(
                prob, self._t(snap.extr), pts_sh, cfg, group)
            pts = self._t(gather_points(pts_sh, shard_of, local_of, group))
            self._prune_writeback(snap, self._flat_problem(snap), cams, pts)
            return info

    def local_ba(self, center_kf, max_iters=None):
        """Window = center + best covisible; observers of window points enter
        as fixed cameras."""
        nbrs, _ = self.map.best_covisible(center_kf, self.cfg.local_window)
        window = [center_kf] + [int(k) for k in nbrs]
        fixed_extra, _pts = self.map.window_closure(window)
        fixed_extra = set(int(k) for k in fixed_extra)
        fixed_mask = np.zeros(len(window), bool)
        if not fixed_extra:
            fixed_mask[int(np.argmin(window))] = True
        snap = self.map.snapshot_problem(window, fixed_mask=fixed_mask, min_obs=2,
                                         extra_fixed_slots=sorted(fixed_extra))
        return self._solve_ba(snap, max_iters or self.cfg.kf_ba_iters)

    def _motion_only_batch(self, E0, P, U, S, V, robust=True):
        cfg = MotionOnlyConfig(outer_iters=self.cfg.motion_outer,
                               inner_iters=self.cfg.motion_inner, robust=robust)
        rt, inl = motion_only_ba(self.K4_dev, self._t(E0), self._t(P),
                                 self._t(U), self._t(S), self._t(V), cfg)
        return rt.cpu().numpy().astype(np.float64), inl.cpu().numpy()

    def motion_only(self, extr0, pts3d, uv, sigma2, robust=True):
        """Single-frame motion-only BA, first max_track_obs associations."""
        M = self.cfg.max_track_obs
        n = min(len(pts3d), M)
        P = np.zeros((1, M, 3), np.float32)
        U = np.zeros((1, M, 2), np.float32)
        S = np.ones((1, M), np.float32)
        V = np.zeros((1, M), bool)
        P[0, :n] = pts3d[:n]
        U[0, :n] = uv[:n]
        S[0, :n] = sigma2[:n]
        V[0, :n] = True
        rt, inl = self._motion_only_batch(
            np.asarray(extr0, np.float32)[None], P, U, S, V, robust)
        return rt[0], inl[0, :n]

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _init_gtdepth(self, cur_slot, cur_feats, ref_depth, matches, dists):
        """Bootstrap from the reference frame's depth map."""
        m = self.map
        ref = self.ref_slot
        rf = self.ref_feats
        depths = sample_depth_bilinear(ref_depth, rf.xy)
        ref_extr = m.kf_pose[ref]
        pose_ref = np_se3.rt6_inverse(ref_extr)
        K = self.K4
        kp_point = np.full(len(rf.xy), -1, np.int64)
        for kp in range(len(rf.xy)):
            if not rf.valid[kp] or not np.isfinite(depths[kp]):
                continue
            d = depths[kp]
            xc = np.array([(rf.xy[kp, 0] - K[2]) / K[0] * d,
                           (rf.xy[kp, 1] - K[3]) / K[1] * d, d])
            xw = np_se3.rt6_apply(pose_ref, xc)
            pt = m.add_point(xw, desc=rf.desc[kp], first_kf=self.kf_counter)
            m.add_observation(pt, ref, kp)
            m.set_point_scale_bounds(pt, np.linalg.norm(xc), rf.octave[kp],
                                     self.cfg.scale_factor, self.cfg.n_levels)
            kp_point[kp] = pt
        ref_img = getattr(self, "_ref_image", None)
        if ref_img is not None:
            created = np.nonzero(kp_point >= 0)[0]
            m.pt_color[kp_point[created]] = sample_color_bilinear(
                ref_img, rf.xy[created])

        assoc = [(kp_point[kp_ref], kp_cur) for kp_ref, kp_cur in enumerate(matches)
                 if kp_cur >= 0 and kp_point[kp_ref] >= 0]
        if len(assoc) < self.cfg.min_track_points:
            return False
        assoc_pt = np.array([a[0] for a in assoc], np.int64)
        assoc_kp = np.array([a[1] for a in assoc], np.int64)
        extr, inl = self.motion_only(ref_extr.copy(), m.pt_pos[assoc_pt],
                                     cur_feats.xy[assoc_kp],
                                     cur_feats.sigma2[assoc_kp])
        m.set_pose(cur_slot, extr)
        for i in np.nonzero(inl)[0]:
            m.add_observation(int(assoc_pt[i]), cur_slot, int(assoc_kp[i]))
        self._triangulate_pairs(ref, cur_slot, rf, cur_feats, matches,
                                exclude_with_points=True)
        m.set_keyframe(ref)
        m.set_keyframe(cur_slot)
        self.kf_counter += 2
        m.refresh_frame_points(cur_slot)
        m.update_covisibility(cur_slot, self.cfg.covis_threshold)
        m.update_covisibility(ref, self.cfg.covis_threshold)
        return True

    def _two_view_samples(self, n, n_hyp):
        """The minimal samples of one two-view estimate over n pairs:
        (idx_e [n_hyp, 8], idx_h [n_hyp, 4]) from the pipeline's generator."""
        valid = torch.ones(n, dtype=torch.bool)
        return (sample_indices(self._gen, valid, n_hyp, 8),
                sample_indices(self._gen, valid, n_hyp, 4))

    def _two_view(self, uv1, uv2, n_hyp=256):
        """`recover_pose_two_view` over matched pixel pairs (host arrays) on
        the device; returns the TwoViewResult with host (numpy) fields."""
        with self.timers.phase("two_view"):
            idx_e, idx_h = self._two_view_samples(len(uv1), n_hyp)
            res = recover_pose_two_view(
                None, self._t(uv1, torch.float32), self._t(uv2, torch.float32),
                torch.ones(len(uv1), dtype=torch.bool, device=self.device),
                self.K4_dev, n_hyp=n_hyp, idx_e=idx_e.to(self.device),
                idx_h=idx_h.to(self.device))
            return type(res)(**{k: v.cpu().numpy() for k, v in vars(res).items()})

    def _init_standard(self, cur_slot, cur_feats, matches, dists):
        """Two-view E/H bootstrap: the reference frame is the identity, the
        current frame takes the recovered relative pose (unit baseline), the
        inlier matches are triangulated, then two global BAs."""
        m = self.map
        ref = self.ref_slot
        rf = self.ref_feats
        pair_ref = np.nonzero(matches >= 0)[0]
        pair_cur = matches[pair_ref]
        n = len(pair_ref)
        if n < self.cfg.min_init_matches:
            return False
        uv1 = rf.xy[pair_ref]
        uv2 = cur_feats.xy[pair_cur]
        res = self._two_view(uv1, uv2)
        # acceptance (more than 100 E inliers / a surviving H decomposition)
        # plus a relative-support guard for small n
        if not bool(res.ok) or int(res.n_inliers) < max(50, int(0.3 * n)):
            return False
        rel = res.rt6.astype(np.float64)
        m.set_pose(cur_slot, rel)  # ref is the identity: extr_cur = rel

        # triangulate the inlier matches (no baseline check at bootstrap)
        pts, ok = self._triangulate(m.kf_pose[ref], rel, uv1, uv2,
                                    rf.sigma2[pair_ref],
                                    cur_feats.sigma2[pair_cur], res.inliers)
        cur_img = getattr(self, "_cur_image", None)
        cols = (sample_color_bilinear(cur_img, uv2) if cur_img is not None
                else None)
        created = np.nonzero(ok)[0]
        for i in created:
            pt = m.add_point(pts[i], desc=cur_feats.desc[pair_cur[i]],
                             first_kf=self.kf_counter)
            m.add_observation(pt, ref, int(pair_ref[i]))
            m.add_observation(pt, cur_slot, int(pair_cur[i]))
            if cols is not None:
                m.pt_color[pt] = cols[i]
        if len(created) < 50:
            return False

        m.set_keyframe(ref)
        m.set_keyframe(cur_slot)
        self.kf_counter += 2
        m.refresh_frame_points(cur_slot)
        m.update_covisibility(cur_slot, self.cfg.covis_threshold)
        m.update_covisibility(ref, self.cfg.covis_threshold)
        # full BA over the two views; two rounds with chi2 pruning between
        # them so a noisy H/E decomposition seed converges
        self.global_ba(max(self.cfg.kf_ba_iters, 15))
        self.global_ba(max(self.cfg.kf_ba_iters, 15))
        return True

    # ------------------------------------------------------------------
    # triangulation of new landmarks at keyframes
    # ------------------------------------------------------------------

    def _tri_precondition_ok(self, slot_a, slot_b):
        """Baseline / median scene depth >= 0.01."""
        m = self.map
        tracked = m.kp_pt[slot_b, : m.kf_nkp[slot_b]]
        tracked = tracked[tracked >= 0]
        if len(tracked) < 5:
            return True
        extr_b = m.kf_pose[slot_b]
        R_b = np_se3.aa_to_R(extr_b[:3])
        z = m.pt_pos[tracked].astype(np.float64) @ R_b[2] + extr_b[5]
        med_depth = float(np.median(z[z > 0])) if (z > 0).any() else np.inf
        baseline = np.linalg.norm(np_se3.rt6_inverse(m.kf_pose[slot_a])[3:]
                                  - np_se3.rt6_inverse(extr_b)[3:])
        return not (np.isfinite(med_depth)
                    and baseline / max(med_depth, 1e-9) < 0.01)

    def _create_triangulated(self, slot_a, slot_b, fa, fb, pair_a, pair_b,
                             pts, ok, image=None, image_side="b",
                             recheck=False):
        """Insert accepted triangulations as landmarks (+ observations, scale
        bounds, color). recheck: skip pairs whose keypoints gained a landmark
        since the candidates were collected."""
        m = self.map
        center_b = np_se3.rt6_inverse(m.kf_pose[slot_b])[3:]
        colors = None
        if image is not None:
            kp_xy = fa.xy[pair_a] if image_side == "a" else fb.xy[pair_b]
            colors = sample_color_bilinear(image, kp_xy)
        n = 0
        for i in np.nonzero(ok)[0]:
            if recheck and (m.kp_pt[slot_a, pair_a[i]] >= 0
                            or m.kp_pt[slot_b, pair_b[i]] >= 0):
                continue
            pt = m.add_point(pts[i], desc=fb.desc[pair_b[i]],
                             first_kf=self.kf_counter)
            if m.add_observation(pt, slot_a, int(pair_a[i])) != 1:
                m.erase_point(pt)
                continue
            if m.add_observation(pt, slot_b, int(pair_b[i])) != 1:
                m.erase_point(pt)
                continue
            m.set_point_scale_bounds(pt, np.linalg.norm(pts[i] - center_b),
                                     fb.octave[pair_b[i]], self.cfg.scale_factor,
                                     self.cfg.n_levels)
            if colors is not None:
                m.pt_color[pt] = colors[i]
            n += 1
        return n

    def _triangulate(self, extr_a, extr_b, xa, xb, sa, sb, valid):
        """Gated triangulation on the device; extr_b/xa/... may carry a
        leading neighbour axis. Returns host (points, ok)."""
        pts, ok = triangulate_gated(
            self.K4_dev, self._t(np.asarray(extr_a, np.float32)),
            self._t(np.asarray(extr_b, np.float32)), self._t(xa), self._t(xb),
            self._t(sa), self._t(sb), self._t(valid))
        return pts.cpu().numpy(), ok.cpu().numpy()

    def _triangulate_pairs(self, slot_a, slot_b, fa, fb, matches,
                           exclude_with_points=True, image=None, image_side="b"):
        """Triangulate matched keypoint pairs that lack landmarks."""
        m = self.map
        pair_a = np.nonzero(matches >= 0)[0]
        pair_b = matches[pair_a]
        if exclude_with_points:
            free = (m.kp_pt[slot_a, pair_a] < 0) & (m.kp_pt[slot_b, pair_b] < 0)
            pair_a, pair_b = pair_a[free], pair_b[free]
        if len(pair_a) == 0 or not self._tri_precondition_ok(slot_a, slot_b):
            return 0
        pts, ok = self._triangulate(
            m.kf_pose[slot_a], m.kf_pose[slot_b], fa.xy[pair_a], fb.xy[pair_b],
            fa.sigma2[pair_a], fb.sigma2[pair_b], np.ones(len(pair_a), bool))
        return self._create_triangulated(slot_a, slot_b, fa, fb, pair_a, pair_b,
                                         pts, ok, image=image,
                                         image_side=image_side)

    def _triangulate_neighbors(self, kf, feats, jobs, image=None):
        """Batched neighbourhood triangulation: one device call over every
        neighbour's new pairs, then landmark creation in neighbour order with
        a staleness recheck. jobs: (nb_slot, pair_kf, pair_nb, nb_feats)."""
        m = self.map
        jobs = [j for j in jobs if len(j[1]) and self._tri_precondition_ok(kf, j[0])]
        if not jobs:
            return 0
        P = max(len(j[1]) for j in jobs)
        NB = len(jobs)
        extr_b = np.zeros((NB, 6), np.float32)
        xa = np.zeros((NB, P, 2), np.float32)
        xb = np.zeros((NB, P, 2), np.float32)
        sa = np.ones((NB, P), np.float32)
        sb = np.ones((NB, P), np.float32)
        vd = np.zeros((NB, P), bool)
        for bi, (nb, pa, pb, nf) in enumerate(jobs):
            k = len(pa)
            extr_b[bi] = m.kf_pose[nb]
            xa[bi, :k] = feats.xy[pa]
            xb[bi, :k] = nf.xy[pb]
            sa[bi, :k] = feats.sigma2[pa]
            sb[bi, :k] = nf.sigma2[pb]
            vd[bi, :k] = True
        pts, ok = self._triangulate(m.kf_pose[kf], extr_b, xa, xb, sa, sb, vd)
        n = 0
        for bi, (nb, pa, pb, nf) in enumerate(jobs):
            k = len(pa)
            n += self._create_triangulated(kf, nb, feats, nf, pa, pb,
                                           pts[bi, :k], ok[bi, :k], image=image,
                                           image_side="a", recheck=True)
            # pairs whose kf keypoint gained a landmark from an earlier
            # neighbour's job take the gated transfer instead
            pt_now = m.kp_pt[kf, pa]
            stale = np.nonzero((pt_now >= 0) & (m.kp_pt[nb, pb] < 0))[0]
            if len(stale):
                gate = self._transfer_gate(pt_now[stale], nb, pb[stale])
                for i in stale[gate]:
                    m.add_observation(int(pt_now[i]), nb, int(pb[i]))
        return n

    # ------------------------------------------------------------------
    # RGB-D depth seeding
    # ------------------------------------------------------------------

    def _seed_depth_landmarks(self, slot, feats: FrameFeatures, depth):
        """Backproject the keyframe's landmark-free keypoints through its
        depth map into new map points (at most depth_landmarks_max, the
        finest octaves first, in keypoint order). Seeds start with one
        observation and wait in `_pending_seeds` for a second."""
        m = self.map
        M = len(feats.xy)
        free = (m.kp_pt[slot, :M] < 0) & feats.valid[:M]
        idx = np.nonzero(free)[0]
        if len(idx) == 0:
            return 0
        d = sample_depth_bilinear(depth, feats.xy[idx])
        ok = np.isfinite(d) & (d > 0)
        idx, d = idx[ok], d[ok]
        if len(idx) > self.cfg.depth_landmarks_max:
            order = np.argsort(feats.sigma2[idx], kind="stable")
            order = np.sort(order[: self.cfg.depth_landmarks_max])
            idx, d = idx[order], d[order]
        pose = np_se3.rt6_inverse(m.kf_pose[slot])
        K = self.K4
        xc = np.stack([
            (feats.xy[idx, 0] - K[2]) / K[0] * d,
            (feats.xy[idx, 1] - K[3]) / K[1] * d,
            d,
        ], -1)
        R = np_se3.aa_to_R(pose[:3])
        xw = xc @ R.T + pose[3:]
        img = getattr(self, "_cur_image", None)
        cols = sample_color_bilinear(img, feats.xy[idx]) if img is not None else None
        dist = np.linalg.norm(xc, axis=1)
        n = 0
        for i, kp in enumerate(idx):
            # first_kf=-1: exempt from the recent-point culling window (a
            # seed waits several keyframes for its second observation)
            pt = m.add_point(xw[i], desc=feats.desc[kp], first_kf=-1)
            if m.add_observation(pt, slot, int(kp)) != 1:
                m.erase_point(pt)
                continue
            m.set_point_scale_bounds(pt, float(dist[i]), feats.octave[kp],
                                     self.cfg.scale_factor, self.cfg.n_levels)
            if cols is not None:
                m.pt_color[pt] = cols[i]
            self._pending_seeds.append(int(pt))
            n += 1
        return n

    def _live_pending_seeds(self, pend):
        """The seeds of `pend` still active and still with < 2 observations."""
        m = self.map
        pend = pend[m.pt_active[pend] == 1]
        if len(pend):
            pend = pend[m.point_obs_counts(pend) < 2]
        return pend

    def _densify_pending_seeds(self, slot, feats: FrameFeatures):
        """Projection-guided second observations for the pending seeds:
        project each into the new keyframe, take the nearest landmark-free
        keypoint within track_window_px, keep it if its descriptor is within
        search_max_dist and the transfer gates pass (the first seed per
        keypoint wins). Returns the observations added."""
        m = self.map
        cfg = self.cfg
        if not self._pending_seeds:
            return 0
        pend = self._live_pending_seeds(np.asarray(self._pending_seeds, np.int64))
        if len(pend) == 0:
            self._pending_seeds = []
            return 0
        M = len(feats.xy)
        free_kp = np.nonzero((m.kp_pt[slot, :M] < 0) & feats.valid[:M])[0]
        n_added = 0
        if len(free_kp):
            kp_xy = feats.xy[free_kp]
            K = self.K4
            extr = m.kf_pose[slot]
            R = np_se3.aa_to_R(extr[:3])
            for s in range(0, len(pend), 2048):  # chunk the [P, F] window
                blk = pend[s:s + 2048]
                X = m.pt_pos[blk].astype(np.float64)
                xc = X @ R.T + extr[3:]
                z = xc[:, 2]
                zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
                u = K[0] * xc[:, 0] / zs + K[2]
                v = K[1] * xc[:, 1] / zs + K[3]
                vis = ((z > 0.05) & (u >= 0) & (u < self.width)
                       & (v >= 0) & (v < self.height))
                sv = np.nonzero(vis)[0]
                if len(sv) == 0:
                    continue
                uv_pred = np.stack([u[sv], v[sv]], -1)
                d2 = ((uv_pred[:, None, :] - kp_xy[None, :, :]) ** 2).sum(-1)
                j = np.argmin(d2, axis=1)
                near = d2[np.arange(len(sv)), j] < cfg.track_window_px ** 2
                sv, j = sv[near], j[near]
                if len(sv) == 0:
                    continue
                kp = free_kp[j]
                dd = hamming_rows(m.pt_desc[blk[sv]], feats.desc[kp])
                okd = dd < cfg.search_max_dist
                sv, kp = sv[okd], kp[okd]
                if len(sv) == 0:
                    continue
                gate = self._transfer_gate(blk[sv], slot, kp)
                sv, kp = sv[gate], kp[gate]
                _, first = np.unique(kp, return_index=True)
                for i in first:
                    if m.add_observation(int(blk[sv[i]]), slot, int(kp[i])) == 1:
                        n_added += 1
        self._pending_seeds = [int(p) for p in self._live_pending_seeds(pend)]
        return n_added

    # ------------------------------------------------------------------
    # neighbourhood search & fusion
    # ------------------------------------------------------------------

    def _transfer_gate(self, pt_ids, kf, kp_ids):
        """Cheirality, chi2 < 5.991, scale envelope and viewing-angle gates
        for adding landmark observations to keyframe `kf`."""
        m = self.map
        if len(pt_ids) == 0:
            return np.zeros(0, bool)
        X = m.pt_pos[pt_ids].astype(np.float64)
        extr = m.kf_pose[kf]
        R = np_se3.aa_to_R(extr[:3])
        center = np_se3.rt6_inverse(extr)[3:]
        xc = X @ R.T + extr[3:]
        z = xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        K = self.K4
        u = K[0] * xc[:, 0] / zs + K[2]
        v = K[1] * xc[:, 1] / zs + K[3]
        uv_kp = m.kp_xy[kf, kp_ids]
        sig2 = m.kp_sigma2[kf, kp_ids]
        chi2 = ((u - uv_kp[:, 0]) ** 2 + (v - uv_kp[:, 1]) ** 2) / np.maximum(sig2, 1e-12)
        ok = (z > 0) & (chi2 < 5.991)
        dist = np.linalg.norm(X - center, axis=1)
        dmin = m.pt_dmin[pt_ids]
        dmax = m.pt_dmax[pt_ids]
        has_env = np.isfinite(dmax) & (dmax > 0)
        ok &= ~has_env | ((dist > 0.8 * dmin) & (dist < 1.2 * dmax))
        dirs = m.point_view_dirs(pt_ids)
        cur = X - center
        cur = cur / np.maximum(np.linalg.norm(cur, axis=1)[:, None], 1e-12)
        has_dir = np.linalg.norm(dirs, axis=1) > 0.5
        ok &= ~has_dir | (np.sum(dirs * cur, axis=1) > 0.5)
        return ok

    def search_in_neighbors(self, kf, feats: FrameFeatures):
        with self.timers.phase("search_in_neighbors"):
            return self._search_in_neighbors(kf, feats)

    def _search_in_neighbors(self, kf, feats: FrameFeatures):
        """Re-match the new keyframe against its covisibility neighbourhood
        (20 best covisible + 5 best of each): transfer observations, fuse
        duplicate landmarks, triangulate new ones."""
        m = self.map
        n1, _ = m.best_covisible(kf, self.cfg.neighbor_search_n1)
        neighborhood = []
        seen = {kf}
        for nb in n1:
            if int(nb) not in seen:
                neighborhood.append(int(nb))
                seen.add(int(nb))
            n2, _ = m.best_covisible(int(nb), self.cfg.neighbor_search_n2)
            for nb2 in n2:
                if int(nb2) not in seen:
                    neighborhood.append(int(nb2))
                    seen.add(int(nb2))
        if not neighborhood:
            return {"fused": 0, "transferred": 0, "triangulated": 0}

        # one kernel-A launch over all neighbours (batch axis)
        descs_b = np.stack([m.kp_desc[nb] for nb in neighborhood])
        valids_b = np.zeros((len(neighborhood), m.max_kp), bool)
        for bi, nb in enumerate(neighborhood):
            valids_b[bi, : m.kf_nkp[nb]] = True
        with self.timers.phase("match"):
            desc_a, valid_a = self._dev_desc(feats)
            idx_all, _ = match_descriptors_batch(
                desc_a, self._t(descs_b), valid_a=valid_a,
                valids_b=self._t(valids_b), ratio=self.cfg.match_ratio,
                max_dist=self.cfg.search_max_dist)
            idx_all = idx_all.cpu().numpy()

        n_fused = n_transfer = 0
        tri_jobs = []
        for bi, nb in enumerate(neighborhood):
            nk = m.kf_nkp[nb]
            nf = FrameFeatures(xy=m.kp_xy[nb, :nk], octave=m.kp_octave[nb, :nk],
                               sigma2=m.kp_sigma2[nb, :nk],
                               desc=m.kp_desc[nb, :nk], valid=np.ones(nk, bool))
            idx = idx_all[bi]
            kp_cur = np.nonzero(idx >= 0)[0]
            kp_nb = idx[kp_cur]
            pt_cur = m.kp_pt[kf, kp_cur]
            pt_nb = m.kp_pt[nb, kp_nb]
            # fuse distinct landmarks only when each reprojects onto the other
            # frame's matched keypoint
            both = np.nonzero((pt_cur >= 0) & (pt_nb >= 0) & (pt_cur != pt_nb))[0]
            if len(both):
                g1 = self._transfer_gate(pt_nb[both], kf, kp_cur[both])
                g2 = self._transfer_gate(pt_cur[both], nb, kp_nb[both])
                both = both[g1 & g2]
            for i in both:
                a, b = int(pt_cur[i]), int(pt_nb[i])
                if m.point_obs_count(a) >= m.point_obs_count(b):
                    m.fuse_points(a, b)
                else:
                    m.fuse_points(b, a)
                n_fused += 1
            nb_only = np.nonzero((pt_cur < 0) & (pt_nb >= 0))[0]
            gate = self._transfer_gate(pt_nb[nb_only], kf, kp_cur[nb_only])
            for i in nb_only[gate]:
                if m.add_observation(int(pt_nb[i]), kf, int(kp_cur[i])) == 1:
                    n_transfer += 1
            cur_only = np.nonzero((pt_cur >= 0) & (pt_nb < 0))[0]
            gate2 = self._transfer_gate(pt_cur[cur_only], nb, kp_nb[cur_only])
            for i in cur_only[gate2]:
                if m.add_observation(int(pt_cur[i]), nb, int(kp_nb[i])) == 1:
                    n_transfer += 1
            none_have = (pt_cur < 0) & (pt_nb < 0)
            if none_have.any():
                tri_jobs.append((nb, kp_cur[none_have], kp_nb[none_have], nf))
        n_tri = self._triangulate_neighbors(kf, feats, tri_jobs,
                                            image=getattr(self, "_cur_image", None))
        return {"fused": n_fused, "transferred": n_transfer, "triangulated": n_tri}

    # ------------------------------------------------------------------
    # per-frame tracking
    # ------------------------------------------------------------------

    def _track_local_map(self, feats, extr, assoc_pt, assoc_kp):
        """Guided matching against the projected map: project the active
        >= 2-observation landmarks at `extr`, match their descriptors to the
        still-unassociated keypoints (ratio 0.9, search_max_dist) inside a
        pixel window, and return the enlarged association set."""
        m = self.map
        cfg = self.cfg
        cand = m.active_points()
        if len(cand) == 0:
            return assoc_pt, assoc_kp
        X = m.pt_pos[cand].astype(np.float64)
        R = np_se3.aa_to_R(extr[:3])
        xc = X @ R.T + extr[3:]
        z = xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        K = self.K4
        u = K[0] * xc[:, 0] / zs + K[2]
        v = K[1] * xc[:, 1] / zs + K[3]
        margin = cfg.track_window_px
        vis = ((z > 0.05) & (u >= -margin) & (u < self.width + margin)
               & (v >= -margin) & (v < self.height + margin))
        vis &= ~np.isin(cand, assoc_pt)
        cand_vis = cand[vis]
        uv_vis = np.stack([u[vis], v[vis]], -1)
        well = (m.point_obs_counts(cand_vis) >= 2 if len(cand_vis)
                else np.zeros(0, bool))
        cand = cand_vis[well]
        if len(cand) == 0:
            return assoc_pt, assoc_kp
        uv_pred = uv_vis[well]
        kp_free = feats.valid.copy()
        kp_free[assoc_kp] = False
        desc_b, _ = self._dev_desc(feats)
        idx, _dist = match_descriptors_fused(
            self._t(m.pt_desc[cand]), desc_b, valid_b=self._t(kp_free),
            ratio=0.9, max_dist=cfg.search_max_dist)
        idx = idx.cpu().numpy()
        hit = idx >= 0
        if not hit.any():
            return assoc_pt, assoc_kp
        d_px = np.linalg.norm(feats.xy[idx[hit]] - uv_pred[hit], axis=1)
        keep = d_px < cfg.track_window_px
        return (np.concatenate([assoc_pt, cand[hit][keep].astype(np.int64)]),
                np.concatenate([assoc_kp, idx[hit][keep].astype(np.int64)]))

    def _predict_extr(self):
        """Constant-velocity model."""
        if self.prev_extr is None:
            return self.last_extr.copy()
        vel = np_se3.rt6_compose(self.last_extr, np_se3.rt6_inverse(self.prev_extr))
        return np_se3.rt6_compose(vel, self.last_extr)

    def _reproj_gate(self, extr, assoc_pt, assoc_kp, feats):
        """Cheirality + chi2 < 5.991 acceptance of 2D-3D associations against
        a pose estimate, applied before observation writes."""
        if len(assoc_pt) == 0:
            return np.zeros(0, bool)
        X = self.map.pt_pos[assoc_pt].astype(np.float64)
        R = np_se3.aa_to_R(extr[:3])
        xc = X @ R.T + extr[3:]
        z = xc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        K = self.K4
        u = K[0] * xc[:, 0] / zs + K[2]
        v = K[1] * xc[:, 1] / zs + K[3]
        uv = feats.xy[assoc_kp]
        sig2 = np.maximum(feats.sigma2[assoc_kp], 1e-12)
        chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / sig2
        return (z > 0) & (chi2 < 5.991)

    def _pnp_guard(self, extr, inl, pred_extr):
        """estimation="pnp": a translation jump of pnp_translation_guard or
        more from the prediction keeps the prediction, with no inliers."""
        if (self.cfg.estimation == "pnp" and np.linalg.norm(
                extr[3:] - pred_extr[3:]) >= self.cfg.pnp_translation_guard):
            return pred_extr, np.zeros(len(inl), bool)
        return extr, inl

    def _estimate_pose(self, cur_feats, assoc_pt, assoc_kp, pred_extr, matches):
        """Dispatch on cfg.estimation: motion-only BA over the 2D-3D
        associations ("ba" robust, "pnp" plain with the translation guard),
        or the two-view pose from the last frame's matches."""
        cfg = self.cfg
        none = np.zeros(len(assoc_pt), bool)
        if cfg.estimation in ("ba", "pnp"):
            if len(assoc_pt) < cfg.min_track_points:
                return pred_extr, none
            extr, inl = self.motion_only(
                pred_extr, self.map.pt_pos[assoc_pt], cur_feats.xy[assoc_kp],
                cur_feats.sigma2[assoc_kp], robust=cfg.estimation == "ba")
            return self._pnp_guard(extr, inl, pred_extr)
        lf = self.last_feats
        pair_last = np.nonzero(matches >= 0)[0]
        if len(pair_last) < 30:
            return pred_extr, none
        res = self._two_view(lf.xy[pair_last], cur_feats.xy[matches[pair_last]])
        if not bool(res.ok):
            # recovery failed (E-path <= 100 inliers / empty H decomposition):
            # keep the constant-velocity prediction, write no observations
            return pred_extr, none
        rel = res.rt6.astype(np.float64)
        # scale the unit translation with the constant-velocity prior
        # (monocular two-view scale is unobservable)
        pred_rel = np_se3.rt6_compose(pred_extr, np_se3.rt6_inverse(self.last_extr))
        scale = np.linalg.norm(pred_rel[3:])
        rel[3:] *= scale if scale > 1e-9 else 1.0
        extr = np_se3.rt6_compose(rel, self.last_extr)
        # gate observation writes with the chi2 reprojection test against
        # the recovered pose: ungated writes poison the map
        return extr, self._reproj_gate(extr, assoc_pt, assoc_kp, cur_feats)

    def predetect_features(self, frames, group=None, chunk=32):
        """Data-parallel frame frontend: detect every frame up front, `chunk`
        frames a pass, the frame axis dealt over the ranks of `group` when
        given (`parallel/frontend.py`). The tracking loop consumes the result
        through `process_frames(..., prefeats=...)`. Returns one
        FrameFeatures a frame: host arrays, and the descriptors and validity
        also on the device (`desc_dev`, `valid_dev`), so matching uploads
        nothing."""
        from bundleadjustment_tpu_torch.parallel.frontend import detect_batch_sharded

        out = []
        grays = [np.asarray(f.gray, np.float32) for f in frames]
        for s in range(0, len(grays), chunk):
            block = np.stack(grays[s:s + chunk])
            with self.timers.phase("detect"):
                f = detect_batch_sharded(block, self.feat_cfg, group=group,
                                         device=self.device)
                xy, octave, sigma2, desc, valid = (
                    t.cpu().numpy() for t in (f.xy, f.octave, f.sigma2, f.desc,
                                              f.valid))
            for k in range(block.shape[0]):
                out.append(FrameFeatures(
                    xy=xy[k], octave=octave[k], sigma2=sigma2[k],
                    desc=desc[k].view(np.uint32), valid=valid[k],
                    desc_dev=f.desc[k], valid_dev=f.valid[k]))
        return out

    def process_frames(self, frames, timings=None, max_frames=None,
                       prefeats=None):
        """Process an iterable of FrameData one frame at a time, stopping
        after "tracking-lost"; `prefeats` (from `predetect_features`) gives
        each frame's features, so its tracking only matches and estimates
        (the split path). Returns the per-frame statuses; `timings`, if
        given, receives each frame's wall time. (The JAX package's
        microbatch branch, `track_batch > 1`, is not ported; `max_frames`,
        which only that branch's callers set, is kept so that the signature
        matches the JAX package's.)"""
        import time

        statuses = []
        pfs = iter(prefeats) if prefeats is not None else None
        for f in frames:
            if max_frames is not None and len(statuses) >= max_frames:
                break
            t0 = time.perf_counter()
            s = self.process_frame(f, prefeats=None if pfs is None else next(pfs))
            if timings is not None:
                timings.append(time.perf_counter() - t0)
            statuses.append(s)
            if s == "tracking-lost":
                break
        return statuses

    def process_frame(self, frame, prefeats=None):
        """Process one FrameData. Returns a status string. `prefeats` (from
        `predetect_features`) carries the frame's features: it is matched
        against the previous frame through kernel A and tracked by the split
        path."""
        cfg = self.cfg
        m = self.map
        prev = self.last_feats if self.initialized else self.ref_feats
        fused_rt = fused_inl = assoc_ok = pred_extr = None
        if prefeats is not None:
            feats = prefeats
            matches = dists = None
            if prev is not None:
                with self.timers.phase("frontend"):
                    idx, dist = self._match_prev(*self._dev_desc(feats), prev)
                    matches, dists = idx.cpu().numpy(), dist.cpu().numpy()
        elif (self.initialized and cfg.estimation in ("ba", "pnp")
                and self._prev_track is not None):
            pred_extr = self._predict_extr()
            feats, matches, dists, assoc_ok, fused_rt, fused_inl = (
                self._track_fused(frame.gray, prev, pred_extr))
        elif prev is not None:
            feats, matches, dists = self.detect_and_match(frame.gray, prev)
        else:
            feats = self.detect(frame.gray)
            matches = dists = None
        self._cur_image = frame.rgb if frame.rgb is not None else frame.gray
        slot = m.add_frame(frame.timestamp, np.zeros(6), feats.xy, feats.octave,
                           feats.sigma2, feats.desc,
                           gt_pose44=frame.gt_cam_to_world)
        self.stats["frames"] += 1

        if not self.initialized:
            if self.ref_slot is None:
                self.ref_slot = slot
                self.ref_feats = feats
                self._ref_depth = frame.depth
                self._ref_image = self._cur_image
                return "ref"
            if int((matches >= 0).sum()) <= cfg.min_init_matches:
                m.erase_frame(slot)
                return "await-init"
            if cfg.init_type == "gtdepth":
                ok = self._init_gtdepth(slot, feats, self._ref_depth, matches, dists)
            else:
                ok = self._init_standard(slot, feats, matches, dists)
            if ok:
                self.initialized = True
                self._last_kf_slot = slot
                self.last_slot = slot
                self.last_feats = feats
                self._capture_track_state(slot, feats)
                self.last_extr = m.kf_pose[slot].copy()
                self.prev_extr = m.kf_pose[self.ref_slot].copy()
                self.trajectory.append(TrackRecord(
                    m.kf_timestamp[self.ref_slot], self.ref_slot,
                    m.kf_pose[self.ref_slot].copy(), True))
                self.trajectory.append(TrackRecord(
                    frame.timestamp, slot, self.last_extr.copy(), True))
                self.stats["keyframes"] += 2
                return "initialized"
            # failed bootstrap: the current frame becomes the reference
            m.erase_frame(self.ref_slot)
            for pt in m.active_points():
                if m.point_obs_count(int(pt)) == 0:
                    m.erase_point(int(pt))
            self.ref_slot = slot
            self.ref_feats = feats
            self._ref_depth = frame.depth
            self._ref_image = self._cur_image
            return "ref-reset"

        # ---- tracking ----
        n_matches = max(int((matches >= 0).sum()), 1)
        pair_last = np.nonzero(matches >= 0)[0]
        lp = m.kp_pt[self.last_slot, pair_last]
        has_pt = (lp >= 0) & (dists[pair_last] < cfg.assoc_max_dist)
        if assoc_ok is not None:
            ok_idx = np.nonzero(assoc_ok)[0]
            assoc_pt = m.kp_pt[self.last_slot, ok_idx].astype(np.int64)
            assoc_kp = matches[ok_idx].astype(np.int64)
        else:  # first tracked frame without captured state
            pair_cur = matches[pair_last]
            assoc_pt = lp[has_pt].astype(np.int64)
            assoc_kp = pair_cur[has_pt].astype(np.int64)
            well = (m.point_obs_counts(assoc_pt) >= 2 if len(assoc_pt)
                    else np.zeros(0, bool))
            assoc_pt, assoc_kp = assoc_pt[well], assoc_kp[well]

        assoc_ratio = int(has_pt.sum()) / n_matches
        if assoc_ratio <= cfg.tracking_fail_ratio:
            self.stats["tracking_failures"] += 1
            return "tracking-lost"

        if pred_extr is None:
            pred_extr = self._predict_extr()
        if fused_rt is not None:
            if len(assoc_pt) < cfg.min_track_points:
                extr, inl = pred_extr, np.zeros(len(assoc_pt), bool)
            else:
                extr, inl = self._pnp_guard(fused_rt, fused_inl[ok_idx], pred_extr)
        else:
            extr, inl = self._estimate_pose(feats, assoc_pt, assoc_kp, pred_extr,
                                            matches)

        # guided local-map second pass, then re-estimate
        if cfg.track_local_map and cfg.estimation in ("ba", "pnp"):
            assoc_pt2, assoc_kp2 = self._track_local_map(feats, extr, assoc_pt,
                                                         assoc_kp)
            if len(assoc_pt2) > len(assoc_pt):
                extr2, inl2 = self._estimate_pose(feats, assoc_pt2, assoc_kp2,
                                                  extr, matches)
                if inl2.sum() >= inl.sum():
                    extr, inl = extr2, inl2
                    assoc_pt, assoc_kp = assoc_pt2, assoc_kp2

        m.set_pose(slot, extr)
        inl_idx = np.nonzero(inl)[0]
        for i in inl_idx:
            m.add_observation(int(assoc_pt[i]), slot, int(assoc_kp[i]))
        m.refresh_point_descriptors(assoc_pt[inl_idx])

        ref_kf = self._last_kf_slot
        rel = (np_se3.rt6_compose(extr, np_se3.rt6_inverse(m.kf_pose[ref_kf]))
               if ref_kf is not None and m.kf_active[ref_kf] else None)
        self.trajectory.append(TrackRecord(
            frame.timestamp, slot, extr.copy(), False, ref_kf=ref_kf, rel=rel,
            assoc_pt=assoc_pt[inl_idx].copy(),
            assoc_uv=feats.xy[assoc_kp[inl_idx]].copy(),
            assoc_sig=feats.sigma2[assoc_kp[inl_idx]].copy(),
            feats=(FrameFeatures(xy=feats.xy, octave=feats.octave,
                                 sigma2=feats.sigma2, desc=feats.desc,
                                 valid=feats.valid)
                   if cfg.refine_guided else None),
            assoc_kp=assoc_kp[inl_idx].copy() if cfg.refine_guided else None))

        is_keyframe = assoc_ratio <= cfg.keyframe_ratio
        if cfg.track_local_map and not is_keyframe:
            # keyframe need: inlier decay vs the last keyframe, max interval
            self._frames_since_kf += 1
            ref = self._kf_ref_inliers
            if ref is not None and int(np.sum(inl)) < cfg.kf_ref_decay * ref:
                is_keyframe = True
            elif self._frames_since_kf >= cfg.kf_max_interval:
                is_keyframe = True
        if is_keyframe:
            m.set_keyframe(slot)
            self.kf_counter += 1
            self.stats["keyframes"] += 1
            self.trajectory[-1].is_keyframe = True
            self._kf_ref_inliers = max(int(np.sum(inl)), cfg.min_track_points)
            self._frames_since_kf = 0
            self._last_kf_slot = slot
            m.cull_recent_points(self.kf_counter, cfg.cull_point_window,
                                 cfg.cull_point_min_obs)
            self._triangulate_pairs(self.last_slot, slot, self.last_feats, feats,
                                    matches, image=self._cur_image,
                                    image_side="b")
            m.update_covisibility(slot, cfg.covis_threshold)
            # depth seeding before the neighbourhood search, so its gated
            # transfers cover the new seeds too; pending seeds of earlier
            # keyframes first get their guided chance at the free keypoints
            if cfg.depth_landmarks:
                self._densify_pending_seeds(slot, feats)
                if frame.depth is not None:
                    self._seed_depth_landmarks(slot, feats, frame.depth)
            self.search_in_neighbors(slot, feats)
            m.refresh_frame_points(slot)
            m.update_covisibility(slot, cfg.covis_threshold)
            if cfg.local_ba:
                self.local_ba(slot)
            else:
                self.global_ba()
            if cfg.cull_frames:
                m.cull_redundant_keyframes(cfg.cull_kf_redundancy,
                                           cfg.cull_kf_min_other)

        if self.last_slot is not None and not m.kf_is_keyframe[self.last_slot]:
            m.erase_frame(self.last_slot)
        self.prev_extr = self.last_extr
        self.last_extr = m.kf_pose[slot].copy()
        self.last_slot = slot
        self.last_feats = feats
        self._capture_track_state(slot, feats)
        return "keyframe" if is_keyframe else "tracked"

    # ------------------------------------------------------------------
    # finalize
    # ------------------------------------------------------------------

    def finalize(self):
        """Final global BA (final_ba_outer rounds), then trajectory
        refinement of the tracked (non-key) frames, twice with refine_guided."""
        for _ in range(self.cfg.final_ba_outer):
            self.global_ba(self.cfg.final_ba_iters)
        self._refine_trajectory()
        if self.cfg.refine_guided:
            self._refine_trajectory()

    def _refine_trajectory(self):
        """Re-solve every tracked frame by batched motion-only BA against the
        BA-refined map (after a guided re-association with refine_guided),
        accepting a re-solve only where the tracking-time pose is demonstrably
        broken and the re-solve fixes it (the reference's acceptance rules)."""
        m = self.map
        cfg = self.cfg
        if len(m.active_keyframes()) < 3:
            return
        recs = [r for r in self.trajectory
                if not r.is_keyframe and r.assoc_pt is not None
                and len(r.assoc_pt) >= cfg.min_track_points]
        if not recs:
            return
        n_orig = {}
        if cfg.refine_guided:
            for rec in recs:
                if rec.feats is None or rec.assoc_kp is None:
                    continue
                live = m.pt_active[rec.assoc_pt] == 1
                ap = rec.assoc_pt[live].astype(np.int64)
                ak = rec.assoc_kp[live].astype(np.int64)
                ap2, ak2 = self._track_local_map(rec.feats, self._record_extr(rec),
                                                 ap, ak)
                if len(ap2) > len(ap):
                    n_orig[id(rec)] = len(ap)
                    rec.assoc_pt = ap2
                    rec.assoc_kp = ak2
                    rec.assoc_uv = rec.feats.xy[ak2].copy()
                    rec.assoc_sig = rec.feats.sigma2[ak2].copy()
        M = cfg.max_track_obs
        B = len(recs)
        P = np.zeros((B, M, 3), np.float32)
        U = np.zeros((B, M, 2), np.float32)
        S = np.ones((B, M), np.float32)
        V = np.zeros((B, M), bool)
        ORIG = np.zeros((B, M), bool)
        E0 = np.zeros((B, 6), np.float32)
        for b, rec in enumerate(recs):
            live = np.nonzero(m.pt_active[rec.assoc_pt] == 1)[0]
            if len(live) > M:
                order = np.argsort(rec.assoc_sig[live], kind="stable")
                live = np.sort(live[order[:M]])
            n = len(live)
            P[b, :n] = m.pt_pos[rec.assoc_pt[live]]
            U[b, :n] = rec.assoc_uv[live]
            S[b, :n] = rec.assoc_sig[live]
            V[b, :n] = True
            ORIG[b, :n] = live < n_orig.get(id(rec), len(rec.assoc_pt))
            E0[b] = self._record_extr(rec)
        rt, inl = self._motion_only_batch(E0, P, U, S, V)

        def project(extr, b):
            R = np_se3.aa_to_R(extr[:3])
            xc = P[b] @ R.T + extr[3:]
            z = xc[:, 2]
            zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
            u = self.K4[0] * xc[:, 0] / zs + self.K4[2]
            v = self.K4[1] * xc[:, 1] / zs + self.K4[3]
            r2 = ((u - U[b, :, 0]) ** 2 + (v - U[b, :, 1]) ** 2) / np.maximum(S[b], 1e-12)
            return r2, z

        def huber_cost(extr, b):
            r2, z = project(extr, b)
            d = 2.4477
            nrm = np.sqrt(np.maximum(r2, 1e-20))
            rho = np.where(nrm <= d, 0.5 * r2, d * (nrm - 0.5 * d))
            rho = np.where(z > 1e-6, rho, 1e4)
            return float(np.sum(np.where(V[b], rho, 0.0)))

        def chi2_inlier_count(extr, b, mask):
            chi2, z = project(extr, b)
            return int(np.sum(V[b] & mask & (chi2 < 5.991) & (z > 1e-6)))

        centers = np.asarray([
            np_se3.rt6_to_mat44(np_se3.rt6_inverse(self._record_extr(r)))[:3, 3]
            for r in self.trajectory])
        steps = np.linalg.norm(np.diff(centers, axis=0), axis=1)
        if V.any():
            eps = 0.01 * float(np.median(np.linalg.norm(P[V] - centers.mean(axis=0),
                                                        axis=1)))
        else:
            eps = 1e-3
        guard = max(3.0 * float(np.median(steps)), eps) if len(steps) else np.inf
        for b, rec in enumerate(recs):
            n_constr = int(V[b].sum())
            n_inl = int(inl[b].sum())
            if n_inl < max(cfg.min_track_points, 0.5 * n_constr):
                continue
            extr_cur = self._record_extr(rec)
            c_old = np_se3.rt6_to_mat44(np_se3.rt6_inverse(extr_cur))[:3, 3]
            c_new = np_se3.rt6_to_mat44(np_se3.rt6_inverse(rt[b]))[:3, 3]
            strong = n_inl >= 3 * cfg.min_track_points and n_inl >= 0.8 * n_constr
            disp = np.linalg.norm(c_new - c_old)
            if disp > guard and not (strong and disp <= 10.0 * guard):
                continue
            n_live_orig = int(np.sum(V[b] & ORIG[b]))
            if n_live_orig < cfg.min_track_points:
                continue
            n_old_orig = chi2_inlier_count(extr_cur, b, ORIG[b])
            if n_old_orig >= 0.75 * n_live_orig:
                continue
            if chi2_inlier_count(rt[b], b, ORIG[b]) <= n_old_orig:
                continue
            if huber_cost(rt[b], b) < huber_cost(extr_cur, b):
                rec.extr = rt[b]
                rec.refined = True
                if rec.ref_kf is not None and m.kf_active[rec.ref_kf]:
                    rec.rel = np_se3.rt6_compose(
                        rt[b], np_se3.rt6_inverse(m.kf_pose[rec.ref_kf]))
                else:
                    rec.rel = None

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def _record_extr(self, rec):
        """The record's current best pose: keyframes read the map; tracked
        frames ride their reference keyframe through the stored transform."""
        if rec.is_keyframe and self.map.kf_active[rec.slot]:
            return self.map.kf_pose[rec.slot]
        if rec.rel is not None and rec.ref_kf is not None and self.map.kf_active[rec.ref_kf]:
            return np_se3.rt6_compose(rec.rel, self.map.kf_pose[rec.ref_kf])
        return rec.extr

    def trajectory_cam_to_world(self, smooth=True):
        """(timestamps, cam->world 4x4) for every tracked frame.

        Keyframes read the BA-refined map; tracked frames ride their
        keyframes with segment-interpolated world corrections (the correction
        at the previous keyframe blended in time with the one observed at the
        next keyframe). A record whose re-solve `finalize` accepted gives its
        refined pose (`_record_extr`) as it is: that pose was solved against
        the BA-refined map, so a keyframe correction blended onto it would
        count the BA's correction twice (the JAX package blends it in all
        the same). smooth=False returns the causal trajectory."""
        m = self.map
        traj = self.trajectory
        n = len(traj)
        act = [r.is_keyframe and m.kf_active[r.slot] for r in traj]
        inv, comp = np_se3.rt6_inverse, np_se3.rt6_compose
        if not smooth:
            ts = np.asarray([r.timestamp for r in traj])
            mats = np.asarray([np_se3.rt6_to_mat44(inv(
                m.kf_pose[r.slot] if act[i] else r.extr))
                for i, r in enumerate(traj)])
            return ts, mats
        next_kf = [None] * n
        nk = None
        for i in range(n - 1, -1, -1):
            if act[i]:
                nk = i
            next_kf[i] = nk
        prev_kf = [None] * n
        pk = None
        for i in range(n):
            if act[i]:
                pk = i
            prev_kf[i] = pk
        ts, mats = [], []
        for i, rec in enumerate(traj):
            if act[i]:
                extr = m.kf_pose[rec.slot]
            elif rec.refined:
                extr = self._record_extr(rec)
            else:
                w_a = None
                if rec.rel is not None and rec.ref_kf is not None and m.kf_active[rec.ref_kf]:
                    kfA_r = comp(inv(rec.rel), rec.extr)
                    w_a = comp(inv(kfA_r), m.kf_pose[rec.ref_kf])
                elif prev_kf[i] is not None:
                    prec = traj[prev_kf[i]]
                    w_a = comp(inv(prec.extr), m.kf_pose[prec.slot])
                if w_a is None:
                    extr = rec.extr
                else:
                    w = w_a
                    j, p = next_kf[i], prev_kf[i]
                    if j is not None and p is not None:
                        nrec = traj[j]
                        w_b = comp(inv(nrec.extr), m.kf_pose[nrec.slot])
                        span = nrec.timestamp - traj[p].timestamp
                        if span > 1e-9:
                            s = np.clip((rec.timestamp - traj[p].timestamp) / span,
                                        0.0, 1.0)
                            w = (1.0 - s) * w_a + s * w_b
                    extr = comp(rec.extr, w)
            ts.append(rec.timestamp)
            mats.append(np_se3.rt6_to_mat44(inv(extr)))
        return np.asarray(ts), np.asarray(mats)

    def map_points(self):
        return self.map.pt_pos[self.map.active_points()].copy()

    def map_points_colored(self):
        ids = self.map.active_points()
        return self.map.pt_pos[ids].copy(), self.map.pt_color[ids].copy()

    def run(self, dataset, predetect=False, group=None):
        """Track every frame of `dataset` (up to cfg.max_frames), stopping at
        tracking loss, then finalize. Returns the stats dict.

        predetect=True: detect every frame first with the data-parallel
        batched frontend (the frame axis over the ranks of `group` when
        given), then track each frame by matching and estimation only."""
        if predetect:
            frames = []
            for i, frame in enumerate(dataset):
                if i >= self.cfg.max_frames:
                    break
                frames.append(frame)
            pf = self.predetect_features(frames, group=group)
            statuses = self.process_frames(frames, prefeats=pf)
            if self.cfg.verbose:
                for i, status in enumerate(statuses):
                    print(f"[{i:4d}] {status}")
        else:
            for i, frame in enumerate(dataset):
                if i >= self.cfg.max_frames:
                    break
                status = self.process_frame(frame)
                if self.cfg.verbose:
                    print(f"[{i:4d}] {status}  kfs={self.stats['keyframes']} "
                          f"pts={len(self.map.active_points())}")
                if status == "tracking-lost":
                    break
        self.finalize()
        self.stats["phase_times"] = self.timers.report()
        return self.stats
