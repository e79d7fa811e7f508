"""Pipeline configuration, mirroring the reference CLI surface.

Reference flags (`ba_project/src/main.cpp:27-44`): --init-type --estimation
--faces-type --dataset-name --dataset-path --output-path --local-ba --frames
--reconstruction-error --trajectory --display-pointcloud --cull-frames, with
defaults at `main.cpp:48-64`.  Framework-specific knobs (feature counts,
thresholds, solver iteration budgets) are explicit here instead of constants
scattered through C++.

Copied unchanged from `bundleadjustment_tpu/pipeline/config.py` (numpy only). The JAX
package's `pipeline/__init__.py` imports jax, so the port keeps its own copy
instead of importing it.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PipelineConfig:
    # reference CLI surface
    init_type: str = "gtdepth"  # "standard" | "gtdepth"   (main.cpp:15-16)
    estimation: str = "ba"  # "pnp" | "ba" | "essential_or_homography" (main.cpp:18-20)
    faces_type: str = "standard"  # "standard" | "poisson" | "greedy" (main.cpp:22-24)
    dataset_name: str = "freiburg_xyz"  # freiburg_xyz | freiburg_teddy | replica
    dataset_path: str = ""
    output_path: str = "./out"
    local_ba: bool = True
    max_frames: int = 2000  # --frames (main.cpp default 2000)
    reconstruction_error: bool = False
    write_trajectory: bool = True
    display_pointcloud: bool = False
    cull_frames: bool = False

    # feature frontend
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    detector: str = "fast_harris"
    match_ratio: float = 0.7  # Lowe ratio (FeatureProcessor.cpp:53)
    matcher: str = "auto"  # "auto" | "xla" | "pallas": auto picks the fused
    #                         Pallas kernel on TPU, plain XLA elsewhere
    min_init_matches: int = 100  # BundleAdjustment.cpp:96-109

    # association / search thresholds (Hamming, of 256 bits; the reference's
    # SURF-L2 0.2/0.3 analogues, BundleAdjustment.cpp:129-146 / SfMHelper.cpp)
    assoc_max_dist: float = 50.0
    search_max_dist: float = 64.0

    # tracking / keyframes
    keyframe_ratio: float = 0.1  # BundleAdjustment.cpp:161
    track_local_map: bool = True  # guided map-point projection matching after
    #   the first motion-only pass (beyond the reference, which associates
    #   against the last frame only).  Default ON since round 5: the round-4
    #   A/B over three scene shapes x two seeds improved ONLINE ATE in 11/12
    #   runs (up to 4x: handheld 0.057 -> 0.020, sweep 0.060 -> 0.015) and
    #   final ATE in 10/12 — the round-2 "net neutral" result predates two
    #   frontend rewrites.  Runs inside the device-resident tracking batch
    #   (the _track_batch_jit tlm stage: snapshot projection + guided match
    #   + re-solve, all in the scan), so the batched dispatch amortization
    #   is kept.  See BASELINE.md round 5.
    track_window_px: float = 12.0  # projection search radius (level-0 px)
    tracking_fail_ratio: float = 1e-4  # BundleAdjustment.cpp:157-160
    min_track_points: int = 10
    # keyframe need criteria beyond the reference's association ratio —
    # ACTIVE ONLY when track_local_map is on: guided tracking keeps the
    # last-frame association ratio high even as the local map decays
    # (round-5 sweep: 120-frame handheld runs created 4-6 keyframes and
    # drifted to 0.2-0.3 m ATE), so keyframe need is additionally signaled
    # by inlier-count decay vs the last keyframe (ORB-SLAM's
    # NeedNewKeyFrame reference-matches criterion) and a max interval
    # defaults from the round-5 TPU A/B on the handheld regime: 0.85/15
    # gives 10 keyframes per 120 frames vs 8 at 0.8/20, cutting ONLINE ATE
    # 0.067 -> 0.016 (denser anchors = fresher local map + shorter
    # interpolation segments) and wall time 58 -> 32 s
    kf_ref_decay: float = 0.85
    kf_max_interval: int = 15
    max_track_obs: int = 512  # padded 2D-3D capacity for motion-only BA
    fused_tracking: bool = True  # ba/pnp: run detect+match+associate+motion-
    #   only BA of a tracked frame as ONE device dispatch (latency win on
    #   remote TPUs); False falls back to separate dispatches
    track_batch: int = 8  # device-resident tracking microbatch: process_frames
    #   runs up to this many consecutive tracked frames as ONE lax.scan
    #   dispatch, propagating the per-keypoint landmark association state on
    #   device between frames (SURVEY.md §7 hard part (d): amortizes the
    #   host<->device round-trip of data-dependent keyframe decisions over the
    #   batch).  Frames after the first keyframe/loss in a batch are discarded
    #   and re-run, since the keyframe mutates the map.  <=1 disables.
    pnp_translation_guard: float = 1.0  # ||t|| jump reject (SfMHelper.cpp:76-80)
    refine_guided: bool = True  # finalize-time trajectory refinement: before
    #   re-solving each tracked (non-key) frame against the BA-refined map,
    #   run a guided re-association (project active landmarks at the stored
    #   pose, descriptor-match within track_window_px) so the re-solve sees
    #   the full post-BA constraint set instead of only the sparse tracking-
    #   time inlier list.  Round-3 diagnosis: config-2 full-trajectory ATE
    #   was 2x keyframe-only ATE from per-tracked-frame pose noise around a
    #   consistent map (BASELINE.md).  Stores per-frame keypoints (~160 KB/
    #   frame host RAM); disable for memory-constrained very long runs.

    # covisibility / windows
    covis_threshold: int = 10  # Frame.cpp:327
    local_window: int = 10  # Optimizer.cpp:508
    neighbor_search_n1: int = 20  # SfMHelper.cpp:203-496 first ring
    neighbor_search_n2: int = 5  # second ring

    # solver budgets (reference: per-KF BA 1x10, final 3x100,
    # BundleAdjustment.cpp:196-207,228-230; motion-only 4x20 SfMHelper.cpp:112)
    kf_ba_iters: int = 10
    final_ba_outer: int = 3
    final_ba_iters: int = 100  # reference: 3 outer x 100 Ceres iterations
    #   (BundleAdjustment.cpp:228-230); the LM scan early-freezes converged
    #   iterations so the extra tail is nearly free on TPU
    motion_outer: int = 4
    motion_inner: int = 10
    ba_solver: str = "dense"  # "dense" | "pcg"; pcg for big maps
    ba_layout: str = "auto"  # "auto" | "flat" | "dense_landmark"
    #   dense_landmark is the TPU-optimized exact-Schur layout
    #   (solvers/dense_ba.py; measured ~25x the flat segment-sum engine on
    #   v5e at 64 cams/10k landmarks — BASELINE.md).  "auto" picks
    #   dense_landmark once the problem is big enough to amortize the host-
    #   side regrouping and [L, max_obs] padding, flat below that.
    ba_layout_auto_min_obs: int = 2048
    ba_max_obs_per_pt: int = 16
    pcg_iters: int = 60
    global_ba_mode: str = "single"  # "single" | "windowed" | "sharded":
    #   how global BA solves (per-keyframe when local_ba=False, and the final
    #   3-round solve in finalize) are executed.  "single": one-device
    #   LM/DENSE_SCHUR (reference Optimizer.cpp:93-160 analogue).
    #   "windowed": overlapping keyframe windows vmapped/shard_mapped over
    #   the device mesh + landmark halo psum + pose-graph stitch
    #   (parallel/windows.py).  "sharded": landmark-sharded dense engine with
    #   psummed QQ^T Schur partials (parallel/sharded_dense_ba.py).  Both
    #   distributed modes use all local devices unless a mesh is injected
    #   via `pipeline.global_ba_mesh`.

    # RGB-D landmark seeding at keyframes: backproject keypoints that have no
    # landmark through the frame's depth map (the reference does this once,
    # for the bootstrap reference frame — Initializer.cpp:36-126; RGB-D SLAM
    # practice extends it to every keyframe, which is how BASELINE config-4
    # scale ~10k-landmark maps arise from the pipeline itself)
    depth_landmarks: bool = False
    depth_landmarks_max: int = 2000  # cap of new seeds per keyframe

    # culling
    cull_point_window: int = 4  # SfMHelper.cpp:974-1003
    cull_point_min_obs: int = 3
    cull_kf_redundancy: float = 0.95  # SfMHelper.cpp:1005-1077
    cull_kf_min_other: int = 3

    # capacities
    max_map_frames: int = 2048
    max_map_points: int = 262144

    # misc
    seed: int = 0
    verbose: bool = False

    extra: dict = field(default_factory=dict)
