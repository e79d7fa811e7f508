"""Port parity for RGB-D depth seeding (`depth_landmarks`), on the CPU.

- `hamming_rows`, the port's popcount of XORed descriptor words (the
  reference counts with numpy >= 2's `bitwise_count`), against Python's
  own bit count: equal.
- `_seed_depth_landmarks` and `_densify_pending_seeds` of both pipelines on
  the same map (two copies of one store, built by the same calls): two
  keyframes of a rendered layered scene (320x240) at their true poses,
  the features of one detector. The seeds (ids, order, positions, colours,
  scale bounds), the pending lists and the added observations are equal
  bit for bit: both run the same numpy arithmetic.
- A depth-seeded pipeline run against the JAX pipeline (track_batch=1,
  track_local_map=False and keyframe_ratio 0.25 as in the config-7
  protocol, local BA): the bounds of tests/test_torch_pipeline.py
  (statuses and keyframes equal, map sizes within 2%, |ATE difference| <
  0.01 m; both ATEs under its local-BA keyframe run's 0.2 m: this 160x120
  run gives 0.0601 m on both sides, 1.6e-5 m apart).
"""

import numpy as np
import pytest

from bundleadjustment_tpu.data.synthetic import render_layered_scene
from bundleadjustment_tpu.mapstate import SceneMap as JaxSceneMap
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline as JaxPipeline
from bundleadjustment_tpu.pipeline import PipelineConfig as JaxConfig
from bundleadjustment_tpu.pipeline.driver import FrameFeatures as JaxFeatures
from bundleadjustment_tpu_torch.geometry import np_se3
from bundleadjustment_tpu_torch.mapstate.scene import SceneMap
from bundleadjustment_tpu_torch.pipeline import driver as td
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from torch_port_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_popcount_matches_a_reference_count():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint64).astype(np.uint32)
    a[0], b[0] = 0, 0xFFFFFFFF  # all 256 bits differ
    a[1] = b[1]  # none
    ref = np.array([sum(bin(int(x) ^ int(y)).count("1") for x, y in zip(ra, rb))
                    for ra, rb in zip(a, b)])
    got = td.hamming_rows(a, b)
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 256 and got[1] == 0
    # the map store keeps descriptors as uint32; int32 bit patterns count alike
    np.testing.assert_array_equal(td.hamming_rows(a.view(np.int32), b), ref)


W, H, FX = 320, 240, 262.5
N_FEATURES = 600
SEED_CAP = 250


def _keyframes():
    """Frames 0 and 2 of a forward layered scene: (frames, K4, features of
    both from the port's detector as numpy arrays)."""
    import torch

    from bundleadjustment_tpu_torch.ops.features import (
        FeatureConfig,
        detect_and_describe,
    )

    frames, K4 = render_layered_scene(n_frames=3, width=W, height=H, fx=FX, fy=FX,
                                      trajectory="forward", motion_step=0.04,
                                      seed=11)
    cfg = FeatureConfig(n_features=N_FEATURES, n_levels=4)
    feats = []
    for i in (0, 2):
        f = detect_and_describe(torch.from_numpy(frames[i]["gray"]), cfg)
        feats.append(dict(xy=f.xy.numpy(), octave=f.octave.numpy(),
                          sigma2=f.sigma2.numpy(),
                          desc=f.desc.numpy().view(np.uint32),
                          valid=f.valid.numpy()))
    return frames, K4, feats


def _pipeline_on_map(cls, cfg_cls, map_cls, frames, K4, feats, **kw):
    cfg = cfg_cls(depth_landmarks=True, depth_landmarks_max=SEED_CAP,
                  n_features=N_FEATURES, n_levels=4)
    pipe = cls(cfg, K4, W, H, **kw)
    m = map_cls(max_frames=8, max_points=8192, max_kp=len(feats[0]["xy"]),
                K4=np.asarray(K4, np.float32))
    slots = []
    for i, f in zip((0, 2), feats):
        extr = np_se3.mat44_to_rt6(np.linalg.inv(frames[i]["gt_cam_to_world"]))
        slot = m.add_frame(frames[i]["timestamp"], extr, f["xy"], f["octave"],
                           f["sigma2"], f["desc"])
        m.set_keyframe(slot)
        slots.append(slot)
    pipe.map = m
    pipe._cur_image = frames[0]["gray"]
    return pipe, slots


def _state(pipe, slots, n_kp):
    m = pipe.map
    pend = np.asarray(pipe._pending_seeds, np.int64)
    return dict(pending=pend, pos=m.pt_pos[pend], color=m.pt_color[pend],
                dmin=m.pt_dmin[pend], dmax=m.pt_dmax[pend],
                kp_pt=np.stack([m.kp_pt[s, :n_kp] for s in slots]),
                active=m.active_points())


def test_seed_and_densify_match_jax():
    frames, K4, feats = _keyframes()
    n_kp = len(feats[0]["xy"])
    jpipe, jslots = _pipeline_on_map(JaxPipeline, JaxConfig, JaxSceneMap, frames,
                                     K4, feats)
    tpipe, tslots = _pipeline_on_map(td.BundleAdjustmentPipeline, PipelineConfig,
                                     SceneMap, frames, K4, feats, device="cpu")
    assert jslots == tslots
    a, b = tslots
    fa_j, fb_j = (JaxFeatures(**f) for f in feats)
    fa_t, fb_t = (td.FrameFeatures(**f) for f in feats)

    n_j = jpipe._seed_depth_landmarks(a, fa_j, frames[0]["depth"])
    n_t = tpipe._seed_depth_landmarks(a, fa_t, frames[0]["depth"])
    assert n_t == n_j == SEED_CAP  # more free keypoints with depth than the cap
    sj, st = _state(jpipe, jslots, n_kp), _state(tpipe, tslots, n_kp)
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)

    tpipe._cur_image = jpipe._cur_image = frames[2]["gray"]
    d_j = jpipe._densify_pending_seeds(b, fb_j)
    d_t = tpipe._densify_pending_seeds(b, fb_t)
    assert d_t == d_j > 0
    sj, st = _state(jpipe, jslots, n_kp), _state(tpipe, tslots, n_kp)
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    assert len(st["pending"]) == SEED_CAP - d_t


def test_depth_seeded_pipeline_matches_jax():
    from test_torch_pipeline import _frames, _run

    frames, ds, K4 = _frames(12, 0.05)
    base = dict(init_type="gtdepth", estimation="ba", n_features=200, n_levels=3,
                local_ba=True, keyframe_ratio=0.25, final_ba_outer=1,
                final_ba_iters=10, depth_landmarks=True, depth_landmarks_max=150,
                track_local_map=False)
    jpipe = JaxPipeline(JaxConfig(track_batch=1, **base), K4, 160, 120)
    ref = _run(jpipe, ds, frames)
    pipe = td.BundleAdjustmentPipeline(PipelineConfig(**base), K4, 160, 120,
                                       device="cpu")
    seeded = []
    seed = pipe._seed_depth_landmarks
    pipe._seed_depth_landmarks = lambda *a: seeded.append(seed(*a)) or seeded[-1]
    got = _run(pipe, ds, frames)
    assert sum(seeded) > 0
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert abs(got[2] - ref[2]) <= max(0.02 * ref[2], 2), (got[2], ref[2])
    assert got[3] < 0.2 and ref[3] < 0.2, (got[3], ref[3])
    assert abs(got[3] - ref[3]) < 0.01, (got[3], ref[3])


def test_cli_depth_landmarks_runs(tmp_path):
    from test_torch_pipeline import _cli_run

    res, _ = _cli_run(tmp_path, "--depth-landmarks")
    assert res["frames"] == 6 and res["ate_rmse"] < 0.06
