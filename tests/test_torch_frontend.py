"""Port parity for the batched and data-parallel frontend, on the CPU.

- `detect_batch` of a batch equals per-frame `detect_and_describe` exactly,
  every field of every frame (160x120 / 3 levels and 320x240 / 4 levels).
- `detect_batch` against the JAX package's `detect_batch`, with
  tests/test_torch_features.py's bounds frame by frame.
- `detect_batch_sharded` over 2 gloo ranks on a ragged batch of 5 (padded
  with a zero frame, padding stripped), given as a numpy array and as a
  tensor, equals the single-device batch.
- The split path (`fused_tracking=False`, `--no-fused-tracking`) of both
  packages: every tracked frame detects, matches and associates on the
  host, the fused step never runs; statuses and keyframes equal, |ATE
  difference| < 0.01 m (tests/test_torch_pipeline.py's bound).
- The predetect pipeline against the port's split-path run
  (`fused_tracking=False`): statuses equal, trajectories within 1e-4 (the
  criterion of the JAX package's tests/test_parallel_frontend.py), on a
  scene where every frame after the first is tracked.
"""

import numpy as np
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import render_plane_sequence
from bundleadjustment_tpu.ops import features as jf
from bundleadjustment_tpu_torch.ops import features as tf
from bundleadjustment_tpu_torch.parallel.frontend import detect_batch_sharded
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline as JaxPipeline
from bundleadjustment_tpu.pipeline import PipelineConfig as JaxConfig
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline
from torch_port_helpers import frontend_rank, one_thread, spawn_ranks  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FIELDS = list(tf.Features.__dataclass_fields__)


def _images(n, width=160, height=120, fx=150.0):
    frames, _ = render_plane_sequence(n_frames=n, width=width, height=height,
                                      fx=fx, fy=fx, motion_step=0.06)
    return np.stack([f["gray"] for f in frames]).astype(np.float32)


def _equal(a, b):
    return torch.equal(a, b) or (a.is_floating_point() and torch.equal(
        torch.nan_to_num(a, neginf=-1e30), torch.nan_to_num(b, neginf=-1e30)))


@pytest.mark.parametrize("shape", [(5, 160, 120, 3, 200), (2, 320, 240, 4, 400)])
def test_batch_equals_per_frame(shape):
    n, w, h, levels, feats = shape
    imgs = torch.from_numpy(_images(n, w, h, fx=w * 150.0 / 160))
    cfg = tf.FeatureConfig(n_features=feats, n_levels=levels)
    batch = tf.detect_batch(imgs, cfg)
    assert batch.xy.shape == (n, feats, 2) and batch.desc.shape == (n, feats, 8)
    for i in range(n):
        one = tf.detect_and_describe(imgs[i], cfg)
        for k in FIELDS:
            assert _equal(getattr(batch, k)[i], getattr(one, k)), (i, k)
    assert int(batch.valid.sum()) > 0.5 * n * feats


def test_batch_matches_jax():
    imgs = _images(3)
    ref = jf.detect_batch(imgs, jf.FeatureConfig(n_features=200, n_levels=3,
                                                  topk="exact"))
    got = tf.detect_batch(torch.from_numpy(imgs),
                          tf.FeatureConfig(n_features=200, n_levels=3))
    for i in range(3):
        xy_j = np.asarray(ref.xy[i])
        same = (np.all(np.abs(got.xy[i].numpy() - xy_j) < 1e-3, axis=1)
                & (got.octave[i].numpy() == np.asarray(ref.octave[i]))
                & (got.valid[i].numpy() == np.asarray(ref.valid[i])))
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_array_equal(got.desc[i].numpy()[same],
                                      np.asarray(ref.desc[i]).view(np.int32)[same])
        np.testing.assert_allclose(got.angle[i].numpy()[same],
                                   np.asarray(ref.angle[i])[same], atol=1e-4)
        np.testing.assert_array_equal(got.sigma2[i].numpy(), np.asarray(ref.sigma2[i]))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_sharded_over_two_ranks_matches_one_device(tmp_path, kind):
    imgs = _images(5)
    if kind == "tensor":
        imgs = torch.from_numpy(imgs)
    cfg_kw = dict(n_features=64, n_levels=2)
    ref = detect_batch_sharded(imgs, tf.FeatureConfig(**cfg_kw), device="cpu")
    spawn_ranks(frontend_rank, 2, (2, str(tmp_path / "rdv"), imgs, cfg_kw, str(tmp_path)))
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert int(got["all_gathers"]) == len(FIELDS)
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(), err_msg=k)
    assert got["xy"].shape[0] == 5 and ref.valid.any()


def test_split_path_matches_jax():
    """`fused_tracking=False` (`--no-fused-tracking`) takes the split path on
    both sides: every tracked frame detects, matches and associates on the
    host; the fused tracked-frame step never runs. 6 frames at 160x120:
    statuses and keyframes equal, |ATE difference| < 0.01 m."""
    from test_torch_pipeline import _frames, _run

    frames, ds, K4 = _frames(6, 0.05)
    base = dict(init_type="gtdepth", estimation="ba", n_features=200, n_levels=3,
                local_ba=False, final_ba_outer=1, final_ba_iters=10,
                fused_tracking=False)
    ref = _run(JaxPipeline(JaxConfig(track_batch=1, **base), K4, 160, 120), ds, frames)
    pipe = BundleAdjustmentPipeline(PipelineConfig(**base), K4, 160, 120, device="cpu")
    fused = []
    track_fused = pipe._track_fused
    pipe._track_fused = lambda *a: fused.append(1) or track_fused(*a)
    got = _run(pipe, ds, frames)
    assert not fused and pipe._prev_track is None
    assert got[0] == ref[0] and got[0][1] == "initialized"
    assert all(s in ("tracked", "keyframe") for s in got[0][2:]), got[0]
    assert got[1] == ref[1]
    assert abs(got[3] - ref[3]) < 0.01, (got[3], ref[3])


def test_predetect_pipeline_matches_split_path():
    from test_torch_pipeline import _frames

    _, ds, K4 = _frames(6, 0.05)
    cfg = PipelineConfig(init_type="gtdepth", estimation="ba", local_ba=False,
                         n_features=200, n_levels=3, fused_tracking=False,
                         final_ba_outer=1, final_ba_iters=10)
    ref = BundleAdjustmentPipeline(cfg, K4, 160, 120, device="cpu")
    ref_statuses = ref.process_frames(ds)
    pre = BundleAdjustmentPipeline(cfg, K4, 160, 120, device="cpu")
    pf = pre.predetect_features(ds, chunk=4)
    assert all(p.desc_dev is not None for p in pf)
    statuses = pre.process_frames(ds, prefeats=pf)
    assert statuses == ref_statuses and statuses[1] == "initialized"
    assert all(s in ("tracked", "keyframe") for s in statuses[2:]), statuses
    timers = pre.timers.report()
    assert timers["detect"]["count"] == 2 and timers["frontend"]["count"] == 5
    for pipe in (ref, pre):
        pipe.finalize()
    _, mats_ref = ref.trajectory_cam_to_world()
    _, mats = pre.trajectory_cam_to_world()
    assert mats.shape == mats_ref.shape == (6, 4, 4)
    np.testing.assert_allclose(mats, mats_ref, atol=1e-4)
