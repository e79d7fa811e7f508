"""Port parity for `pipeline/checkpoint.py`, on the CPU: 6 rendered frames
at 160x120, cut after frame 3.

- The port's save / load round trip restores the saved state field by
  field (tests/test_checkpoint.py's checks, plus the last keyframe slot,
  the last frame's features and `_prev_track` None).
- A resumed run against the uninterrupted one: every frame tracked,
  positions within 2e-3 m, ATE < 0.06 m (tests/test_checkpoint.py).
- A file written by the JAX package resumes in the port: statuses and
  keyframes equal to the JAX package's resume of the same file, |ATE
  difference| < 0.01 m; a file written by the port loads in the JAX
  package's `load_checkpoint` with the same map and trajectory.
- With `depth_landmarks`, the pending depth seeds survive the port's round
  trip (the one deliberate difference: the JAX loader ignores the
  `pending_seeds` key and starts with none).
"""

import numpy as np
import pytest

from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline as JaxPipeline
from bundleadjustment_tpu.pipeline import PipelineConfig as JaxConfig
from bundleadjustment_tpu.pipeline import checkpoint as jck
from bundleadjustment_tpu_torch.metrics.ate import evaluate_ate
from bundleadjustment_tpu_torch.pipeline import checkpoint as tck
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline
from test_torch_pipeline import _frames
from torch_port_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BASE = dict(init_type="gtdepth", estimation="ba", n_features=300, n_levels=3,
            local_ba=False, final_ba_outer=1, final_ba_iters=5)
CUT = 3


@pytest.fixture(scope="module")
def seq():
    frames, ds, K4 = _frames(6, 0.06)
    return frames, ds, K4


def _port(cfg_kw, K4):
    return BundleAdjustmentPipeline(PipelineConfig(**cfg_kw), K4, 160, 120,
                                    device="cpu")


def _finish(pipe, frames):
    pipe.finalize()
    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    return ts, mats, evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)["rmse"]


@pytest.fixture(scope="module")
def port_cut(seq, tmp_path_factory):
    """The port after CUT frames, and the checkpoint it wrote."""
    _, ds, K4 = seq
    pipe = _port(BASE, K4)
    for f in ds[:CUT]:
        pipe.process_frame(f)
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    tck.save_checkpoint(path, pipe)
    return pipe, path


def _assert_same_state(got, ref):
    assert got.initialized == ref.initialized
    assert got.kf_counter == ref.kf_counter
    assert got.last_slot == ref.last_slot and got.ref_slot == ref.ref_slot
    assert got._last_kf_slot == ref._last_kf_slot
    n_kf = ref.last_slot + 1
    np.testing.assert_allclose(got.map.kf_pose[:n_kf], ref.map.kf_pose[:n_kf])
    np.testing.assert_array_equal(got.map.kf_is_keyframe[:n_kf],
                                  ref.map.kf_is_keyframe[:n_kf])
    np.testing.assert_array_equal(got.map.active_points(), ref.map.active_points())
    n_pt = int(ref.map._lib.map_num_points(ref.map._h))
    for field in ("pt_pos", "pt_dmin", "pt_dmax", "pt_color"):
        np.testing.assert_array_equal(getattr(got.map, field)[:n_pt],
                                      getattr(ref.map, field)[:n_pt])
    for pt in ref.map.active_points()[:50]:
        for a, b in zip(got.map.point_observations(int(pt)),
                        ref.map.point_observations(int(pt))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.last_extr, ref.last_extr)
    np.testing.assert_allclose(got.prev_extr, ref.prev_extr)
    for k in ("xy", "octave", "sigma2", "desc", "valid"):
        np.testing.assert_array_equal(getattr(got.last_feats, k),
                                      getattr(ref.last_feats, k))
    assert len(got.trajectory) == len(ref.trajectory)
    for rb, rc in zip(ref.trajectory, got.trajectory):
        assert (rb.slot, rb.is_keyframe, rb.ref_kf) == (rc.slot, rc.is_keyframe, rc.ref_kf)
        np.testing.assert_allclose(rc.extr, rb.extr)
        assert (rb.assoc_pt is None) == (rc.assoc_pt is None)
        if rb.assoc_pt is not None:
            np.testing.assert_array_equal(rb.assoc_pt, rc.assoc_pt)
            np.testing.assert_allclose(rb.assoc_uv, rc.assoc_uv)
            np.testing.assert_allclose(rb.assoc_sig, rc.assoc_sig)


def test_round_trip_restores_the_state(port_cut):
    pipe, path = port_cut
    got = tck.load_checkpoint(path, PipelineConfig(**BASE), device="cpu")
    _assert_same_state(got, pipe)
    assert got._prev_track is None and pipe._prev_track is not None
    assert got.stats == pipe.stats and str(got.device) == "cpu"


def test_resume_matches_uninterrupted(seq, port_cut):
    frames, ds, K4 = seq
    straight = _port(BASE, K4)
    for f in ds:
        straight.process_frame(f)
    ts_a, mats_a, ate_a = _finish(straight, frames)
    resumed = tck.load_checkpoint(port_cut[1], PipelineConfig(**BASE), device="cpu")
    statuses = [resumed.process_frame(f) for f in ds[CUT:]]
    assert all(s in ("tracked", "keyframe") for s in statuses), statuses
    ts_c, mats_c, ate_c = _finish(resumed, frames)
    assert len(ts_c) == len(ds) and ate_a < 0.06 and ate_c < 0.06, (ate_a, ate_c)
    np.testing.assert_allclose(ts_a, ts_c)
    assert np.abs(mats_a[:, :3, 3] - mats_c[:, :3, 3]).max() < 2e-3


def test_jax_checkpoint_resumes_in_port(seq, tmp_path):
    frames, ds, K4 = seq
    jpipe = JaxPipeline(JaxConfig(track_batch=1, **BASE), K4, 160, 120)
    for f in ds[:CUT]:
        jpipe.process_frame(f)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, jpipe)
    jres = jck.load_checkpoint(path, JaxConfig(track_batch=1, **BASE))
    ref_statuses = [jres.process_frame(f) for f in ds[CUT:]]
    *_, ref_ate = _finish(jres, frames)
    tres = tck.load_checkpoint(path, PipelineConfig(**BASE), device="cpu")
    _assert_same_state(tres, jck.load_checkpoint(path, JaxConfig(track_batch=1, **BASE)))
    assert tres._prev_track is None
    statuses = [tres.process_frame(f) for f in ds[CUT:]]
    *_, ate = _finish(tres, frames)
    assert statuses == ref_statuses
    assert tres.stats["keyframes"] == jres.stats["keyframes"]
    assert abs(ate - ref_ate) < 0.01, (ate, ref_ate)


def test_port_checkpoint_loads_in_jax(port_cut):
    pipe, path = port_cut
    jpipe = jck.load_checkpoint(path, JaxConfig(track_batch=1, **BASE))
    _assert_same_state(jpipe, pipe)


def test_pending_depth_seeds_survive(seq, tmp_path):
    _, ds, K4 = seq
    kw = dict(BASE, local_ba=True, keyframe_ratio=0.95, depth_landmarks=True,
              depth_landmarks_max=150, track_local_map=False)
    pipe = _port(kw, K4)
    for f in ds[:CUT]:
        pipe.process_frame(f)
    assert len(pipe._pending_seeds) > 10
    path = str(tmp_path / "seeded.npz")
    tck.save_checkpoint(path, pipe)
    got = tck.load_checkpoint(path, PipelineConfig(**kw), device="cpu")
    assert got._pending_seeds == pipe._pending_seeds
    # the JAX loader reads the same file and drops them, as it always has
    assert jck.load_checkpoint(path, JaxConfig(**kw))._pending_seeds == []
    # a file without the key (the JAX package's) resumes with none pending
    with np.load(path) as z:
        np.savez_compressed(str(tmp_path / "no_seeds.npz"),
                            **{k: z[k] for k in z.files if k != "pending_seeds"})
    assert tck.load_checkpoint(str(tmp_path / "no_seeds.npz"), PipelineConfig(**kw),
                               device="cpu")._pending_seeds == []
    assert all(got.process_frame(f) in ("tracked", "keyframe") for f in ds[CUT:])
