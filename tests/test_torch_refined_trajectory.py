"""The smoothed trajectory gives a refined record its refined pose.

`finalize` re-solves tracked frames against the BA-refined map and accepts a
re-solve only where the tracking-time pose is broken. Such a pose is already
consistent with the refined map, so the port outputs it as it is, where the
JAX package still blends the keyframe corrections onto it (a known fault of
the reference, kept there). Both pipelines run a 12-frame 320x240 plane
sequence (fx 300, 400 features; at 160x120 the tracked poses drift by up
to 0.13 m and the outcome turns on the CPU's thread count) with a keyframe
every 4 frames;
tracked frame 6 is moved 0.1 m off its tracked pose before `finalize`, so
that its chi2 inliers drop below the acceptance rule's 75% and the refine
takes its re-solve."""

import numpy as np
import pytest

from bundleadjustment_tpu.data.synthetic import render_plane_sequence
from bundleadjustment_tpu.data.tum import FrameData
from bundleadjustment_tpu.geometry import np_se3
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline as JaxPipeline
from bundleadjustment_tpu.pipeline import PipelineConfig as JaxConfig
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline
from torch_port_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MOVED = 6
SHIFT = np.array([0.1, 0.0, 0.0])


def _finalize_moved(pipe, ds):
    """Track every frame, move record MOVED by SHIFT (its keyframe-relative
    transform too), finalize. Returns (smoothed cam->world of MOVED, its
    refined cam->world, whether the refine changed it)."""
    for f in ds:
        pipe.process_frame(f)
    rec = pipe.trajectory[MOVED]
    assert not rec.is_keyframe and rec.rel is not None
    rec.extr = rec.extr + np.concatenate([np.zeros(3), SHIFT]).astype(rec.extr.dtype)
    rec.rel = np_se3.rt6_compose(rec.extr, np_se3.rt6_inverse(pipe.map.kf_pose[rec.ref_kf]))
    moved = rec.extr.copy()
    pipe.finalize()
    _, mats = pipe.trajectory_cam_to_world()
    refined = np_se3.rt6_to_mat44(np_se3.rt6_inverse(pipe._record_extr(rec)))
    return mats[MOVED], refined, not np.array_equal(rec.extr, moved)


def test_refined_record_keeps_its_refined_pose():
    fr, K4 = render_plane_sequence(n_frames=12, width=320, height=240,
                                   motion_step=0.05, fx=300.0, fy=300.0)
    ds = [FrameData(index=i, timestamp=f["timestamp"], gray=f["gray"],
                    depth=f["depth"], rgb=None, gt_cam_to_world=f["gt_cam_to_world"])
          for i, f in enumerate(fr)]
    base = dict(init_type="gtdepth", estimation="ba", n_features=400, n_levels=3,
                local_ba=False, final_ba_outer=1, final_ba_iters=10,
                kf_max_interval=4)
    port = BundleAdjustmentPipeline(PipelineConfig(**base), K4, 320, 240, device="cpu")
    out, refined, changed = _finalize_moved(port, ds)
    assert changed and port.trajectory[MOVED].refined
    # a keyframe follows the record, so the blend would have moved it
    assert any(r.is_keyframe for r in port.trajectory[MOVED + 1:])
    np.testing.assert_array_equal(out, refined)
    assert sum(r.refined for r in port.trajectory) >= 1
    assert not any(r.refined for r in port.trajectory if r.is_keyframe)

    jax_out, jax_refined, jax_changed = _finalize_moved(
        JaxPipeline(JaxConfig(track_batch=1, **base), K4, 320, 240), ds)
    assert jax_changed
    # the reference blends the next keyframe's correction onto the refined
    # pose: its output is off the pose its own refine accepted (by 4.9 mm
    # here, far above rounding)
    assert np.abs(jax_out[:3, 3] - jax_refined[:3, 3]).max() > 1e-3
    # both refines land on the same pose, within the pipeline parity tests'
    # 0.01 m (tests/test_torch_pipeline.py)
    np.testing.assert_allclose(refined[:3, 3], jax_refined[:3, 3], atol=0.01)
    np.testing.assert_allclose(refined[:3, :3], jax_refined[:3, :3], atol=2e-3)
