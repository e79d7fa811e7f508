"""Port parity for the slice as a whole: the port's pipeline on the CPU
(plain kernel versions) against the JAX pipeline (track_batch=1) on 12
rendered plane frames at 160x120, 200 features, 3 levels, final BA 1x10.

Bounds (as tests/test_pipeline.py holds the JAX package's own batched-vs-
per-frame paths): statuses and keyframe counts equal, map sizes within 2%,
|ATE difference| < 0.01 m, and both ATEs < 0.06 m on the default-keyframe
run. The forced-keyframe run (kf_max_interval=3, local BA, flat and dense
engines by size) exercises triangulation, the neighbour search and fusion;
its 160x120 texture-quantised trajectories are held to < 0.2 m."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bundleadjustment_tpu.data.synthetic import render_plane_sequence, write_tum_format
from bundleadjustment_tpu.data.tum import FrameData
from bundleadjustment_tpu.metrics import evaluate_ate
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline as JaxPipeline
from bundleadjustment_tpu.pipeline import PipelineConfig as JaxConfig
from bundleadjustment_tpu.ops.features import Features as JaxFeatures
from bundleadjustment_tpu_torch import cli
from bundleadjustment_tpu_torch.interop import from_reference
from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline


def _frames(n, motion_step):
    fr, K4 = render_plane_sequence(n_frames=n, width=160, height=120,
                                   motion_step=motion_step, fx=150.0, fy=150.0)
    ds = [FrameData(index=i, timestamp=f["timestamp"], gray=f["gray"],
                    depth=f["depth"], rgb=None, gt_cam_to_world=f["gt_cam_to_world"])
          for i, f in enumerate(fr)]
    return fr, ds, K4


def _run(pipe, ds, frames):
    statuses = [pipe.process_frame(f) for f in ds]
    pipe.finalize()
    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    ate = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)["rmse"]
    return statuses, pipe.stats["keyframes"], len(pipe.map.active_points()), ate


CASES = {
    "default_dense": (0.05, dict(ba_layout="dense_landmark"), 0.06),
    "keyframes_local_ba": (0.06, dict(kf_max_interval=3, local_ba=True), 0.2),
    # both sides one shard: the JAX pipeline on a 1-device mesh, the port
    # with no process group (the sharded engine's K5 route on the card)
    "sharded_global_ba": (0.05, dict(global_ba_mode="sharded"), 0.06),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax(case):
    motion_step, extra, ate_bound = CASES[case]
    frames, ds, K4 = _frames(12, motion_step)
    base = dict(init_type="gtdepth", estimation="ba", n_features=200, n_levels=3,
                local_ba=False, final_ba_outer=1, final_ba_iters=10)
    base.update(extra)
    jax_pipe = JaxPipeline(JaxConfig(track_batch=1, **base), K4, 160, 120)
    if base.get("global_ba_mode") == "sharded":
        jax_pipe.global_ba_mesh = Mesh(np.array(jax.devices()[:1]), ("shard",))
    ref = _run(jax_pipe, ds, frames)
    pipe = BundleAdjustmentPipeline(PipelineConfig(**base), K4, 160, 120, device="cpu")
    sharded_calls = []
    solve_sharded = pipe._solve_ba_sharded
    pipe._solve_ba_sharded = lambda *a: sharded_calls.append(a) or solve_sharded(*a)
    got = _run(pipe, ds, frames)
    assert bool(sharded_calls) == (base.get("global_ba_mode") == "sharded")
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert abs(got[2] - ref[2]) <= max(0.02 * ref[2], 2), (got[2], ref[2])
    assert got[3] < ate_bound and ref[3] < ate_bound, (got[3], ref[3])
    assert abs(got[3] - ref[3]) < 0.01, (got[3], ref[3])
    if case == "keyframes_local_ba":
        assert "keyframe" in got[0]


def _cli_run(tmp_path, *flags):
    """The port's CLI on 6 rendered frames at 160x120 on the CPU; returns
    (results, output prefix)."""
    frames, _, K4 = _frames(6, 0.06)
    data = tmp_path / "seq"
    write_tum_format(str(data), frames)
    (data / "intrinsics.json").write_text(json.dumps(
        {"fx": float(K4[0]), "fy": float(K4[1]), "cx": float(K4[2]),
         "cy": float(K4[3]), "width": 160, "height": 120}))
    out = tmp_path / "out"
    res = cli.main(["--dataset-name", "synthetic", "--dataset-path", str(data),
                    "--output-path", str(out), "--frames", "6", "--trajectory",
                    "--n-features", "200", "--n-levels", "3", "--device", "cpu",
                    *flags])
    prefix = out / "synthetic_gtdepth_ba_globalba_f6"
    for suffix in ("_estimatedPoses.txt", "_mesh.off", "_results.json"):
        assert os.path.exists(str(prefix) + suffix), suffix
    return res, prefix


def test_cli_writes_outputs(tmp_path):
    res, prefix = _cli_run(tmp_path)
    assert res["frames"] == 6 and res["ate_rmse"] < 0.06
    lines = [l for l in open(str(prefix) + "_estimatedPoses.txt") if not l.startswith("#")]
    assert len(lines) == 6 and len(lines[0].split()) == 8


def test_cli_sharded_global_ba_writes_outputs(tmp_path):
    """`--global-ba sharded` runs (one shard: no process group) and writes
    the three output files."""
    res, _ = _cli_run(tmp_path, "--global-ba", "sharded")
    assert res["frames"] == 6 and res["ate_rmse"] < 0.06


@pytest.mark.parametrize("field,value", [
    ("init_type", "standard"), ("estimation", "pnp"),
    ("estimation", "essential_or_homography"), ("global_ba_mode", "windowed"),
    ("ba_solver", "pcg"), ("depth_landmarks", True)])
def test_unported_modes_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BundleAdjustmentPipeline(PipelineConfig(**{field: value}),
                                 np.array([150.0, 150.0, 80.0, 60.0]), 160, 120,
                                 device="cpu")


@pytest.mark.parametrize("flags", [["--predetect"], ["--reconstruction-error", "gt.ply"],
                                   ["--display-pointcloud"], ["--faces-type", "poisson"],
                                   ["--init-type", "standard"], ["--estimation", "pnp"],
                                   ["--global-ba", "windowed"], ["--ba-solver", "pcg"],
                                   ["--depth-landmarks"]])
def test_unported_cli_flags_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--dataset-path", str(tmp_path), "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [["--matcher", "xla"], ["--matcher", "pallas"],
                                   ["--no-fused-tracking"], ["--no-warmup"],
                                   ["--track-batch", "1"]])
def test_no_op_cli_flags_say_so(flags):
    """Flags that tuned the JAX package's dispatch parse, leave the ported
    configuration valid, and their --help says they change nothing."""
    parser = cli.build_parser()
    cli.config_from_args(parser.parse_args(flags))
    action = next(a for a in parser._actions if flags[0] in a.option_strings)
    assert "changes nothing in the port" in action.help


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        BundleAdjustmentPipeline(PipelineConfig(), np.array([150.0, 150.0, 80.0, 60.0]),
                                 160, 120, device="cuda")


def test_default_device_is_the_card():
    """With no device the pipeline, densify_problem and from_reference go to
    the card: without one they raise, they do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        BundleAdjustmentPipeline(PipelineConfig(), np.array([150.0, 150.0, 80.0, 60.0]),
                                 160, 120)
    z = np.zeros(0)
    with pytest.raises(RuntimeError, match="cuda"):
        densify_problem(np.ones(4), z.astype(int), z.astype(int), np.zeros((0, 2)),
                        z, z.astype(bool), np.zeros(1, bool), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        from_reference(JaxFeatures(*[np.zeros(1)] * len(JaxFeatures._fields)))
