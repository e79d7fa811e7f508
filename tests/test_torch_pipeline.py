"""Port parity for the slices as a whole: the port's pipeline on the CPU
(plain kernel versions) against the JAX pipeline (track_batch=1) on 12
rendered plane frames at 160x120, 200 features, 3 levels, final BA 1x10.
The monocular modes (standard two-view init, pnp and essential_or_homography
tracking) run on the scenes of the JAX package's own tests of them, with the
port's RANSAC sampler walking the JAX key chain, so both draw the same
samples.

Bounds (as tests/test_pipeline.py holds the JAX package's own batched-vs-
per-frame paths): statuses and keyframe counts equal, map sizes within 2%,
|ATE difference| < 0.01 m, and both ATEs < 0.06 m on the default-keyframe
run. The forced-keyframe run (kf_max_interval=3, local BA, flat and dense
engines by size) exercises triangulation, the neighbour search and fusion;
its 160x120 texture-quantised trajectories are held to < 0.2 m."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bundleadjustment_tpu.data.synthetic import render_plane_sequence, write_tum_format
from bundleadjustment_tpu.data.tum import FrameData
from bundleadjustment_tpu.geometry.epipolar import _sample_indices
from bundleadjustment_tpu.metrics import evaluate_ate
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline as JaxPipeline
from bundleadjustment_tpu.pipeline import PipelineConfig as JaxConfig
from bundleadjustment_tpu.ops.features import Features as JaxFeatures
from bundleadjustment_tpu_torch import cli
from bundleadjustment_tpu_torch.interop import from_reference
from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline


def _frames(n, motion_step, width=160, height=120, fx=150.0):
    fr, K4 = render_plane_sequence(n_frames=n, width=width, height=height,
                                   motion_step=motion_step, fx=fx, fy=fx)
    ds = [FrameData(index=i, timestamp=f["timestamp"], gray=f["gray"],
                    depth=f["depth"], rgb=None, gt_cam_to_world=f["gt_cam_to_world"])
          for i, f in enumerate(fr)]
    return fr, ds, K4


def _run(pipe, ds, frames, batched=False):
    statuses = (pipe.process_frames(ds) if batched
                else [pipe.process_frame(f) for f in ds])
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


def test_default_tracking_matches_jax_default():
    """The port's default run (one frame at a time) against the JAX
    pipeline's default: `process_frames`, as its CLI drives it, at
    track_batch=8 with the local-map pass on, whose batch-start landmark
    snapshot sees descriptors up to 8 frames stale. 16 frames, so more than
    one batch runs. Bounds: those the JAX package holds between its own
    batched and per-frame paths (tests/test_pipeline.py,
    test_batched_tlm_matches_per_frame)."""
    frames, ds, K4 = _frames(16, 0.05)
    base = dict(init_type="gtdepth", estimation="ba", n_features=200, n_levels=3,
                local_ba=False, final_ba_outer=1, final_ba_iters=10)
    jax_cfg = JaxConfig(**base)
    assert jax_cfg.track_batch == 8 and jax_cfg.track_local_map
    ref = _run(JaxPipeline(jax_cfg, K4, 160, 120), ds, frames, batched=True)
    cfg = PipelineConfig(**base)
    assert cfg.track_batch == 8 and cfg.track_local_map
    got = _run(BundleAdjustmentPipeline(cfg, K4, 160, 120, device="cpu"), ds, frames)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert abs(got[2] - ref[2]) <= max(0.02 * ref[2], 2), (got[2], ref[2])
    assert got[3] < 0.06 and ref[3] < 0.06, (got[3], ref[3])
    assert abs(got[3] - ref[3]) < 0.01, (got[3], ref[3])


def _walk_jax_keys(pipe, seed):
    """Make the port's two-view sampler draw what the JAX pipeline draws:
    one key split off the pipeline's chain per estimate, split again for E
    and H, over the pairs padded to the JAX pipeline's power-of-two bucket."""
    state = {"key": jax.random.PRNGKey(seed)}

    def samples(n, n_hyp):
        state["key"], k = jax.random.split(state["key"])
        cap = 64
        while cap < n:
            cap *= 2
        valid = jnp.arange(cap) < n
        return tuple(torch.from_numpy(np.asarray(
            _sample_indices(ki, valid, n_hyp, size))).long()
            for ki, size in zip(jax.random.split(k), (8, 4)))

    pipe._two_view_samples = samples


MONOCULAR_CASES = {
    # name: (frames, motion_step, width, height, fx, config, ATE bound [m])
    "standard_init": (6, 0.25, 320, 240, 300.0,
                      dict(init_type="standard", estimation="ba", n_features=400), 0.04),
    "pnp": (12, 0.05, 160, 120, 150.0,
            dict(init_type="gtdepth", estimation="pnp", n_features=200), 0.06),
    "essential_or_homography": (6, 0.12, 320, 240, 300.0,
                                dict(init_type="gtdepth", n_features=400,
                                     estimation="essential_or_homography"), 0.12),
}


@pytest.mark.parametrize("case", list(MONOCULAR_CASES))
def test_monocular_modes_match_jax(case):
    """`init_type="standard"`, `estimation="pnp"` and
    `estimation="essential_or_homography"` against the JAX pipeline on the
    scenes and under the ATE bounds of the JAX package's own tests of them:
    statuses and keyframe counts equal, |ATE difference| < 0.01 m."""
    n, step, w, h, fx, extra, ate_bound = MONOCULAR_CASES[case]
    frames, ds, K4 = _frames(n, step, w, h, fx)
    base = dict(n_levels=3, local_ba=False, final_ba_outer=1, final_ba_iters=10, **extra)
    ref = _run(JaxPipeline(JaxConfig(track_batch=1, **base), K4, w, h), ds, frames)
    pipe = BundleAdjustmentPipeline(PipelineConfig(**base), K4, w, h, device="cpu")
    _walk_jax_keys(pipe, pipe.cfg.seed)
    got = _run(pipe, ds, frames)
    assert got[0] == ref[0] and "initialized" in got[0], (got[0], ref[0])
    assert got[1] == ref[1]
    assert got[3] < ate_bound and ref[3] < ate_bound, (got[3], ref[3])
    assert abs(got[3] - ref[3]) < 0.01, (got[3], ref[3])


def test_two_view_sampler_is_seeded_from_config():
    """Without the patch the sampler is a CPU generator seeded with
    config.seed: two pipelines draw the same samples, another seed others."""
    K4 = np.array([150.0, 150.0, 80.0, 60.0])
    draw = lambda seed: BundleAdjustmentPipeline(
        PipelineConfig(seed=seed), K4, 160, 120, device="cpu")._two_view_samples(120, 32)
    a, b, c = draw(3), draw(3), draw(4)
    assert a[0].shape == (32, 8) and a[1].shape == (32, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert int(a[0].max()) < 120


def _cli_run(tmp_path, *flags, name="gtdepth_ba", scene=(0.06, 160, 120, 150.0),
             n_features=200):
    """The port's CLI on 6 rendered frames (160x120 unless `scene` says
    otherwise) on the CPU; returns (results, output prefix)."""
    step, w, h, fx = scene
    frames, _, K4 = _frames(6, step, w, h, fx)
    data = tmp_path / "seq"
    write_tum_format(str(data), frames)
    (data / "intrinsics.json").write_text(json.dumps(
        {"fx": float(K4[0]), "fy": float(K4[1]), "cx": float(K4[2]),
         "cy": float(K4[3]), "width": w, "height": h}))
    out = tmp_path / "out"
    res = cli.main(["--dataset-name", "synthetic", "--dataset-path", str(data),
                    "--output-path", str(out), "--frames", "6", "--trajectory",
                    "--n-features", str(n_features), "--n-levels", "3",
                    "--device", "cpu", *flags])
    prefix = out / f"synthetic_{name}_globalba_f6"
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


CLI_MONOCULAR = {
    # flags -> (name in the output prefix, scene, features, ATE bound [m])
    "init_standard": (["--init-type", "standard"], "standard_ba",
                      (0.25, 320, 240, 300.0), 400, 0.04),
    "pnp": (["--estimation", "pnp"], "gtdepth_pnp", (0.06, 160, 120, 150.0), 200, 0.06),
    "essential_or_homography": (["--estimation", "essential_or_homography"],
                                "gtdepth_essential_or_homography",
                                (0.12, 320, 240, 300.0), 400, 0.12),
}


@pytest.mark.parametrize("case", list(CLI_MONOCULAR))
def test_cli_monocular_modes_write_outputs(case, tmp_path):
    """`--init-type standard`, `--estimation pnp` and `--estimation
    essential_or_homography` run through the CLI, track every frame and name
    their outputs as the JAX CLI does."""
    flags, name, scene, n_features, ate_bound = CLI_MONOCULAR[case]
    res, _ = _cli_run(tmp_path, *flags, name=name, scene=scene, n_features=n_features)
    assert res["frames"] == 6 and res["keyframes"] >= 2
    assert res["tracking_failures"] == 0 and res["ate_rmse"] < ate_bound


@pytest.mark.parametrize("field,value", [("init_type", "depth"), ("estimation", "icp")])
def test_unknown_modes_raise(field, value):
    with pytest.raises(ValueError, match=field):
        BundleAdjustmentPipeline(PipelineConfig(**{field: value}),
                                 np.array([150.0, 150.0, 80.0, 60.0]), 160, 120,
                                 device="cpu")


@pytest.mark.parametrize("field,value", [
    ("global_ba_mode", "windowed"), ("ba_solver", "pcg"), ("depth_landmarks", True)])
def test_unported_modes_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BundleAdjustmentPipeline(PipelineConfig(**{field: value}),
                                 np.array([150.0, 150.0, 80.0, 60.0]), 160, 120,
                                 device="cpu")


@pytest.mark.parametrize("flags", [["--predetect"], ["--reconstruction-error", "gt.ply"],
                                   ["--display-pointcloud"], ["--faces-type", "poisson"],
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
