"""The port's output flags on the CPU: one 6-frame CLI run at 160x120 with
`--predetect --reconstruction-error GT --faces-type poisson
--display-pointcloud` (shared by a module fixture), each flag checked for
its own output; and the live visualizer's snapshots, as
tests/test_live_profiling.py checks the JAX package's."""

import json
import os

import numpy as np
import pytest

from bundleadjustment_tpu.data.synthetic import render_plane_sequence, write_tum_format
from bundleadjustment_tpu_torch import cli
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline
from bundleadjustment_tpu_torch.vis.live import LiveVisualizer
from bundleadjustment_tpu_torch.vis.mesh import read_ply_vertices, write_ply
from bundleadjustment_tpu_torch.vis.pointcloud import backproject_depth
from torch_port_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "synthetic_gtdepth_ba_globalba_f6"


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """(results, output dir) of the CLI with the four output flags; the
    ground-truth cloud is frame 0's depth back-projected into the world."""
    tmp = tmp_path_factory.mktemp("outputs")
    frames, K4 = render_plane_sequence(n_frames=6, width=160, height=120,
                                       fx=150.0, fy=150.0, motion_step=0.06)
    data = tmp / "seq"
    write_tum_format(str(data), frames)
    (data / "intrinsics.json").write_text(json.dumps(
        {"fx": float(K4[0]), "fy": float(K4[1]), "cx": float(K4[2]),
         "cy": float(K4[3]), "width": 160, "height": 120}))
    pts, valid = backproject_depth(K4, frames[0]["depth"],
                                   frames[0]["gt_cam_to_world"], stride=4,
                                   device="cpu")
    gt = str(tmp / "gt.ply")
    write_ply(gt, pts[valid])
    out = tmp / "out"
    res = cli.main(["--dataset-name", "synthetic", "--dataset-path", str(data),
                    "--output-path", str(out), "--frames", "6", "--trajectory",
                    "--n-features", "200", "--n-levels", "3", "--device", "cpu",
                    "--predetect", "--reconstruction-error", gt,
                    "--faces-type", "poisson", "--display-pointcloud"])
    return res, out


def _faces(path):
    with open(path) as f:
        f.readline()
        return int(f.readline().split()[1])


def _check_predetect(res, out):
    assert res["frames"] == 6 and res["tracking_failures"] == 0
    assert res["ate_rmse"] < 0.06
    # one batched detection pass, then matching only in every later frame
    assert res["phase_times"]["detect"]["count"] == 1
    assert res["phase_times"]["frontend"]["count"] == 5


def _check_reconstruction_error(res, out):
    # clean synthetic data: tests/test_recon_cli.py's bound
    assert 0 <= res["reconstruction_error"] < 0.05
    sizes = [len(read_ply_vertices(str(out / f"{NAME}_{s}.ply")))
             for s in ("gt_cloud", "estimated_cloud", "combined_colored_cloud")]
    assert sizes[0] > 100 and sizes[1] == res["n_map_points"]
    assert sizes[2] == sizes[0] + sizes[1]


def _check_display_pointcloud(res, out):
    cloud = read_ply_vertices(str(out / f"{NAME}_cloud.ply"))
    assert len(cloud) == res["n_map_points"]
    final = read_ply_vertices(str(out / "map_final.ply"))
    # map points + an estimated and a ground-truth glyph per keyframe
    assert len(final) == res["n_map_points"] + 10 * res["n_keyframes_final"]


def _check_faces_type_poisson(res, out):
    glyph_faces = 4 * res["n_keyframes_final"]
    assert _faces(str(out / f"{NAME}_mesh.off")) > glyph_faces + 100


CHECKS = {"predetect": _check_predetect,
          "reconstruction_error": _check_reconstruction_error,
          "display_pointcloud": _check_display_pointcloud,
          "faces_type_poisson": _check_faces_type_poisson}


@pytest.mark.parametrize("flag", list(CHECKS))
def test_output_cli_flag_writes_its_output(flag, cli_run):
    res, out = cli_run
    assert os.path.exists(str(out / f"{NAME}_results.json"))
    CHECKS[flag](res, out)


def test_live_visualizer_snapshots(tmp_path):
    from test_torch_pipeline import _frames

    _, ds, K4 = _frames(3, 0.06)
    cfg = PipelineConfig(init_type="gtdepth", estimation="ba", n_features=200,
                         n_levels=3, local_ba=False, final_ba_outer=0)
    pipe = BundleAdjustmentPipeline(cfg, K4, 160, 120, device="cpu")
    viz = LiveVisualizer(pipe, str(tmp_path), interval_s=0.05)
    for f in ds:
        pipe.process_frame(f)
    final = viz.close()
    assert not viz._thread.is_alive()
    assert os.path.exists(final) and os.path.exists(str(tmp_path / "map_live.ply"))
    verts = read_ply_vertices(final)
    # map points + 2 red estimated glyphs + 2 green ground-truth glyphs
    assert len(verts) == len(pipe.map.active_points()) + 4 * 5
    rep = pipe.timers.report()
    assert rep["detect"]["count"] == 1 and rep["frontend"]["count"] == 2
    np.testing.assert_allclose(verts[:3], pipe.map_points()[:3], rtol=0, atol=1e-6)
