"""Port parity: `vis/pointcloud.py` (depth back-projection and normals)
against the JAX package on a rendered 160x120 depth map with invalid pixels
(nan and 0) mixed in. Bounds: validity masks equal, world points within
1e-5 m, normals within 1e-4. Also `geometry/projection.pixel_grid` against
its source, and the card as the default device of this slice's entry points
(without a card they raise; they do not fall back to the CPU)."""

import numpy as np
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import render_plane_sequence
from bundleadjustment_tpu.geometry import projection as jproj
from bundleadjustment_tpu.vis import pointcloud as jpc
from bundleadjustment_tpu_torch.geometry import projection as tproj
from bundleadjustment_tpu_torch.metrics.reconstruction import icp_align
from bundleadjustment_tpu_torch.parallel.frontend import detect_batch_sharded
from bundleadjustment_tpu_torch.vis import poisson as tpoisson
from bundleadjustment_tpu_torch.vis import pointcloud as tpc
from torch_port_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def scene():
    frames, K4 = render_plane_sequence(n_frames=2, width=160, height=120,
                                       fx=150.0, fy=150.0, motion_step=0.06)
    depth = frames[1]["depth"].astype(np.float32).copy()
    rng = np.random.default_rng(5)
    holes = rng.random(depth.shape)
    depth[holes < 0.02] = np.nan
    depth[(holes >= 0.02) & (holes < 0.04)] = 0.0
    return K4, depth, frames[1]["gt_cam_to_world"]


@pytest.mark.parametrize("stride", [1, 3])
def test_backproject_depth_matches_jax(scene, stride):
    K4, depth, pose = scene
    ref_pts, ref_ok = jpc.backproject_depth(K4, depth, pose, stride=stride)
    pts, ok = tpc.backproject_depth(K4, depth, pose, stride=stride, device="cpu")
    np.testing.assert_array_equal(ok, ref_ok)
    assert 0.9 < ok.mean() < 0.99
    np.testing.assert_allclose(pts[ok], ref_pts[ok], rtol=0, atol=1e-5)


def test_depth_normals_match_jax(scene):
    K4, depth, _ = scene
    ref_n, ref_ok = jpc.depth_normals(K4, depth)
    n, ok = tpc.depth_normals(K4, depth, device="cpu")
    np.testing.assert_array_equal(ok, ref_ok)
    assert not ok[0].any() and not ok[:, -1].any() and ok.mean() > 0.7
    np.testing.assert_allclose(n[ok], ref_n[ok], rtol=0, atol=1e-4)


def test_pixel_grid_matches_jax():
    grid = tproj.pixel_grid(5, 7, device="cpu")
    assert grid.device.type == "cpu" and grid.dtype == torch.float32
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jproj.pixel_grid(5, 7)))


_CLOUD = np.zeros((8, 3), np.float32)
DEFAULT_DEVICE_CALLS = {
    "pixel_grid": lambda: tproj.pixel_grid(4, 4),
    "backproject_depth": lambda: tpc.backproject_depth(np.ones(4), np.ones((4, 4))),
    "depth_normals": lambda: tpc.depth_normals(np.ones(4), np.ones((4, 4))),
    "icp_align": lambda: icp_align(_CLOUD, _CLOUD),
    "estimate_normals": lambda: tpoisson.estimate_normals(_CLOUD, k=2),
    "splat_normals": lambda: tpoisson.splat_normals(_CLOUD, _CLOUD, 4),
    "detect_batch_sharded": lambda: detect_batch_sharded(np.zeros((1, 64, 64))),
}


@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_CALLS))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DEFAULT_DEVICE_CALLS[name]()
