"""Port parity: `metrics/reconstruction.py` against the JAX package. ICP of
a 2,000-point cloud onto a 3,000-point one (points on a bumpy ellipsoid,
the source a moved and noisy subset of the target, every correspondence
well inside max_corr_dist at the end) with distance blocks of fewer rows
than the source: n_corr equal, R and t within 1e-4, fitness within 1e-4
relative. The chunked nearest neighbour equals the one-block one, ties
included (duplicated target points: the first index wins);
`reconstruction_error` writes its three comparison PLYs."""

import os

import numpy as np
import pytest
import torch

from bundleadjustment_tpu.metrics import reconstruction as jrec
from bundleadjustment_tpu_torch.metrics import reconstruction as trec
from bundleadjustment_tpu_torch.vis.mesh import read_ply_vertices
from torch_port_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _rot(axis, angle):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _clouds(n_dst=3000, n_src=2000, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_dst, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    th, ph = np.arccos(v[:, 2]), np.arctan2(v[:, 1], v[:, 0])
    r = 1.0 + 0.2 * np.sin(3 * th) * np.cos(2 * ph)
    dst = v * r[:, None] * np.array([1.0, 0.8, 0.6])
    R0, t0 = _rot([1.0, 2.0, 0.5], np.deg2rad(3.0)), np.array([0.02, -0.015, 0.01])
    src = dst[:n_src] @ R0.T + t0 + rng.normal(scale=0.005, size=(n_src, 3))
    return src.astype(np.float32), dst.astype(np.float32), R0, t0


def test_icp_matches_jax():
    src, dst, R0, _ = _clouds()
    ref = jrec.icp_align(src, dst)
    got = trec.icp_align(src, dst, chunk=300, device="cpu")
    assert got["n_corr"] == ref["n_corr"] == len(src)
    np.testing.assert_allclose(got["R"], ref["R"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["fitness"], ref["fitness"], rtol=1e-4)
    # the recovered motion undoes the applied one
    np.testing.assert_allclose(got["R"] @ R0, np.eye(3), atol=2e-3)


def test_chunked_nearest_equals_one_block():
    src, dst, _, _ = _clouds(n_dst=500, n_src=300, seed=1)
    dst = np.concatenate([dst, dst[::7]])  # exact ties: the first copy wins
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    d_sq = torch.sum(d**2, 1)[None, :]
    one = trec.nearest(s, d, d_sq, len(src))
    for chunk in (1, 7, 64):
        got = trec.nearest(s, d, d_sq, chunk)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
    assert int(one[0].max()) < 500
    assert trec.chunk_rows(100_000) * 100_000 * 4 <= trec.BLOCK_BYTES
    assert trec.chunk_rows(10**12) == 1


def test_reconstruction_error_matches_jax_and_writes_plys(tmp_path):
    src, dst, _, _ = _clouds(seed=2)
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = _rot([0.0, 1.0, 0.0], 0.3), [0.5, -0.2, 1.0]
    # the map in the estimation frame: the first keyframe's pose undone
    est = (src - pose[:3, 3]) @ pose[:3, :3]
    ref, _ = jrec.reconstruction_error(est, dst, first_kf_gt_pose=pose)
    prefix = str(tmp_path / "run")
    got, res = trec.reconstruction_error(est, dst, first_kf_gt_pose=pose,
                                         out_prefix=prefix, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got < 1e-3 and res["n_corr"] == len(src)
    sizes = {s: len(read_ply_vertices(f"{prefix}_{s}.ply"))
             for s in ("gt_cloud", "estimated_cloud", "combined_colored_cloud")}
    assert sizes == {"gt_cloud": len(dst), "estimated_cloud": len(src),
                     "combined_colored_cloud": len(src) + len(dst)}
    assert os.path.getsize(f"{prefix}_combined_colored_cloud.ply") > 0
