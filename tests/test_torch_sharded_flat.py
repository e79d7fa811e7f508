"""Port parity for the flat landmark-sharded engine (`parallel/sharded_ba.py`)
and the scaling harness (`parallel/scaling.py`), on the CPU.

- `sharded_ba_solve` on 1 and 2 gloo ranks against the JAX
  `sharded_ba_solve` on 1- and 2-device meshes, on the scene of
  tests/test_sharded_ba.py (8 cameras, 256 landmarks, seed 11, PCG 60
  iterations, 8 LM iterations). Its bounds: cost0 rtol 1e-4, cameras atol
  5e-3, points atol 2e-2; the ranks agree bit for bit.
- The collectives of one LM iteration, counted in a gloo group of one:
  `all_reduces_per_iter` and `all_reduce_bytes_per_iter` (U, g_c, red, one
  [K, 6] per PCG matvec, the cost), and for the sharded dense exact solve
  the reference's `psum_bytes_per_iter` (its test ties it to the compiled
  HLO: tests/test_scaling.py).
- `predicted_efficiency` and `psum_bytes_per_iter` equal to the JAX
  package's; `measure_scaling` over gloo groups of 1 and 2.
"""

import json

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.parallel import scaling as jscaling
from bundleadjustment_tpu.parallel import shard_problem as jshard_problem
from bundleadjustment_tpu.parallel import sharded_ba_solve as jsharded_ba_solve
from bundleadjustment_tpu.parallel.sharded_ba import AXIS
from bundleadjustment_tpu.solvers import LMConfig as JaxLMConfig
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.parallel import multihost, scaling
from bundleadjustment_tpu_torch.parallel import sharded_ba as tsb
from bundleadjustment_tpu_torch.parallel import sharded_dense_ba as tsh
from bundleadjustment_tpu_torch.solvers.lm import LMConfig
from torch_port_helpers import (  # noqa: F401
    flat_sharded_rank,
    one_thread,
    scaling_rank,
    spawn_ranks,
)

pytestmark = pytest.mark.usefixtures("one_thread")

T = torch.from_numpy
CFG = dict(max_iters=8, solver="pcg", pcg_iters=60)


def _scene():
    sc = make_synthetic_scene(n_cams=8, n_pts=256, pixel_noise=0.3, seed=11)
    cf = np.zeros(8, bool)
    cf[:2] = True
    sc.extr_init[1] = sc.extr_gt[1]
    return sc, cf


def _jax_solve(sc, cf, n):
    sharded, shard_of, local_of = jshard_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
        sc.points_init, n)
    sharded = sharded._replace(n_cams=8)
    mesh = Mesh(np.array(jax.devices()[:n]), (AXIS,))
    cams, pts, info = jsharded_ba_solve(sharded, sc.extr_init, JaxLMConfig(**CFG),
                                        mesh)
    return sharded, np.asarray(cams), np.asarray(pts)[shard_of, local_of], info


def _check(cams, pts, cost0, cams_j, pts_j, info_j):
    np.testing.assert_allclose(cost0, float(info_j["cost0"]), rtol=1e-4)
    np.testing.assert_allclose(cams, cams_j, atol=5e-3)
    np.testing.assert_allclose(pts, pts_j, atol=2e-2)


def test_shard_problem_matches_jax_layout():
    """The port's shard of rank r is the JAX package's shard r (and
    `interop.from_reference` takes that shard from the JAX problem)."""
    sc, cf = _scene()
    jax_p, shard_of_j, local_of_j = jshard_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
        sc.points_init, 3)
    for r in range(3):
        p, shard_of, local_of = tsb.shard_problem(
            sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
            sc.points_init, 3, r, device="cpu")
        q = interop.from_reference(jax_p, device="cpu", shard=r)
        for f in ("cam_idx", "pt_idx", "uv", "sigma2", "valid", "points",
                  "pt_valid", "cam_fixed", "K4"):
            torch.testing.assert_close(getattr(p, f), getattr(q, f), rtol=0, atol=0)
        np.testing.assert_array_equal(p.pt_idx.numpy(), np.asarray(jax_p.pt_idx[r]))
    np.testing.assert_array_equal(shard_of, shard_of_j)
    np.testing.assert_array_equal(local_of, local_of_j)


def test_one_shard_matches_jax_one_device():
    sc, cf = _scene()
    jax_p, cams_j, pts_j, info_j = _jax_solve(sc, cf, 1)
    prob = interop.from_reference(jax_p, device="cpu")
    cams, pts, info = tsb.sharded_ba_solve(prob, T(sc.extr_init), LMConfig(**CFG))
    _check(cams.numpy(), pts.numpy()[:256], float(info["cost0"]), cams_j, pts_j,
           info_j)
    assert float(info["cost"]) <= float(info_j["cost"]) * 1.1 + 1e-3


@pytest.mark.parametrize("world", [1, 2])
def test_gloo_ranks_match_jax_mesh(world, tmp_path):
    sc, cf = _scene()
    _, cams_j, pts_j, info_j = _jax_solve(sc, cf, world)
    spawn_ranks(flat_sharded_rank, world,
                (world, str(tmp_path / "rendezvous"), dict(vars(sc)), cf, CFG,
                 str(tmp_path)))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["cams"], ranks[0]["cams"])
        np.testing.assert_array_equal(r["points"], ranks[0]["points"])
    _check(ranks[0]["cams"], ranks[0]["points"], float(ranks[0]["cost0"]),
           cams_j, pts_j, info_j)
    # the seed cost, then every LM iteration's collectives
    assert int(ranks[0]["all_reduces"]) == 1 + 8 * tsb.all_reduces_per_iter(60)


def _bytes_of(solve, iters_a=2, iters_b=5):
    """All-reduced bytes of one LM iteration of `solve(max_iters)` in a gloo
    group of one (the difference of two solves of iters_a and iters_b
    iterations, over iters_b - iters_a), and the seed's bytes."""
    def count(n):
        before = multihost.COLLECTIVES["all_reduce_bytes"]
        solve(n, multihost.default_group())
        return multihost.COLLECTIVES["all_reduce_bytes"] - before

    a, b = count(iters_a), count(iters_b)
    per_iter = (b - a) // (iters_b - iters_a)
    return per_iter, a - iters_a * per_iter


def test_all_reduce_bytes_per_iteration(tmp_path):
    sc, cf = _scene()
    K = 8
    flat, _, _ = tsb.shard_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                   sc.valid, cf, sc.points_init, 1, device="cpu")
    dense, pts, _, _ = tsh.shard_dense_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
        sc.points_init, 1, device="cpu")
    cams = T(sc.extr_init)
    multihost.init_process_group(0, 1, str(tmp_path / "rdv"), "cpu")
    try:
        per_iter, seed = _bytes_of(lambda n, g: tsb.sharded_ba_solve(
            flat, cams, LMConfig(max_iters=n, solver="pcg", pcg_iters=20), g))
        assert per_iter == tsb.all_reduce_bytes_per_iter(K, 20)
        assert seed == 4
        per_iter, seed = _bytes_of(lambda n, g: tsh.sharded_dense_ba_solve(
            dense, cams, pts, LMConfig(max_iters=n, solver="dense"), g))
        assert per_iter == scaling.psum_bytes_per_iter(K)
        assert seed == 4 * (27 * K + 1)  # the seed eval: cost and camera rows
    finally:
        multihost.destroy_process_group()


def test_analytic_model_matches_jax():
    for K, L, D in ((128, 100_000, 8), (128, 100_000, 32), (128, 10_000, 8),
                    (64, 10_000, 2), (8, 256, 1)):
        assert scaling.predicted_efficiency(K, L, D) == jscaling.predicted_efficiency(K, L, D)
        assert scaling.psum_bytes_per_iter(K) == jscaling.psum_bytes_per_iter(K)


def test_measure_scaling_over_gloo_groups(tmp_path):
    kwargs = dict(n_landmarks=256, n_cams=8, obs_per_pt=4, device_counts=[1, 2],
                  lm_iters=2, pcg_iters=10, repeats=1, layout="flat", solver="pcg")
    spawn_ranks(scaling_rank, 2, (2, str(tmp_path / "rendezvous"), kwargs,
                                  str(tmp_path)))
    out = json.loads((tmp_path / "scaling.json").read_text())
    assert out["mode"] == "strong" and out["device_counts"] == [1, 2]
    assert [r["devices"] for r in out["results"]] == [1, 2]
    for r in out["results"]:
        assert r["iters_per_s"] > 0 and r["efficiency"] > 0
    assert out["results"][0]["efficiency"] == 1.0


def test_measure_scaling_without_group():
    out = scaling.measure_scaling(n_landmarks=256, n_cams=8, obs_per_pt=4,
                                  lm_iters=2, pcg_iters=10, repeats=1,
                                  layout="dense", solver="pcg", device="cpu")
    assert out["device_counts"] == [1] and out["results"][0]["iters_per_s"] > 0
