"""Port parity for the sharded global BA and the large-O Schur route.

- K5 (`schur_qqt_partial`) and kernel D (`schur_prepare`): their plain
  versions against the Pallas kernels in interpret mode
  (`fused_schur_prepare_s` without red27, float32; `fused_schur_prepare`),
  the port's (i, k)-ordered S_qqt and red6 [6,K] permuted to the
  reference's (k, i) order and red6 [K,6].
  Tolerances: the JAX package's Pallas-vs-XLA bounds, rtol 2e-4 / atol 2e-3
  relative to each block's own magnitude for S_qqt, red6 and G (their sums
  cancel, see `torch_port_helpers.block_scale`); zv and vinv6 elementwise.
- The large-O route, O = 72 (71 cameras, a tail of landmarks seen by all):
  the port's `dense_ba_solve` (kernel D + Pf + Q Q^T) against the JAX
  `dense_ba_solve` on the CPU (its XLA path, the same LM math). Cameras
  atol 5e-4 and final cost rtol 1e-4 (the JAX package's own solve bounds).
- The sharded solve: 2 gloo ranks of the port against the JAX sharded solve
  on a 2-device mesh, on the scene of tests/test_sharded_dense_ba.py, and
  one port rank without a group against the port's single-device solve.
  Cameras atol 5e-3, points atol 2e-2 (that test's own bounds).
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu.parallel import sharded_dense_ba as jsh
from bundleadjustment_tpu.solvers import dense_ba as jd
from bundleadjustment_tpu.solvers import pallas_dense_eval as jp
from bundleadjustment_tpu.solvers.lm import LMConfig as JaxLMConfig
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.data.track_scene import make_track_scene
from bundleadjustment_tpu_torch.parallel import sharded_dense_ba as tsh
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from bundleadjustment_tpu_torch.solvers.lm import LMConfig
from test_torch_dense_kernels import _cm_args, _setup
from torch_port_helpers import (
    as_tensor,
    assert_blocks_close,
    assert_close,
    sharded_solve_rank,
)

T = torch.from_numpy


def _large_o_scene(n_pts=300, n_obs=4000, n_all=20, seed=3):
    """71 cameras; n_all landmarks seen by every camera, so O = 72. The two
    most-observed cameras are fixed at their true poses (no free gauge)."""
    sc = make_track_scene(n_cams=71, n_pts=n_pts, n_obs=n_obs, n_all=n_all,
                          seed=seed)
    cf = np.zeros(71, bool)
    gauge = np.argsort(-np.bincount(sc.cam_idx, minlength=71), kind="stable")[:2]
    cf[gauge] = True
    sc.extr_init[gauge] = sc.extr_gt[gauge]
    return sc, cf


def _prepare_inputs(cm, R, t, Xt, robust):
    """Seed blocks through the JAX eval kernel: (lam, Vu, g_p, W18)."""
    _, _, Vu, gp, W = jp.fused_eval_assemble(*_cm_args(cm), R, t, Xt,
                                             robust=robust, interpret=True)
    O, L = cm.cam_t.shape
    return jnp.float32(1e-3), Vu, gp, W.reshape(18, O, L)


def _torch_args(lam, Vu, gp, W18, cm):
    tcm = interop.from_reference(cm, device="cpu")
    return (torch.tensor(float(lam)), as_tensor(Vu), as_tensor(gp), tcm.pt_valid,
            as_tensor(W18), tcm.cam_t, int(cm.cam_fixed.shape[0]))


def _ki(S, K):
    """[6K,6K] in (i, k) row order -> (k, i) order (row k*6 + i)."""
    return S.reshape(6, K, 6, K).permute(1, 0, 3, 2).reshape(6 * K, 6 * K)


def _large_o_setup():
    sc, cf = _large_o_scene(n_pts=96, n_obs=1200, n_all=8)
    dense, _ = jd.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                  sc.valid, cf, 96, max_obs=128)
    cm = jd._to_cm(dense)
    R = aa_to_rotmat(jnp.asarray(sc.extr_init[:, :3]))
    return cm, R, jnp.asarray(sc.extr_init[:, 3:]), jnp.asarray(sc.points_init.T)


@pytest.mark.parametrize("robust", [True, False])
def test_schur_qqt_partial_matches_pallas(robust):
    _, _, cm, R, t, Xt = _setup()
    lam, Vu, gp, W18 = _prepare_inputs(cm, R, t, Xt, robust)
    K = R.shape[0]
    ref = jp.fused_schur_prepare_s(lam, Vu, gp, cm.pt_valid, W18, cm.cam_t, K,
                                   red27=None, s_bf16=False, interpret=True)
    got = dk.schur_qqt_partial(*_torch_args(lam, Vu, gp, W18, cm))
    assert_blocks_close("S", _ki(got[0], K), ref[0])
    assert_blocks_close("red6", got[3].T, ref[3])
    assert_close(got[1], ref[1])
    assert_close(got[2], ref[2])


@pytest.mark.parametrize("shape", ["O8", "O72"])
def test_schur_prepare_matches_pallas(shape):
    if shape == "O8":
        _, _, cm, R, t, Xt = _setup()
    else:
        cm, R, t, Xt = _large_o_setup()
        assert cm.cam_t.shape[0] == 72
    lam, Vu, gp, W18 = _prepare_inputs(cm, R, t, Xt, robust=True)
    K = R.shape[0]
    ref = jp.fused_schur_prepare(lam, Vu, gp, cm.pt_valid, W18, cm.cam_t, K,
                                 interpret=True)
    got = dk.schur_prepare(*_torch_args(lam, Vu, gp, W18, cm))
    O, L = cm.cam_t.shape
    assert_blocks_close("W", got[0].reshape(6, 3, O, L),
                        np.asarray(ref[0]).reshape(6, 3, O, L))
    assert_blocks_close("red6", got[3].T, ref[3])
    assert_close(got[1], ref[1])
    assert_close(got[2], ref[2])


def test_large_o_solve_matches_jax():
    sc, cf = _large_o_scene()
    dense, _ = jd.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                  sc.valid, cf, len(sc.points_init), max_obs=128)
    O = dense.cam_idx.shape[1]
    assert O == 72 and td.schur_route(O) == "prepare"
    cfg = JaxLMConfig(max_iters=10)
    ref = jd.dense_ba_solve(dense, jnp.asarray(sc.extr_init),
                            jnp.asarray(sc.points_init), cfg)
    cams, _, info = td.dense_ba_solve(interop.from_reference(dense, device="cpu"),
                                      T(sc.extr_init), T(sc.points_init),
                                      interop.from_reference(cfg))
    np.testing.assert_allclose(cams.numpy(), np.asarray(ref[0]), atol=5e-4)
    np.testing.assert_allclose(float(info["cost"]), float(ref[2]["cost"]), rtol=1e-4)
    assert float(info["cost"]) < 0.1 * float(info["cost0"])


def test_schur_route_keeps_only_the_o_term():
    """O alone decides the route: the 600-camera shape of kernel C's tests
    (K > 128, past the reference's TPU gate) stays on the S kernel."""
    assert td.schur_route(8) == td.schur_route(64) == "s"
    assert td.schur_route(72) == "prepare"


def _sharded_scene():
    sc = make_synthetic_scene(n_cams=8, n_pts=256, pixel_noise=0.3, seed=53)
    cf = np.zeros(8, bool)
    cf[:2] = True
    sc.extr_init[1] = sc.extr_gt[1]
    return sc, cf


def test_two_gloo_ranks_match_jax_sharded(tmp_path):
    sc, cf = _sharded_scene()
    prob, pts_sh, shard_of, local_of = jsh.shard_dense_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
        sc.points_init, 2)
    mesh = Mesh(np.array(jax.devices()[:2]), (jsh.AXIS,))
    cams_j, pts_j, _ = jsh.sharded_dense_ba_solve(
        prob, sc.extr_init, pts_sh, JaxLMConfig(max_iters=8, solver="dense"), mesh)
    pts_j = np.asarray(pts_j)[shard_of, local_of]

    ctx = torch.multiprocessing.spawn(
        sharded_solve_rank, nprocs=2, join=False,
        args=(2, str(tmp_path / "rendezvous"), dict(vars(sc)), cf, 8,
              str(tmp_path)))
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish within 120 s")
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["cams"], ranks[1]["cams"])
    np.testing.assert_array_equal(ranks[0]["points"], ranks[1]["points"])
    np.testing.assert_allclose(ranks[0]["cams"], np.asarray(cams_j), atol=5e-3)
    np.testing.assert_allclose(ranks[0]["points"], pts_j, atol=2e-2)


def test_one_rank_without_group_matches_single_device():
    sc, cf = _sharded_scene()
    prob, pts, shard_of, local_of = tsh.shard_dense_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
        sc.points_init, 1, device="cpu")
    cams_s, pts_s, _ = tsh.sharded_dense_ba_solve(
        prob, T(sc.extr_init), pts, LMConfig(max_iters=8))
    dense, _ = td.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                  sc.valid, cf, 256, device="cpu")
    cams_1, pts_1, _ = td.dense_ba_solve(dense, T(sc.extr_init), T(sc.points_init),
                                         LMConfig(max_iters=8))
    np.testing.assert_allclose(cams_s.numpy(), cams_1.numpy(), atol=5e-3)
    np.testing.assert_allclose(tsh.gather_points(pts_s, shard_of, local_of),
                               pts_1.numpy(), atol=2e-2)


def test_group_of_one_runs_the_collectives(tmp_path):
    """A gloo group of one all-reduces and gathers (it is not the identity
    of the no-group path) and gives the no-group solve's result."""
    from bundleadjustment_tpu_torch.parallel import multihost

    sc, cf = _sharded_scene()
    prob, pts, shard_of, local_of = tsh.shard_dense_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
        sc.points_init, 1, device="cpu")
    cfg = LMConfig(max_iters=4)
    cams_0, pts_0, _ = tsh.sharded_dense_ba_solve(prob, T(sc.extr_init), pts, cfg)
    assert multihost.init_process_group(0, 1, str(tmp_path / "rdv"), "cpu") == "gloo"
    try:
        before = dict(tsh.COLLECTIVES)
        cams_1, pts_1, _ = tsh.sharded_dense_ba_solve(
            prob, T(sc.extr_init), pts, cfg, multihost.default_group())
        gathered = tsh.gather_points(pts_1, shard_of, local_of,
                                     multihost.default_group())
        # seed eval: cost and red; per iteration: S_qqt, red6, cost, red
        assert tsh.COLLECTIVES["all_reduce"] - before["all_reduce"] == 2 + 4 * 4
        assert tsh.COLLECTIVES["all_gather"] - before["all_gather"] == 1
    finally:
        multihost.destroy_process_group()
    torch.testing.assert_close(cams_1, cams_0, rtol=0, atol=0)
    np.testing.assert_array_equal(gathered, tsh.gather_points(pts_0, shard_of,
                                                              local_of))


def test_sharded_solve_without_config_raises():
    sc, cf = _sharded_scene()
    prob, pts, _, _ = tsh.shard_dense_problem(
        sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid, cf,
        sc.points_init, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="PCG"):
        tsh.sharded_dense_ba_solve(prob, T(sc.extr_init), pts)
