"""Port parity for PCG, the matrix-free Schur solve, on the flat, dense and
sharded dense engines, against the JAX package on the CPU (plain kernel
versions on the port's side), on make_synthetic_scene(8 cams, 200 points,
seed 32) with the two first cameras fixed.

Tolerances, the JAX package's own (no looser):
- `solve_schur_pcg` against JAX's and against the exact dense solve: atol
  1e-4 / rtol 1e-2 (tests/test_solvers.py, test_pcg_matches_dense);
- the LM solves (flat, dense, sharded dense default): cost0 rtol 1e-4,
  cameras atol 5e-3, points atol 2e-2 (tests/test_dense_ba.py,
  test_dense_matches_flat_solver; tests/test_sharded_dense_ba.py). The
  port meets atol 1e-5 on cameras there (measured: 1.1e-6 flat, 6e-7
  dense), asserted too;
- the no-op freeze: a `pcg_tol` of 1e-1 and of 1e-9 give the same bits, in
  both packages;
- `--ba-solver pcg` through the CLI.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.parallel import sharded_dense_ba as jsh
from bundleadjustment_tpu.solvers import dense_ba as jd
from bundleadjustment_tpu.solvers import lm as jl
from bundleadjustment_tpu.solvers import residuals as jr
from bundleadjustment_tpu.solvers import schur as js
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.parallel import sharded_dense_ba as tsh
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from bundleadjustment_tpu_torch.solvers import lm as tl
from bundleadjustment_tpu_torch.solvers import schur as ts
from torch_port_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

T = torch.from_numpy
PCG = jl.LMConfig(max_iters=10, solver="pcg", pcg_iters=60)


@pytest.fixture(scope="module")
def scene():
    sc = make_synthetic_scene(n_cams=8, n_pts=200, pixel_noise=0.3, seed=32)
    cf = np.zeros(8, bool)
    cf[:2] = True
    sc.extr_init[1] = sc.extr_gt[1]
    return sc, cf


def _flat(sc, cf):
    return jr.BAProblem(
        K4=jnp.asarray(sc.K4), cam_idx=jnp.asarray(sc.cam_idx),
        pt_idx=jnp.asarray(sc.pt_idx), uv=jnp.asarray(sc.uv),
        sigma2=jnp.asarray(sc.sigma2), valid=jnp.asarray(sc.valid),
        cam_fixed=jnp.asarray(cf), pt_fixed=jnp.zeros(len(sc.points_init), bool))


def _dense(sc, cf):
    return jd.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                              sc.valid, cf, len(sc.points_init), max_obs=16)[0]


def _check_lm(got, ref, pts_ref=None):
    cams_t, pts_t, info_t = got
    cams_j, pts_j, info_j = ref
    np.testing.assert_allclose(float(info_t["cost0"]), float(info_j["cost0"]),
                               rtol=1e-4)
    np.testing.assert_allclose(cams_t.numpy(), np.asarray(cams_j), atol=5e-3)
    np.testing.assert_allclose(cams_t.numpy(), np.asarray(cams_j), atol=1e-5)
    np.testing.assert_allclose(pts_t.numpy(),
                               np.asarray(pts_j) if pts_ref is None else pts_ref,
                               atol=2e-2)
    assert float(info_t["cost"]) < 0.01 * float(info_t["cost0"])


def _blocks(robust=False):
    """The JAX package's damped Schur blocks of test_pcg_matches_dense's
    scene, and the port's copy of them."""
    sc = make_synthetic_scene(n_cams=6, n_pts=80, pixel_noise=0.3, seed=3)
    cf = np.zeros(6, bool)
    cf[0] = True
    prob = _flat(sc, cf)
    R, t = jr.cams_to_Rt(jnp.asarray(sc.extr_init))
    r, Jc, Jp, _ = jr.residuals_and_jacobians(prob, R, t,
                                              jnp.asarray(sc.points_init),
                                              robust=robust)
    blocks = js.build_blocks(r, Jc, Jp, prob.cam_idx, prob.pt_idx, 6, 80, 1e-3,
                             prob.cam_fixed, prob.pt_fixed)
    port = ts.BABlocks(*(torch.from_numpy(np.array(f)) for f in blocks))
    port.cam_idx, port.pt_idx = port.cam_idx.long(), port.pt_idx.long()
    return blocks, port


def test_solve_schur_pcg_matches_jax():
    blocks, port = _blocks()
    ref = np.asarray(js.solve_schur_pcg(blocks, max_iters=100, tol=1e-9))
    got = ts.solve_schur_pcg(port, max_iters=100, tol=1e-9).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-2)
    np.testing.assert_allclose(got, ts.solve_schur_dense(port).numpy(),
                               atol=1e-4, rtol=1e-2)


def test_pcg_tolerance_freezes_nothing():
    """The reference's "freeze once converged" keeps the new iterate on both
    branches: a loose tolerance changes nothing, there and here."""
    blocks, port = _blocks()
    for solve, b in ((js.solve_schur_pcg, blocks), (ts.solve_schur_pcg, port)):
        loose = np.asarray(solve(b, max_iters=100, tol=1e-1))
        tight = np.asarray(solve(b, max_iters=100, tol=1e-9))
        np.testing.assert_array_equal(loose, tight)


@pytest.mark.parametrize("robust", [True, False])
def test_flat_pcg_solve_matches_jax(scene, robust):
    sc, cf = scene
    cfg = PCG._replace(robust=robust)
    ref = jl.ba_solve(_flat(sc, cf), jnp.asarray(sc.extr_init),
                      jnp.asarray(sc.points_init), cfg)
    got = tl.ba_solve(interop.from_reference(_flat(sc, cf), device="cpu"),
                      T(sc.extr_init), T(sc.points_init),
                      interop.from_reference(cfg))
    _check_lm(got, ref)


@pytest.mark.parametrize("robust", [True, False])
def test_dense_pcg_solve_matches_jax(scene, robust):
    sc, cf = scene
    cfg = PCG._replace(robust=robust)
    dense = _dense(sc, cf)
    ref = jd.dense_ba_solve(dense, jnp.asarray(sc.extr_init),
                            jnp.asarray(sc.points_init), cfg)
    got = td.dense_ba_solve(interop.from_reference(dense, device="cpu"),
                            T(sc.extr_init), T(sc.points_init),
                            interop.from_reference(cfg), ops=dk.PLAIN_OPS)
    _check_lm(got, ref)


def test_dense_pcg_matches_flat_pcg(scene):
    """The port's own dense and flat PCG engines agree (the JAX package's
    test_dense_matches_flat_solver, on the port)."""
    sc, cf = scene
    cfg = interop.from_reference(PCG)
    flat = tl.ba_solve(interop.from_reference(_flat(sc, cf), device="cpu"),
                       T(sc.extr_init), T(sc.points_init), cfg)
    dense = td.dense_ba_solve(interop.from_reference(_dense(sc, cf), device="cpu"),
                              T(sc.extr_init), T(sc.points_init), cfg)
    _check_lm(dense, flat)


def _raise(*_a, **_k):
    raise AssertionError("the PCG step called a Schur kernel or the Cholesky")


def test_dense_pcg_step_takes_no_schur_kernel(scene):
    """The PCG step goes through kernel B without back-substitution only:
    C, K5, D, B with back-substitution and the camera Cholesky are never
    called (and so never launched on the card)."""
    sc, cf = scene
    calls = []

    def eval_assemble(*a, **k):
        calls.append(1)
        return dk.eval_assemble_plain(*a, **k)

    ops = dk.PLAIN_OPS._replace(eval_assemble=eval_assemble,
                                eval_assemble_bs=_raise, schur_prepare_s=_raise,
                                schur_qqt_partial=_raise, schur_prepare=_raise,
                                chol_solve=_raise)
    td.dense_ba_solve(interop.from_reference(_dense(sc, cf), device="cpu"),
                      T(sc.extr_init), T(sc.points_init),
                      tl.LMConfig(max_iters=4, solver="pcg", pcg_iters=20), ops=ops)
    assert len(calls) == 1 + 4  # the seed eval and one trial eval an iteration


def _sharded(sc, cf, n_shards):
    return (jsh.shard_dense_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                                    sc.sigma2, sc.valid, cf, sc.points_init,
                                    n_shards),
            tsh.shard_dense_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                                    sc.sigma2, sc.valid, cf, sc.points_init,
                                    n_shards, device="cpu"))


def test_sharded_dense_default_config_is_pcg(scene):
    """config=None is the reference's PCG default on both sides (one shard:
    a 1-device mesh against the port without a group)."""
    sc, cf = scene
    (jprob, jpts, shard_of, local_of), (tprob, tpts, _, _) = _sharded(sc, cf, 1)
    mesh = Mesh(np.array(jax.devices()[:1]), (jsh.AXIS,))
    cams_j, pts_j, info_j = jsh.sharded_dense_ba_solve(jprob, sc.extr_init, jpts,
                                                       None, mesh)
    got = tsh.sharded_dense_ba_solve(tprob, T(sc.extr_init), tpts)
    _check_lm((got[0], torch.from_numpy(tsh.gather_points(got[1], shard_of,
                                                          local_of)), got[2]),
              (cams_j, np.asarray(pts_j)[shard_of, local_of], info_j))
    ref_cfg = jl.LMConfig(max_iters=10, solver="pcg")
    dense = _dense(sc, cf)
    ref = jd.dense_ba_solve(dense, jnp.asarray(sc.extr_init),
                            jnp.asarray(sc.points_init), ref_cfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=5e-3)


def test_sharded_dense_pcg_group_of_one_counts_collectives(scene, tmp_path):
    """A gloo group of one: per LM iteration the rhs rows, one [K, 6]
    back-projection per PCG matvec, the trial cost and its camera rows;
    two for the seed eval. The result is the no-group solve's."""
    from bundleadjustment_tpu_torch.parallel import multihost

    sc, cf = scene
    _, (prob, pts, _, _) = _sharded(sc, cf, 1)
    cfg = tl.LMConfig(max_iters=3, solver="pcg", pcg_iters=12)
    cams_0 = tsh.sharded_dense_ba_solve(prob, T(sc.extr_init), pts, cfg)[0]
    multihost.init_process_group(0, 1, str(tmp_path / "rdv"), "cpu")
    try:
        before = dict(tsh.COLLECTIVES)
        cams_1 = tsh.sharded_dense_ba_solve(prob, T(sc.extr_init), pts, cfg,
                                            multihost.default_group())[0]
        n = tsh.COLLECTIVES["all_reduce"] - before["all_reduce"]
        nbytes = tsh.COLLECTIVES["all_reduce_bytes"] - before["all_reduce_bytes"]
    finally:
        multihost.destroy_process_group()
    assert n == 2 + 3 * (1 + 12 + 2)
    K = 8
    assert nbytes == 4 * ((1 + 27 * K) + 3 * (6 * K * (1 + 12) + 1 + 27 * K))
    torch.testing.assert_close(cams_1, cams_0, rtol=0, atol=0)


def test_cli_ba_solver_pcg_runs(tmp_path):
    from test_torch_pipeline import _cli_run

    res, _ = _cli_run(tmp_path, "--ba-solver", "pcg")
    assert res["frames"] == 6 and res["ate_rmse"] < 0.06
