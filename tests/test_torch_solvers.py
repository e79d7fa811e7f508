"""Port parity: the dense exact-Schur LM solve (plain kernels B and C on the
CPU), the flat LM engine, batched motion-only BA and the post-solve chi2
prune, against the JAX package on make_synthetic_scene(8 cams, 200 points,
seed 32). Tolerances: cameras atol 5e-4, final cost rtol 1e-3 (the JAX
package's own fused-vs-XLA solve bounds); motion-only inlier masks equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.solvers import dense_ba as jd
from bundleadjustment_tpu.solvers import lm as jl
from bundleadjustment_tpu.solvers import residuals as jr
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import lm as tl
from bundleadjustment_tpu_torch.solvers import residuals as tr

T = torch.from_numpy


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
        cam_fixed=jnp.asarray(cf), pt_fixed=jnp.zeros(200, bool))


def _check_solve(got, ref):
    cams_t, pts_t, info_t = got
    cams_j, pts_j, info_j = ref
    np.testing.assert_allclose(cams_t.numpy(), np.asarray(cams_j), atol=5e-4)
    np.testing.assert_allclose(float(info_t["cost"]), float(info_j["cost"]), rtol=1e-3)
    assert float(info_t["cost"]) < 0.01 * float(info_t["cost0"])


@pytest.mark.parametrize("robust", [True, False])
def test_dense_solve_matches_jax(scene, robust):
    sc, cf = scene
    dense, _ = jd.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                  sc.valid, cf, 200, max_obs=16)
    cfg = jl.LMConfig(max_iters=15, robust=robust)
    ref = jd.dense_ba_solve(dense, jnp.asarray(sc.extr_init),
                            jnp.asarray(sc.points_init), cfg)
    got = td.dense_ba_solve(interop.from_reference(dense, device="cpu"), T(sc.extr_init),
                            T(sc.points_init), interop.from_reference(cfg))
    _check_solve(got, ref)


def test_flat_solve_matches_jax(scene):
    sc, cf = scene
    cfg = jl.LMConfig(max_iters=15)
    ref = jl.ba_solve(_flat(sc, cf), jnp.asarray(sc.extr_init),
                      jnp.asarray(sc.points_init), cfg)
    got = tl.ba_solve(interop.from_reference(_flat(sc, cf), device="cpu"), T(sc.extr_init),
                      T(sc.points_init), interop.from_reference(cfg))
    _check_solve(got, ref)


def test_prune_outliers_matches_jax(scene):
    sc, cf = scene
    uv = sc.uv.copy()
    uv[::17] += 25.0  # gross outliers
    prob = _flat(sc, cf)._replace(uv=jnp.asarray(uv))
    ref = jr.prune_outliers_cams(prob, jnp.asarray(sc.extr_gt), jnp.asarray(sc.points_gt))
    got = tr.prune_outliers_cams(interop.from_reference(prob, device="cpu"), T(sc.extr_gt),
                                 T(sc.points_gt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (~got.numpy()).sum() >= len(uv[::17])


def _motion_inputs(rng, B=3, M=64):
    from bundleadjustment_tpu.geometry.np_se3 import aa_to_R

    K4 = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
    pts = rng.uniform([-1, -1, 3], [1, 1, 6], (B, M, 3)).astype(np.float32)
    extr = np.zeros((B, 6), np.float32)
    extr[:, :3] = rng.normal(0, 0.05, (B, 3))
    extr[:, 3:] = rng.normal(0, 0.05, (B, 3))
    uv = np.zeros((B, M, 2), np.float32)
    for b in range(B):
        xc = pts[b] @ aa_to_R(extr[b, :3]).T + extr[b, 3:]
        uv[b] = np.stack([K4[0] * xc[:, 0] / xc[:, 2] + K4[2],
                          K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], -1)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:, :5] += 40.0  # outliers pruned between outer rounds
    sig = np.ones((B, M), np.float32)
    sig[:, ::3] = 1.44
    valid = np.ones((B, M), bool)
    valid[:, -4:] = False
    e0 = (extr + rng.normal(0, 0.01, extr.shape)).astype(np.float32)
    return K4, e0, pts, uv, sig, valid


@pytest.mark.parametrize("robust", [True, False])
def test_motion_only_matches_jax(rng, robust):
    args = _motion_inputs(rng)
    cfg = jl.MotionOnlyConfig(robust=robust)
    rt_j, inl_j = jl.motion_only_ba(*[jnp.asarray(a) for a in args], cfg)
    rt_t, inl_t = tl.motion_only_ba(*[T(a) for a in args], interop.from_reference(cfg))
    np.testing.assert_allclose(rt_t.numpy(), np.asarray(rt_j), atol=5e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert not inl_t[:, :5].any()

