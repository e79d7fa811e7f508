"""Port parity of the public functions that complete the port's modules: the
L2 matcher (`l2_distance_matrix`, `match_descriptors(metric="l2")`, the
default metric of both packages), `median_scene_depth`, `make_intrinsics`,
`rt6_identity`, the (R, t) form of `prune_outliers` and
`build_odometry_graph`, on the JAX package's own test cases
(tests/test_matching.py, tests/test_projection_triangulation.py,
tests/test_posegraph.py). Tolerances: match indices and masks equal; squared
L2 distances within 8 float32 ulps of |a|^2 + |b|^2, the rounding of the
|a|^2 + |b|^2 - 2 a.b form that both packages evaluate (its cancellation
makes near-zero distances differ by far more than a relative tolerance);
depths and graph transforms to 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.geometry import np_se3
from bundleadjustment_tpu.geometry import projection as jp
from bundleadjustment_tpu.geometry import se3 as jse3
from bundleadjustment_tpu.geometry import triangulation as jt
from bundleadjustment_tpu.ops import matching as jm
from bundleadjustment_tpu.parallel import posegraph as jpg
from bundleadjustment_tpu.solvers import residuals as jr
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.geometry import projection as tp
from bundleadjustment_tpu_torch.geometry import se3 as tse3
from bundleadjustment_tpu_torch.geometry import triangulation as tt
from bundleadjustment_tpu_torch.ops import matching as tm
from bundleadjustment_tpu_torch.parallel import posegraph as tpg
from bundleadjustment_tpu_torch.solvers import residuals as tr

T = torch.from_numpy


def _l2_case(rng, case):
    """(a, b, valid_a, valid_b, kw) of the JAX package's L2 matcher tests."""
    if case == "permutation":
        a = rng.normal(size=(60, 32)).astype(np.float32)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b = a[rng.permutation(60)] + rng.normal(0, 0.01, (60, 32)).astype(np.float32)
        return a, b, None, None, {}
    if case == "ambiguous":
        a = rng.normal(size=(5, 16)).astype(np.float32)
        return a, np.concatenate([a[:1], a[:1], a[1:] + 10.0]), None, None, {}
    if case == "cross_check":
        b = rng.normal(size=(4, 16)).astype(np.float32) * 10
        a = np.stack([b[0] + 0.001, b[0] + 0.01, b[2], b[3]]).astype(np.float32)
        return a, b, None, None, {}
    if case == "validity":
        a = rng.normal(size=(6, 8)).astype(np.float32)
        return (a, a.copy(), np.array([1, 1, 0, 1, 1, 1], bool),
                np.array([1, 0, 1, 1, 1, 1], bool), {})
    if case == "max_dist":
        a = rng.normal(size=(4, 8)).astype(np.float32)
        return a, a + 5.0, None, None, {"max_dist": 0.5}
    # many noisy near-duplicates, no cross-check, a loose ratio
    a = rng.normal(size=(200, 32)).astype(np.float32)
    b = np.concatenate([a[rng.permutation(200)[:150]], rng.normal(size=(50, 32))])
    b = (b + rng.normal(0, 0.3, b.shape)).astype(np.float32)
    return a, b, rng.random(200) > 0.1, None, {"ratio": 0.9, "cross_check": False}


def _assert_sq_close(got, ref, a, b):
    """Squared distances equal up to the rounding of the squared form."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    scale = (a * a).sum(1).max() + (b * b).sum(1).max()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0,
                               atol=8 * np.finfo(np.float32).eps * scale)


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else T(x)


def test_l2_distance_matrix_matches_jax(rng):
    a = rng.normal(size=(20, 16)).astype(np.float32)
    b = rng.normal(size=(30, 16)).astype(np.float32)
    va, vb = rng.random(20) > 0.2, rng.random(30) > 0.2
    got = tm.l2_distance_matrix(T(a), T(b), T(va), T(vb)).numpy()
    ref = np.asarray(jm.l2_distance_matrix(jnp.asarray(a), jnp.asarray(b),
                                           jnp.asarray(va), jnp.asarray(vb)))
    _assert_sq_close(got, ref, a, b)
    exact = ((a[:, None] - b[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got[va][:, vb], exact[va][:, vb], atol=1e-3)


@pytest.mark.parametrize("case", ["permutation", "ambiguous", "cross_check",
                                  "validity", "max_dist", "noisy_no_cross_check"])
def test_l2_matcher_matches_jax(rng, case):
    a, b, va, vb, kw = _l2_case(rng, case)
    ref = jm.match_descriptors(jnp.asarray(a), jnp.asarray(b), _jnp(va), _jnp(vb),
                               metric="l2", **kw)
    got = tm.match_descriptors(T(a), T(b), _t(va), _t(vb), metric="l2", **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    _assert_sq_close(got[1].numpy() ** 2, np.asarray(ref[1]) ** 2, a, b)
    idx = got[0].numpy()
    if case == "permutation":
        assert (idx >= 0).mean() > 0.9
    elif case == "ambiguous":
        assert idx[0] == -1
    elif case == "cross_check":
        assert idx[0] == 0 and idx[1] == -1
    elif case == "validity":
        assert idx[2] == -1 and 1 not in idx.tolist()
    elif case == "max_dist":
        assert (idx == -1).all()
    else:
        assert (idx >= 0).sum() > 50


def test_default_metric_is_l2_in_both_packages(rng):
    a, b, va, vb, kw = _l2_case(rng, "noisy_no_cross_check")
    ref_default = jm.match_descriptors(jnp.asarray(a), jnp.asarray(b), _jnp(va), **kw)
    ref_l2 = jm.match_descriptors(jnp.asarray(a), jnp.asarray(b), _jnp(va),
                                  metric="l2", **kw)
    got_default = tm.match_descriptors(T(a), T(b), _t(va), **kw)
    got_l2 = tm.match_descriptors(T(a), T(b), _t(va), metric="l2", **kw)
    for r in (ref_default, ref_l2):
        np.testing.assert_array_equal(np.asarray(r[0]), got_default[0].numpy())
    torch.testing.assert_close(got_default, got_l2, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tm.match_descriptors(T(a), T(b), metric="cosine")


@pytest.mark.parametrize("n,valid_frac", [(101, 1.0), (100, 1.0), (80, 0.5), (7, 0.0)])
def test_median_scene_depth_matches_jax(rng, n, valid_frac):
    X = rng.uniform([-1, -1, 2], [1, 1, 5], size=(n, 3)).astype(np.float32)
    extr = np.array([0.02, -0.03, 0.01, 0.3, 0.02, 0.05], np.float32)
    valid = rng.random(n) < valid_frac
    ref = float(jt.median_scene_depth(jnp.asarray(extr), jnp.asarray(X), jnp.asarray(valid)))
    got = tt.median_scene_depth(T(extr), T(X), T(valid))
    assert got.shape == () and got.dtype == torch.float32
    if valid.any():
        np.testing.assert_allclose(float(got), ref, rtol=1e-6)
    else:
        assert np.isinf(ref) and torch.isinf(got)
    if valid_frac == 1.0 and n % 2:
        z = X @ np_se3.aa_to_R(extr[:3])[2] + extr[5]
        np.testing.assert_allclose(float(got), np.median(z), rtol=1e-6)


def test_make_intrinsics_and_rt6_identity_match_jax():
    got = tp.make_intrinsics(525.0, 525.0, 319.5, 239.5, device="cpu")
    ref = jp.make_intrinsics(525.0, 525.0, 319.5, 239.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.float32
    assert tp.make_intrinsics(1, 2, 3, 4, dtype=torch.float64, device="cpu").dtype == torch.float64
    ident = tse3.rt6_identity(device="cpu")
    np.testing.assert_array_equal(ident.numpy(), np.asarray(jse3.rt6_identity()))
    x = torch.tensor([[0.3, -1.0, 2.5]])
    torch.testing.assert_close(tse3.rt6_apply(ident, x), x)


def test_prune_outliers_matches_jax():
    sc = make_synthetic_scene(n_cams=6, n_pts=150, pixel_noise=0.5, outlier_frac=0.1,
                              seed=5)
    prob = jr.BAProblem(
        K4=jnp.asarray(sc.K4), cam_idx=jnp.asarray(sc.cam_idx),
        pt_idx=jnp.asarray(sc.pt_idx), uv=jnp.asarray(sc.uv),
        sigma2=jnp.asarray(sc.sigma2), valid=jnp.asarray(sc.valid),
        cam_fixed=jnp.zeros(6, bool), pt_fixed=jnp.zeros(150, bool))
    pts = sc.points_gt.copy()
    pts[:5, 2] -= 50.0  # behind every camera: the cheirality gate
    R, t = jr.cams_to_Rt(jnp.asarray(sc.extr_gt))
    ref = np.asarray(jr.prune_outliers(prob, R, t, jnp.asarray(pts)))
    tprob = interop.from_reference(prob, device="cpu")
    tR, tt_ = tr.cams_to_Rt(T(sc.extr_gt))
    got = tr.prune_outliers(tprob, tR, tt_, T(pts)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, tr.prune_outliers_cams(tprob, T(sc.extr_gt), T(pts)).numpy())
    assert 0 < (~got & sc.valid).sum() < sc.valid.sum() // 2


def _loop_poses(rng, K=20, drift=0.02):
    """tests/test_posegraph.py's circle with drifted odometry."""
    gt = []
    for k in range(K):
        ang = 2 * np.pi * k / K
        R = np_se3.aa_to_R(np.array([0.0, 0.0, ang]))
        gt.append(np.concatenate([[0.0, 0.0, ang], -R @ [np.cos(ang), np.sin(ang), 0.0]]))
    gt = np.asarray(gt)
    poses = [gt[0]]
    for i in range(K - 1):
        rel = np_se3.rt6_compose(gt[i], np_se3.rt6_inverse(gt[i + 1]))
        rel += rng.normal(0, drift, 6)
        poses.append(np_se3.rt6_compose(np_se3.rt6_inverse(rel), poses[i]))
    return gt, np.asarray(poses)


@pytest.mark.parametrize("loops,fixed", [(False, None), (True, None), (True, [0, 5])])
def test_build_odometry_graph_matches_jax(rng, loops, fixed):
    gt, poses = _loop_poses(rng)
    loop_edges = None
    if loops:
        loop_edges = [(19, 0, np_se3.rt6_compose(gt[-1], np_se3.rt6_inverse(gt[0])), 50.0),
                      (10, 2, np_se3.rt6_compose(gt[10], np_se3.rt6_inverse(gt[2])), None)]
    node_fixed = None
    if fixed is not None:
        node_fixed = np.zeros(20, bool)
        node_fixed[fixed] = True
    kw = dict(loop_edges=loop_edges, odo_weight=2.0, loop_weight=7.0, node_fixed=node_fixed)
    ref = jpg.build_odometry_graph(poses, **kw)
    got = tpg.build_odometry_graph(poses, device="cpu", **kw)
    for name in ("edge_i", "edge_j", "valid", "node_fixed"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    for name in ("rel", "weight"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-6)
    assert got.rel.dtype == torch.float32 and got.edge_i.dtype == torch.int64
    if loops and fixed is None:
        # the graph closes the loop, as the JAX package's own test holds it
        opt, info = tpg.solve_pose_graph(got, T(poses.astype(np.float32)))
        assert float(info["cost"]) < 0.05 * float(info["cost0"])
