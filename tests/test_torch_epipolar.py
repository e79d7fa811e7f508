"""Port parity of the two-view estimators (`geometry/epipolar.py`) against
the JAX package on the scenes of tests/test_epipolar.py. Both packages get
the same RANSAC samples: the indices the JAX functions draw from their key
(`_sample_indices` on the same split keys) are fed to the port.

Tolerances, float32 SVD / eigh on both sides: E (unit singular values)
compared up to sign, atol 2e-3; H after the division by H[2,2], 1e-3 of its
largest entry; rt6 atol 1e-3; inlier masks equal except where a chi2 lies
within 1e-3 (relative) of its threshold; `used_homography` and `ok` equal;
inlier counts within the number of such borderline points. Scores: rtol
5e-3, and the score ratio atol 1e-2. The scores are looser than the 1e-3 of
the matrices because the inlier refit takes the smallest eigenvector of a
float32 9x9 moment matrix whose two smallest eigenvalues (5e-5 and 2e-3 on
these scenes) sit under a largest one of 180: two LAPACK builds return null
vectors ~1e-3 apart, and at fx = 525 that moves each epipolar distance by a
few tenths of a pixel (measured: scores 1.7e-3 apart, ratios 6.5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_tpu.geometry import epipolar as je
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.geometry import epipolar as te
from test_epipolar import two_view_scene

K4 = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
T = torch.from_numpy
N_HYP = 256


def _scene(seed, **kw):
    uv1, uv2, rt_gt, gt_out = two_view_scene(np.random.default_rng(seed), **kw)
    return np.asarray(uv1), np.asarray(uv2), rt_gt, gt_out


def _idx(key, n, size):
    """The samples the JAX estimator draws from `key` over n valid pairs."""
    return np.asarray(je._sample_indices(key, jnp.ones(n, bool), N_HYP, size))


def _up_to_sign(a, ref):
    return a * np.sign(np.sum(a * ref))


def _near(chi2s, thr):
    """Points with any chi2 within 1e-3 (relative) of the threshold."""
    return np.any([np.abs(np.asarray(c) - thr) < 1e-3 * thr for c in chi2s], axis=0)


def _hom(uv):
    return jnp.concatenate([jnp.asarray(uv), jnp.ones((len(uv), 1))], -1)


def _e_chi2(E, uv1, uv2):
    x1 = (uv1 - K4[2:]) / K4[:2]
    x2 = (uv2 - K4[2:]) / K4[:2]
    d1, d2 = je._epipolar_chi2(jnp.asarray(E)[None], _hom(x1), _hom(x2), K4[0] ** 2)
    return d1[0], d2[0]


def _h_chi2(H, uv1, uv2):
    d1, d2 = je._homography_chi2(jnp.asarray(H)[None], _hom(uv1), _hom(uv2), 1.0)
    return d1[0], d2[0]


def test_minimal_solvers_and_normalization_match_jax():
    uv1, uv2, _, _ = _scene(0, planar=True)
    valid = np.ones(len(uv1), bool)
    valid[::7] = False
    x_j, T_j = je._normalize_points(jnp.asarray(uv1), jnp.asarray(valid))
    x_t, T_t = te._normalize_points(T(uv1.copy()), T(valid))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=1e-5, atol=1e-6)

    idx8, idx4 = _idx(jax.random.PRNGKey(0), len(uv1), 8), _idx(jax.random.PRNGKey(1), len(uv1), 4)
    x1, x2 = np.asarray(x_j), np.asarray(je._normalize_points(jnp.asarray(uv2), jnp.asarray(valid))[0])
    F_j = np.asarray(je._eight_point(jnp.asarray(x1[idx8]), jnp.asarray(x2[idx8])))
    F_t = te._eight_point(T(x1[idx8]), T(x2[idx8])).numpy()
    H_j = np.asarray(je._four_point_h(jnp.asarray(x1[idx4]), jnp.asarray(x2[idx4])))
    H_t = te._four_point_h(T(x1[idx4]), T(x2[idx4])).numpy()
    assert F_t.shape == (N_HYP, 3, 3) and H_t.shape == (N_HYP, 3, 3)
    # null vectors up to sign. The samples are drawn with replacement: one
    # with a repeated index has a null space of two dimensions, where any
    # unit vector of it is an answer, so only distinct samples are compared
    sgn = lambda a, r: a * np.sign(np.sum(a * r, axis=(1, 2), keepdims=True))
    distinct = lambda idx: np.array([len(set(row)) == len(row) for row in idx])
    close_f = np.abs(sgn(F_t, F_j) - F_j).max(axis=(1, 2)) < 2e-3
    close_h = np.abs(sgn(H_t, H_j) - H_j).max(axis=(1, 2)) < 2e-3
    assert close_f[distinct(idx8)].all() and close_h[distinct(idx4)].all()


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_essential_matches_jax(seed):
    uv1, uv2, _, gt_out = _scene(seed)
    n = len(uv1)
    key = jax.random.PRNGKey(seed)
    E_j, s_j, inl_j = je.estimate_essential(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                            jnp.ones(n, bool), jnp.asarray(K4), n_hyp=N_HYP)
    E_t, s_t, inl_t = te.estimate_essential(None, T(uv1), T(uv2), torch.ones(n, dtype=torch.bool),
                                            T(K4), n_hyp=N_HYP, idx=T(_idx(key, n, 8)))
    E_j = np.asarray(E_j)
    np.testing.assert_allclose(_up_to_sign(E_t.numpy(), E_j), E_j, atol=2e-3)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=5e-3)
    near = _near(_e_chi2(E_j, uv1, uv2), je.CHI2_E)
    assert np.all((inl_t.numpy() == np.asarray(inl_j)) | near)
    assert inl_t.numpy()[gt_out].mean() < 0.1


@pytest.mark.parametrize("seed", [0, 3])
def test_estimate_homography_matches_jax(seed):
    uv1, uv2, _, gt_out = _scene(seed, planar=True)
    n = len(uv1)
    key = jax.random.PRNGKey(seed)
    H_j, s_j, inl_j = je.estimate_homography(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                             jnp.ones(n, bool), n_hyp=N_HYP)
    H_t, s_t, inl_t = te.estimate_homography(None, T(uv1), T(uv2), torch.ones(n, dtype=torch.bool),
                                             n_hyp=N_HYP, idx=T(_idx(key, n, 4)))
    H_j = np.asarray(H_j)
    assert abs(float(H_t[2, 2]) - 1.0) < 1e-6
    np.testing.assert_allclose(H_t.numpy(), H_j, atol=1e-3 * np.abs(H_j).max())
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=5e-3)
    near = _near(_h_chi2(H_j, uv1, uv2), je.CHI2_H)
    assert np.all((inl_t.numpy() == np.asarray(inl_j)) | near)
    assert inl_t.numpy()[~gt_out].mean() > 0.9 and inl_t.numpy()[gt_out].mean() < 0.1


def test_decompose_essential_matches_jax():
    uv1, uv2, rt_gt, _ = _scene(0)
    n = len(uv1)
    E, _, inl = je.estimate_essential(jax.random.PRNGKey(0), jnp.asarray(uv1), jnp.asarray(uv2),
                                      jnp.ones(n, bool), jnp.asarray(K4), n_hyp=N_HYP)
    rt_j, n_j, X_j, good_j = je.decompose_essential(E, jnp.asarray(uv1), jnp.asarray(uv2), inl,
                                                    jnp.asarray(K4))
    rt_t, n_t, X_t, good_t = te.decompose_essential(T(np.asarray(E)), T(uv1), T(uv2),
                                                    T(np.asarray(inl)), T(K4))
    np.testing.assert_allclose(rt_t.numpy(), np.asarray(rt_j), atol=1e-3)
    np.testing.assert_array_equal(good_t.numpy(), np.asarray(good_j))
    assert int(n_t) == int(n_j) > 150
    g = good_t.numpy()
    np.testing.assert_allclose(X_t.numpy()[g], np.asarray(X_j)[g], rtol=2e-3, atol=2e-3)
    # the sign of E is absorbed by the four-way vote
    rt_neg, n_neg, _, _ = te.decompose_essential(-T(np.asarray(E)), T(uv1), T(uv2),
                                                 T(np.asarray(inl)), T(K4))
    np.testing.assert_allclose(rt_neg.numpy(), rt_t.numpy(), atol=1e-5)
    assert int(n_neg) == int(n_t)


def test_decompose_homography_matches_jax():
    uv1, uv2, _, _ = _scene(3, planar=True)
    n = len(uv1)
    H, _, inl = je.estimate_homography(jax.random.PRNGKey(3), jnp.asarray(uv1), jnp.asarray(uv2),
                                       jnp.ones(n, bool), n_hyp=N_HYP)
    rt_j, n_j, _, good_j = je.decompose_homography(H, jnp.asarray(uv1), jnp.asarray(uv2), inl,
                                                   jnp.asarray(K4))
    rt_t, n_t, _, good_t = te.decompose_homography(T(np.asarray(H)), T(uv1), T(uv2),
                                                   T(np.asarray(inl)), T(K4))
    np.testing.assert_allclose(rt_t.numpy(), np.asarray(rt_j), atol=1e-3)
    np.testing.assert_array_equal(good_t.numpy(), np.asarray(good_j))
    assert int(n_t) == int(n_j) > 100


RECOVER_CASES = {
    # name: (scene kwargs, seed, used_homography, ok)
    "general": (dict(outlier_frac=0.05), 1, False, True),
    "planar": (dict(planar=True, outlier_frac=0.05), 2, True, True),
    "few_points_e_path_fails": (dict(n=60, outlier_frac=0.0), 4, False, False),
    "ample_support": (dict(n=300, outlier_frac=0.05), 5, False, True),
    "planar_few_points": (dict(n=80, planar=True, outlier_frac=0.0), 6, True, True),
}


@pytest.mark.parametrize("case", list(RECOVER_CASES))
def test_recover_pose_two_view_matches_jax(case):
    kw, seed, used_h, ok = RECOVER_CASES[case]
    uv1, uv2, _, _ = _scene(seed, **kw)
    n = len(uv1)
    key = jax.random.PRNGKey(seed)
    ref = je.recover_pose_two_view(key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(n, bool),
                                   jnp.asarray(K4), n_hyp=N_HYP)
    k1, k2 = jax.random.split(key)
    got = te.recover_pose_two_view(None, T(uv1), T(uv2), torch.ones(n, dtype=torch.bool), T(K4),
                                   n_hyp=N_HYP, idx_e=T(_idx(k1, n, 8)), idx_h=T(_idx(k2, n, 4)))
    assert bool(got.used_homography) == bool(ref.used_homography) == used_h
    assert bool(got.ok) == bool(ref.ok) == ok
    np.testing.assert_allclose(float(got.score_ratio), float(ref.score_ratio), atol=1e-2)
    assert got.n_inliers.dtype == torch.int32
    if not ok:
        # a rejected estimate is not used; with 60 points the refit's null
        # vector is open to 1e-2, so only the verdict is compared
        assert int(got.n_inliers) <= 100 and int(ref.n_inliers) <= 100
        return
    E_j, H_j = np.asarray(ref.E), np.asarray(ref.H)
    # the model that was not chosen is degenerate on its scene (a plane
    # admits a family of E, a general scene only a partial H): compare the
    # chosen one
    if used_h:
        np.testing.assert_allclose(got.H.numpy(), H_j, atol=1e-3 * np.abs(H_j).max())
    else:
        np.testing.assert_allclose(_up_to_sign(got.E.numpy(), E_j), E_j, atol=2e-3)
    np.testing.assert_allclose(got.rt6.numpy(), np.asarray(ref.rt6), atol=1e-3)
    chi2s, thr = ((_h_chi2(H_j, uv1, uv2), je.CHI2_H) if used_h
                  else (_e_chi2(E_j, uv1, uv2), je.CHI2_E))
    near = _near(chi2s, thr)
    assert np.all((got.inliers.numpy() == np.asarray(ref.inliers)) | near)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= int(near.sum())

    # the reference's result crosses over as the port's dataclass
    carried = interop.from_reference(ref, device="cpu")
    assert isinstance(carried, te.TwoViewResult)
    np.testing.assert_array_equal(carried.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(carried.rt6.numpy(), np.asarray(ref.rt6))


def test_results_do_not_depend_on_padding():
    """The reference pads the pairs to a power of two with a mask; the port
    takes the real pairs. Padding the port's inputs the same way changes
    nothing but float32 summation order."""
    uv1, uv2, _, _ = _scene(1, outlier_frac=0.05)
    n = len(uv1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    idx_e, idx_h = T(_idx(k1, n, 8)), T(_idx(k2, n, 4))
    plain = te.recover_pose_two_view(None, T(uv1), T(uv2), torch.ones(n, dtype=torch.bool),
                                     T(K4), n_hyp=N_HYP, idx_e=idx_e, idx_h=idx_h)
    pad = np.zeros((256 - n, 2), np.float32)
    valid = torch.arange(256) < n
    padded = te.recover_pose_two_view(None, T(np.concatenate([uv1, pad])),
                                      T(np.concatenate([uv2, pad])), valid, T(K4),
                                      n_hyp=N_HYP, idx_e=idx_e, idx_h=idx_h)
    np.testing.assert_allclose(padded.rt6.numpy(), plain.rt6.numpy(), atol=1e-4)
    np.testing.assert_array_equal(padded.inliers.numpy()[:n], plain.inliers.numpy())
    assert not padded.inliers.numpy()[n:].any()


def test_sample_indices_draws_only_valid_pairs_and_is_seeded():
    valid = torch.zeros(100, dtype=torch.bool)
    valid[10:40] = True
    gen = torch.Generator().manual_seed(7)
    idx = te.sample_indices(gen, valid, 64, 8)
    assert idx.shape == (64, 8) and idx.dtype == torch.int64
    assert bool(valid[idx].all())
    again = te.sample_indices(torch.Generator().manual_seed(7), valid, 64, 8)
    assert torch.equal(idx, again)
    assert len(torch.unique(idx)) > 20  # spread over the 30 valid pairs
    none = te.sample_indices(gen, torch.zeros(5, dtype=torch.bool), 4, 8)
    assert none.shape == (4, 8) and not none.any()
