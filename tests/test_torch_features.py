"""Port parity: `ops/features.py:detect_and_describe` against the JAX
frontend at 160x120, 3 levels, 200 features, exact top-k, on rendered plane
frames. Bounds: the BRIEF pattern equal; >= 99% of keypoints identical
(octave, validity, and position to 1e-3 px: the sub-pixel quadratic fit
divides float32 response differences, which round differently in XLA's
fused expressions); descriptors of identical keypoints
bit-identical; orientation angles to 1e-4 rad (libm round-off). The pyramid
resize weights agree with `jax.image.resize` to 1e-7 (float32 column sums
in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import render_plane_sequence
from bundleadjustment_tpu.ops import features as jf
from bundleadjustment_tpu_torch.ops import features as tf


@pytest.fixture(scope="module")
def frames():
    fr, _ = render_plane_sequence(n_frames=3, width=160, height=120, fx=150.0,
                                  fy=150.0, motion_step=0.06)
    return [f["gray"].astype(np.float32) for f in fr]


def test_brief_pattern_equal():
    np.testing.assert_array_equal(tf.brief_pattern(), jf._BRIEF)
    assert tf.level_allocations(tf.FeatureConfig()) == jf._level_allocations(jf.FeatureConfig())


@pytest.mark.parametrize("dst,src", [(100, 120), (83, 133), (400, 480), (270, 640)])
def test_resize_weights(dst, src):
    np.testing.assert_allclose(tf.resize_matrix(dst, src), jf._resize_mat(dst, src),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("i", [0, 2])
def test_detect_and_describe_matches_jax(frames, i):
    img = frames[i]
    ref = jf.detect_and_describe(jnp.asarray(img),
                                 jf.FeatureConfig(n_features=200, n_levels=3, topk="exact"))
    got = tf.detect_and_describe(torch.from_numpy(img),
                                 tf.FeatureConfig(n_features=200, n_levels=3))
    xy_j = np.asarray(ref.xy)
    same = (np.all(np.abs(got.xy.numpy() - xy_j) < 1e-3, axis=1)
            & (got.octave.numpy() == np.asarray(ref.octave))
            & (got.valid.numpy() == np.asarray(ref.valid)))
    assert same.mean() >= 0.99, same.mean()
    assert got.valid.sum() > 100
    np.testing.assert_array_equal(got.desc.numpy()[same],
                                  np.asarray(ref.desc).view(np.int32)[same])
    np.testing.assert_allclose(got.angle.numpy()[same], np.asarray(ref.angle)[same],
                               atol=1e-4)
    np.testing.assert_array_equal(got.sigma2.numpy(), np.asarray(ref.sigma2))
