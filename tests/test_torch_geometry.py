"""Port parity: se3, projection and gated triangulation against the JAX
package on the same numpy inputs. Tolerance: float32 round-off (atol 1e-5
on unit-scale quantities)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bundleadjustment_tpu.geometry import projection as jproj
from bundleadjustment_tpu.geometry import se3 as jse3
from bundleadjustment_tpu.geometry import triangulation as jtri
from bundleadjustment_tpu_torch.geometry import projection as tproj
from bundleadjustment_tpu_torch.geometry import se3 as tse3
from bundleadjustment_tpu_torch.geometry import triangulation as ttri

T = torch.from_numpy


def _rvecs(rng, n=64):
    r = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    r[0] = 0.0  # identity
    r[1] = [1e-7, 0, 0]  # tiny angle
    r[2] = [np.pi - 1e-4, 0, 0]  # near pi
    r[3] = [0, 0.5 * np.pi, 0]
    return r


def test_aa_rotmat_roundtrip(rng):
    r = _rvecs(rng)
    Rj = np.asarray(jse3.aa_to_rotmat(jnp.asarray(r)))
    Rt = tse3.aa_to_rotmat(T(r)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tse3.rotmat_to_aa(T(Rj)).numpy(),
                               np.asarray(jse3.rotmat_to_aa(jnp.asarray(Rj))),
                               atol=1e-4)


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "mat44"])
def test_rt6_ops(rng, op):
    a = np.concatenate([_rvecs(rng, 16) * 0.5,
                        rng.normal(0, 1, (16, 3)).astype(np.float32)], -1)
    b = np.concatenate([rng.normal(0, 0.3, (16, 3)),
                        rng.normal(0, 1, (16, 3))], -1).astype(np.float32)
    x = rng.normal(0, 2, (16, 3)).astype(np.float32)
    if op == "compose":
        ref, got = jse3.rt6_compose(jnp.asarray(a), jnp.asarray(b)), tse3.rt6_compose(T(a), T(b))
    elif op == "inverse":
        ref, got = jse3.rt6_inverse(jnp.asarray(b)), tse3.rt6_inverse(T(b))
    elif op == "apply":
        ref, got = jse3.rt6_apply(jnp.asarray(b), jnp.asarray(x)), tse3.rt6_apply(T(b), T(x))
    else:
        ref, got = jse3.rt6_to_mat44(jnp.asarray(b)), tse3.rt6_to_mat44(T(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_projection(rng):
    K4 = np.array([525.0, 520.0, 319.5, 239.5], np.float32)
    x = rng.uniform([-2, -2, -1], [2, 2, 6], (200, 3)).astype(np.float32)
    x[:3, 2] = [0.0, 1e-12, -1e-12]  # guarded divide
    uv_j, z_j = jproj.project(jnp.asarray(K4), jnp.asarray(x))
    uv_t, z_t = tproj.project(T(K4), T(x))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    d = rng.uniform(0.5, 5, 200).astype(np.float32)
    uv = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tproj.backproject(T(K4), T(uv), T(d)).numpy(),
        np.asarray(jproj.backproject(jnp.asarray(K4), jnp.asarray(uv), jnp.asarray(d))),
        rtol=1e-6)
    rt = np.array([0.1, -0.05, 0.02, 0.1, 0.2, 0.3], np.float32)
    uv_j, _ = jproj.project_rt(jnp.asarray(K4), jnp.asarray(rt), jnp.asarray(x[3:]))
    uv_t, _ = tproj.project_rt(T(K4), T(rt), T(x[3:]))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-5, atol=1e-3)


def _two_view(rng, n=256, batch=None):
    K4 = np.array([300.0, 300.0, 160.0, 120.0], np.float32)
    X = rng.uniform([-1, -1, 3], [1, 1, 6], (n, 3))
    e1 = np.zeros(6, np.float32)
    e2 = np.array([0.0, 0.05, 0.0, -0.3, 0.0, 0.0], np.float32)

    def proj(e, X):
        from bundleadjustment_tpu.geometry.np_se3 import aa_to_R

        xc = X @ aa_to_R(e[:3]).T + e[3:]
        return np.stack([K4[0] * xc[:, 0] / xc[:, 2] + K4[2],
                         K4[1] * xc[:, 1] / xc[:, 2] + K4[3]], -1)

    uv1 = (proj(e1, X) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2 = (proj(e2, X) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv2[:20] += 30.0  # gross outliers fail the chi2 gate
    s1 = np.ones(n, np.float32)
    s2 = np.full(n, 1.44, np.float32)
    valid = np.ones(n, bool)
    valid[-10:] = False
    return K4, e1, e2, uv1, uv2, s1, s2, valid


def test_triangulate_gated(rng):
    args = _two_view(rng)
    Xj, okj = jtri.triangulate_gated(*[jnp.asarray(a) for a in args])
    Xt, okt = ttri.triangulate_gated(*[T(a) for a in args])
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.sum() > 150 and not okt[:20].any()
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4, atol=1e-4)


def test_triangulate_gated_batched(rng):
    """A leading neighbour axis on the second view (the keyframe neighbour
    triangulation), as the JAX driver's vmap."""
    import jax

    K4, e1, e2, uv1, uv2, s1, s2, valid = _two_view(rng, n=128)
    e2b = np.stack([e2, e2 * 0.5, e2 * 2.0])
    stack = lambda a: np.stack([a, a, a])
    args_b = (K4, e1, e2b, stack(uv1), stack(uv2), stack(s1), stack(s2), stack(valid))
    Xj, okj = jax.vmap(jtri.triangulate_gated, in_axes=(None, None, 0, 0, 0, 0, 0, 0))(
        *[jnp.asarray(a) for a in args_b])
    Xt, okt = ttri.triangulate_gated(*[T(a) for a in args_b])
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4, atol=1e-4)
