"""Port parity: kernel A's plain version (`ops/hamming.py`) against the Pallas
kernel in interpret mode, and the port's matchers against the JAX matchers.
Tolerance: bit-identical (Hamming distances are small integers)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bundleadjustment_tpu.ops import matching as jm
from bundleadjustment_tpu.ops.pallas_matching import hamming_top2_pallas
from bundleadjustment_tpu_torch.ops import hamming as th
from bundleadjustment_tpu_torch.ops import matching as tm
from torch_port_helpers import as_tensor


def _descs(rng, m1, m2, case):
    t = rng.integers(0, 2**32, (m2, 8), dtype=np.uint32)
    q = t[rng.integers(0, m2, m1)].copy()
    q[::2] ^= rng.integers(0, 2**32, q[::2].shape, dtype=np.uint32) & np.uint32(0x00110011)
    valid = np.ones(m2, bool)
    if case == "ties":
        t[1::2] = t[0::2]  # every train row has an identical twin
    elif case == "invalid":
        valid = rng.random(m2) > 0.3
    elif case == "all_invalid":
        valid[:] = False
    return q, t, valid


@pytest.mark.parametrize("case,m1,m2", [
    ("random", 40, 120), ("ties", 64, 200), ("invalid", 50, 300),
    ("all_invalid", 8, 40), ("random", 300, 700),  # M > 256: several tiles
])
def test_top2_matches_pallas(rng, case, m1, m2):
    q, t, valid = _descs(rng, m1, m2, case)
    ref = hamming_top2_pallas(jnp.asarray(q), jnp.asarray(t),
                              jnp.asarray(valid.astype(np.int32)), interpret=True)
    got = th.hamming_top2(as_tensor(q)[None], as_tensor(t)[None],
                          torch.from_numpy(valid)[None])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    if case == "all_invalid":
        assert (got[2] == -1).all() and torch.isinf(got[0]).all()


def test_top2_batch_axis(rng):
    """One query set against B train sets == B separate Pallas calls."""
    q, t, _ = _descs(rng, 70, 260, "random")
    tb = np.stack([t, t[::-1].copy(), np.roll(t, 5, 0)])
    vb = rng.random((3, 260)) > 0.2
    got = th.hamming_top2(as_tensor(q)[None], as_tensor(tb), torch.from_numpy(vb))
    for b in range(3):
        ref = hamming_top2_pallas(jnp.asarray(q), jnp.asarray(tb[b]),
                                  jnp.asarray(vb[b].astype(np.int32)), interpret=True)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))


@pytest.mark.parametrize("ratio,max_dist,cross_check", [
    (0.7, None, True), (0.9, 64.0, True), (0.8, None, False)])
def test_matchers_match_jax(rng, ratio, max_dist, cross_check):
    q, t, valid = _descs(rng, 180, 400, "invalid")
    va = rng.random(180) > 0.1
    kw = dict(ratio=ratio, max_dist=max_dist, cross_check=cross_check)
    ref = jm.match_descriptors(jnp.asarray(q), jnp.asarray(t), jnp.asarray(va),
                               jnp.asarray(valid), metric="hamming", **kw)
    ref_f = jm.match_descriptors_fused(jnp.asarray(q), jnp.asarray(t),
                                       jnp.asarray(va), jnp.asarray(valid),
                                       interpret=True, **kw)
    args = (as_tensor(q), as_tensor(t), torch.from_numpy(va), torch.from_numpy(valid))
    for got in (tm.match_descriptors(*args, metric="hamming", **kw),
                tm.match_descriptors_fused(*args, **kw)):
        for r in (ref, ref_f):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(r[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(r[1]))
    assert (got[0] >= 0).sum() > 20


def test_batch_matcher_matches_jax(rng):
    q, t, _ = _descs(rng, 90, 150, "random")
    tb = np.stack([t, np.roll(t, 3, 0), t[::-1].copy()])
    vb = rng.random((3, 150)) > 0.15
    vb[2] = False
    va = rng.random(90) > 0.1
    ref = jm.match_descriptors_batch(jnp.asarray(q), jnp.asarray(tb), jnp.asarray(va),
                                     jnp.asarray(vb), metric="hamming", ratio=0.7,
                                     max_dist=64.0)
    got = tm.match_descriptors_batch(as_tensor(q), as_tensor(tb), torch.from_numpy(va),
                                     torch.from_numpy(vb), ratio=0.7, max_dist=64.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros((1, 4, 7), dtype=torch.int32)
    with pytest.raises(ValueError):
        th.hamming_top2(q, torch.zeros((1, 5, 7), dtype=torch.int32),
                        torch.ones((1, 5), dtype=torch.bool))
