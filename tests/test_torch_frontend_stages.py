"""Port parity by stage: the eight frontend stages of the root-level
profile_frontend.py, as `bench/frontend.stage_fns` calls them in the port,
against the JAX package's functions called as that script calls them
(jitted), on the CPU, on two 160x120 frames of `render_layered_scene(seed=7)`
at 200 features and 3 levels. Each stage is compared alone: a stage fed by
another takes the JAX output as its input on both sides (nms_topk the JAX
Harris map, orientation the JAX blur, brief the JAX blur and angles).

Bounds: the Harris map, the blur and the pyramid levels within rtol 1e-5
and atol 1e-6 of the map's largest magnitude (float32 sums of the same
terms; the resize weights differ from `jax.image.resize`'s by <= 1e-7);
the FAST mask and the NMS mask equal; nms_topk's values sorted equal and
its indices equal as sets where the values are distinct; orientation to
1e-4 rad (libm round-off); BRIEF words bit-equal; detect_level0 by the
end-to-end rule of tests/test_torch_features.py (>= 99% of keypoints the
same: validity, and position to 1e-3 px; their descriptors equal, angles
to 1e-4).

Then the runner itself (`bench/frontend.main`) on the CPU at that size:
the JAX script's ten metric names (read from its source), positive finite
values, no device figures off the card; a device that is missing or
unsupported raises, with no fallback to the CPU."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import render_layered_scene
from bundleadjustment_tpu.ops import features as jf
from bundleadjustment_tpu_torch.bench import frontend as tfront
from bundleadjustment_tpu_torch.ops import features as tf
from torch_port_helpers import REPO, jax_frontend_metrics, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

H, W = 120, 160
SIZE = dict(n_features=200, n_levels=3)
JCFG, TCFG = jf.FeatureConfig(**SIZE), tf.FeatureConfig(**SIZE)
N0 = jf._level_allocations(JCFG)[0]


def _jax_stages(cfg):
    """profile_frontend.py:82-111's functions at this size."""
    sizes = [(max(int(round(H / cfg.scale_factor**lvl)), 2 * cfg.border + 8),
              max(int(round(W / cfg.scale_factor**lvl)), 2 * cfg.border + 8))
             for lvl in range(1, cfg.n_levels)]
    return {
        "harris": jax.jit(lambda im: jf.harris_response(im, cfg.harris_k)[0]),
        "fast": jax.jit(lambda im: jf.fast_corners(im, cfg.fast_threshold)),
        "nms_topk": jax.jit(lambda im: jax.lax.approx_max_k(
            jnp.where(jf._nms3(im), im, -jnp.inf).reshape(-1), N0)),
        "blur": jax.jit(jf.gaussian_blur),
        "resize_7levels": jax.jit(lambda im: [jf._resize_linear(im, h, w) for h, w in sizes]),
        "detect_level0": jax.jit(lambda im: jf._detect_level(im, N0, cfg)),
        "orientation": jax.jit(jf.orientation_angles),
        "brief": jax.jit(jf.brief_descriptors),
    }


@pytest.fixture(scope="module")
def frames():
    f = 525.0 * W / 640
    fr, _ = render_layered_scene(n_frames=2, width=W, height=H, fx=f, fy=f, seed=7)
    return [x["gray"].astype(np.float32) for x in fr]


def _t(a):
    """numpy / JAX array -> tensor with a frame axis (uint32 words keep
    their bits as int32)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)[None]


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("stage", tfront.STAGES)
def test_stage_matches_jax(frames, stage):
    js, ts = _jax_stages(JCFG), tfront.stage_fns(TCFG, H, W)
    ys, xs = (k[0].numpy() for k in tfront.keypoints(TCFG, H, W, "cpu"))
    np.testing.assert_array_equal(ys, np.random.default_rng(0).integers(16, H - 16, N0))
    np.testing.assert_array_equal(xs, np.random.default_rng(1).integers(16, W - 16, N0))
    for img in frames:
        if stage in ("harris", "blur"):
            _close(ts[stage](_t(img))[0].numpy(), js[stage](img))
        elif stage == "resize_7levels":
            for got, ref in zip(ts[stage](_t(img)), js[stage](img), strict=True):
                _close(got[0].numpy(), ref)
        elif stage == "fast":
            got = ts[stage](_t(img))[0].numpy()
            np.testing.assert_array_equal(got, np.asarray(js[stage](img)))
            assert got.sum() > N0
        elif stage == "nms_topk":
            hm = np.asarray(js["harris"](img))
            np.testing.assert_array_equal(tf._nms3(_t(hm))[0].numpy(),
                                          np.asarray(jf._nms3(hm)))
            vals, idx = (x[0].numpy() for x in ts[stage](_t(hm)))
            jv, ji = map(np.asarray, js[stage](hm))
            np.testing.assert_array_equal(np.sort(vals), np.sort(jv))
            u, n = np.unique(jv, return_counts=True)
            distinct = u[n == 1]
            assert len(distinct) > N0 // 2
            assert (set(idx[np.isin(vals, distinct)].tolist())
                    == set(ji[np.isin(jv, distinct)].tolist()))
        elif stage == "detect_level0":
            ys_f, xs_f, _, ang, desc, valid = (x[0].numpy() for x in ts[stage](_t(img)))
            jy, jx, _, ja, jd, jvalid = js[stage](img)
            same = ((np.abs(xs_f - np.asarray(jx)) < 1e-3)
                    & (np.abs(ys_f - np.asarray(jy)) < 1e-3) & (valid == np.asarray(jvalid)))
            assert same.mean() >= 0.99, same.mean()
            assert valid.sum() > N0 // 2
            np.testing.assert_array_equal(desc[same], np.asarray(jd).view(np.int32)[same])
            np.testing.assert_allclose(ang[same], np.asarray(ja)[same], atol=1e-4)
        elif stage == "orientation":
            blur = np.asarray(js["blur"](img))
            np.testing.assert_allclose(ts[stage](_t(blur), _t(ys), _t(xs))[0].numpy(),
                                       np.asarray(js[stage](blur, ys, xs)), rtol=0, atol=1e-4)
        else:  # brief
            blur = np.asarray(js["blur"](img))
            ang = np.asarray(js["orientation"](blur, ys, xs))
            got = ts[stage](_t(blur), _t(ys), _t(xs), _t(ang))[0].numpy()
            np.testing.assert_array_equal(got, np.asarray(js[stage](blur, ys, xs, ang))
                                          .view(np.int32))


def test_runner_prints_the_jax_metrics_on_the_cpu(capsys):
    tfront.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                 "--n-features", "200", "--n-levels", "3", "--frames", "2"])
    *lines, last = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert last == {"nvidia_smi": None}
    names = [ln["metric"] for ln in lines]
    assert len(names) == len(set(names)) and set(names) == jax_frontend_metrics(), names
    for ln in lines:
        assert np.isfinite(ln["value"]) and ln["value"] > 0, ln
        assert ln["device_ms"] is None and ln["launches"] is None, ln
        assert ln["device"] == "cpu" and ln["geometry"] == f"{W}x{H}x3L"


def test_runner_raises_for_a_missing_or_unsupported_device():
    runs = {"mps": "unsupported device"}
    if not torch.cuda.is_available():
        runs["cuda"] = "torch.cuda.is_available() is False"
    for device, message in runs.items():
        proc = subprocess.run([sys.executable, "-m", "bundleadjustment_tpu_torch.bench.frontend",
                               "--device", device], cwd=REPO, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0 and message in proc.stderr, proc.stderr[-500:]
        assert "metric" not in proc.stdout
