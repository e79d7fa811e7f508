"""Port parity of the FLOP / byte model (`utils/flops.py`): every count
equals the JAX package's exactly, at the shapes of the records (8c/1024/8,
64c/10k/16, 128c/100k/8, config-7's 71c/10,842/72) for both solvers with
0 and 60 PCG iterations, the frontend at 640x480 and 1200x680, and the
roofline fields with the peak of both sides patched to one value. The
card's peaks: the H100's float32 rate and HBM rate, none for the CPU. The
port's own bound of an LM iteration, counted by hand on a tiny problem, and
the runners' fields, which name the JAX model as such."""

import pytest
import torch

from bundleadjustment_tpu.utils import flops as jf
from bundleadjustment_tpu_torch.utils import flops as tf

SHAPES = [(8, 1024, 8), (64, 10_000, 16), (128, 100_000, 8), (71, 10_842, 72)]


@pytest.mark.parametrize("solver,pcg_iters", [("dense", 0), ("pcg", 0), ("pcg", 60),
                                              ("dense", 60)])
@pytest.mark.parametrize("K,L,O", SHAPES)
def test_dense_ba_iter_counts_equal_jax(K, L, O, solver, pcg_iters):
    assert tf.dense_ba_iter_flops(K, L, O, solver, pcg_iters) == \
        jf.dense_ba_iter_flops(K, L, O, solver, pcg_iters)
    assert tf.dense_ba_iter_bytes(K, L, O) == jf.dense_ba_iter_bytes(K, L, O)
    assert tf.dense_ba_iter_bytes(K, L, O, 8) == jf.dense_ba_iter_bytes(K, L, O, 8)
    assert tf.FLOP_MODEL_VERSION == jf.FLOP_MODEL_VERSION == 2


@pytest.mark.parametrize("H,W,n_features,n_levels", [(480, 640, 1000, 8),
                                                    (680, 1200, 1000, 8),
                                                    (120, 160, 200, 3)])
def test_frontend_counts_equal_jax(H, W, n_features, n_levels):
    assert tf.frontend_flops(H, W, n_features, n_levels) == \
        jf.frontend_flops(H, W, n_features, n_levels)
    assert tf._frontend_level_dims(H, W, n_levels, 1.2) == \
        jf._frontend_level_dims(H, W, n_levels, 1.2)
    assert tf._frontend_level_allocs(n_features, n_levels, 1.2) == \
        jf._frontend_level_allocs(n_features, n_levels, 1.2)


@pytest.mark.parametrize("peak", [None, 67e12])
def test_rooflines_equal_jax(monkeypatch, peak):
    for mod in (jf, tf):
        monkeypatch.setattr(mod, "device_peak_flops", lambda d, p=peak: p)
        monkeypatch.setattr(mod, "device_peak_bw", lambda d, p=peak: p and 3.35e12)
    for K, L, O in SHAPES:
        for solver, it in (("dense", 0), ("pcg", 40)):
            assert tf.roofline(123.4, K, L, O, "dev", solver, it) == \
                jf.roofline(123.4, K, L, O, "dev", solver, it)
    for H, W in ((480, 640), (680, 1200)):
        assert tf.frontend_roofline(2.85, H, W, "dev") == \
            jf.frontend_roofline(2.85, H, W, "dev")
    got = tf.roofline(1000.0, 64, 10_000, 16, "dev")
    assert got["dominant_term"] == "schur_QQt"
    assert (got["mfu"] is None) == (peak is None)


def test_card_peaks():
    name = "NVIDIA H100 80GB HBM3"
    assert tf.device_peak_flops(name) == 67e12
    assert tf.device_peak_bw(name) == 3.35e12
    assert tf.device_peak_flops("NVIDIA H100 PCIe") == 67e12
    for dev in ("cpu", torch.device("cpu"), "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        assert tf.device_peak_flops(dev) is None and tf.device_peak_bw(dev) is None
    roof = tf.roofline(100.0, 64, 10_000, 16, torch.device("cpu"))
    assert roof["mfu"] is None and roof["peak_tflops"] is None
    fr = tf.frontend_roofline(3.0, 480, 640, "cpu")
    assert fr["mfu"] is None and fr["bw_util"] is None and fr["achieved_gbps"] > 0


def _tiny_problem():
    """3 landmarks, 3 cameras (camera 0 fixed), O = 4: landmark 0 seen by
    cameras 0, 1, 2; landmark 1 by 1 and 2 (and a padded slot); landmark 2
    by camera 0 only, and invalid."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import DenseBAProblem

    cam_idx = torch.tensor([[0, 1, 2, 0], [1, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0]], dtype=torch.bool)
    return DenseBAProblem(
        K4=torch.ones(4), cam_idx=cam_idx, uv=torch.zeros(3, 4, 2),
        sigma2=torch.ones(3, 4), valid=valid,
        cam_fixed=torch.tensor([True, False, False]),
        pt_valid=torch.tensor([True, True, False]))


@pytest.mark.parametrize("solver,pcg_iters", [("dense", 0), ("pcg", 40)])
def test_lm_iter_bound_counts_by_hand(monkeypatch, solver, pcg_iters):
    """The port's own bound: bytes and operations of the tiny problem
    counted by hand (6 valid observations, 4 of a free camera, slot counts
    2 / 2 / 0 a landmark so 3 + 3 pairs, 2 valid landmarks, K = 3)."""
    prob = _tiny_problem()
    assert tf.lm_iter_bound(prob, "cpu", solver, pcg_iters) is None
    monkeypatch.setattr(tf, "device_peak_flops", lambda d: 67e12)
    monkeypatch.setattr(tf, "device_peak_bw", lambda d: 3.35e12)
    got = tf.lm_iter_bound(prob, "dev", solver, pcg_iters)
    ops = (320 + 36) * 6 + 60 * 2
    if solver == "dense":
        ops += (90 + 30) * 4 + 216 * 6 + 18 ** 3 / 3 + 2 * 18 ** 2
    else:
        ops += 30 * 4 + pcg_iters * (72 * 4 + 18 * 2 + 144 * 3)
    # K4, cam_idx, uv, sigma2, valid, cam_fixed, pt_valid; poses and points
    # read and written
    n_bytes = 16 + 48 + 96 + 48 + 12 + 3 + 3 + 2 * 4 * (6 * 3 + 3 * 3)
    assert got["ops"] == int(ops) and got["bytes"] == n_bytes
    want = max(ops / 67e12, n_bytes / 3.35e12) * 1e3
    assert got["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert got["bound_by"] == ("bytes" if n_bytes / 3.35e12 >= ops / 67e12
                               else "operations")


@pytest.mark.parametrize("peak", [None, 67e12])
def test_runner_fields_name_the_jax_model(monkeypatch, peak):
    """`solve_roofline` gives the port's bound and share beside the JAX
    model's figures renamed; `frontend_fields` is `frontend_roofline`
    renamed. None where the peak is unknown."""
    monkeypatch.setattr(tf, "device_peak_flops", lambda d, p=peak: p)
    monkeypatch.setattr(tf, "device_peak_bw", lambda d, p=peak: p and 3.35e12)
    prob = _tiny_problem()
    for solver, it in (("dense", 0), ("pcg", 40)):
        got = tf.solve_roofline(2.5, prob, "dev", solver, it, prefix="m_")
        roof = tf.roofline(1e3 / 2.5, 3, 3, 4, "dev", solver, it)
        assert got["m_jax_model_flops_ratio"] == roof["mfu"]
        assert got["m_jax_model_flops_per_iter"] == roof["flops_per_iter"]
        assert got["m_jax_model_tflops"] == roof["achieved_tflops"]
        assert got["m_jax_model_dominant_term"] == roof["dominant_term"]
        assert got["m_jax_model_version"] == 2
        b = tf.lm_iter_bound(prob, "dev", solver, it)
        if peak is None:
            assert b is None and got["m_port_bound_share"] is None
        else:
            assert got["m_port_bound_ms"] == b["bound_ms"]
            assert got["m_port_bound_share"] == b["bound_ms"] / 2.5
    fe = tf.frontend_fields(2.85, 480, 640, "dev", prefix="f_")
    fr = tf.frontend_roofline(2.85, 480, 640, "dev")
    assert fe["f_jax_model_flops_ratio"] == fr["mfu"]
    assert fe["f_jax_model_bw_ratio"] == fr["bw_util"]
    assert fe["f_jax_model_gflops"] == fr["achieved_gflops"]
    assert fe["f_jax_model_flops_per_frame"] == fr["flops_per_frame"]
