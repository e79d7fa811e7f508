"""Port parity: plain versions of kernels B and C (`solvers/dense_kernels.py`)
against the Pallas kernels in interpret mode, on the scene of
tests/test_pallas_dense_eval.py.

Tolerances (the JAX package's own Pallas-vs-XLA parity bounds, rtol 2e-4 /
atol 2e-3): cost rtol 1e-5; Xt_new, zv and vinv6 elementwise; red, Vu, g_p,
W, S and b after dividing each block by its own max magnitude (see
`_check_eval` and `torch_port_helpers.block_scale`). The kernels themselves
are checked against these plain versions on the card in
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat
from bundleadjustment_tpu.solvers import dense_ba as jd
from bundleadjustment_tpu.solvers import pallas_dense_eval as jp
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from torch_port_helpers import as_tensor, assert_blocks_close, assert_close


def _setup(n_cams=6, n_pts=150, seed=5, max_obs=8):
    sc = make_synthetic_scene(n_cams=n_cams, n_pts=n_pts, pixel_noise=0.4, seed=seed)
    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[0] = True
    dense, _ = jd.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                  sc.valid, cam_fixed, n_pts, max_obs=max_obs)
    cm = jd._to_cm(dense)
    R = aa_to_rotmat(jnp.asarray(sc.extr_init[:, :3]))
    t = jnp.asarray(sc.extr_init[:, 3:])
    Xt = jnp.asarray(sc.points_init.T)
    return sc, dense, cm, R, t, Xt


def _cm_args(cm):
    return (cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t)


def _check_eval(got, ref):
    """cost elementwise; red, Vu, g_p and W relative to the magnitude of each
    block (U and g_c columns of red, each row of Vu, g_p and W; see
    `block_scale`): they are sums whose terms cancel (per-camera sums of
    thousands of terms, reduced by a one-hot matmul in Pallas and by
    index_add_ here; at the trial point the residuals are differences of
    ~300 px projections, so an ulp of the back-substituted landmark moves
    them by ~1e-4 relative), which leaves near-zero entries with the
    round-off of the block's magnitude. Xt_new elementwise."""
    assert_close(got[0], ref[0], rtol=1e-5, atol=0)
    for g, r, n in zip(got[1:5], ref[1:5], ("red", "Vu", "g_p", "W")):
        assert_blocks_close(n, g, r)
    for g, r in zip(got[5:], ref[5:]):
        assert_close(g, r)


@pytest.mark.parametrize("robust", [True, False])
def test_eval_assemble_matches_pallas(robust):
    _, _, cm, R, t, Xt = _setup()
    ref = jp.fused_eval_assemble(*_cm_args(cm), R, t, Xt, robust=robust, interpret=True)
    tcm = interop.from_reference(cm, device="cpu")
    got = dk.eval_assemble(*_cm_args(tcm), as_tensor(R), as_tensor(t), as_tensor(Xt),
                           robust=robust)
    _check_eval(got, ref)


def _lm_inputs(cm, R, t, Xt, robust):
    """Seed blocks, a damped Schur solve step dc, through the JAX kernels."""
    cost, red, Vu, gp, W = jp.fused_eval_assemble(*_cm_args(cm), R, t, Xt,
                                                  robust=robust, interpret=True)
    O, L = cm.cam_t.shape
    K = R.shape[0]
    lam = jnp.float32(1e-3)
    S, zv, vinv6, b = jp.fused_schur_prepare_s(
        lam, Vu, gp, cm.pt_valid, W.reshape(18, O, L), cm.cam_t, K, red27=red,
        cam_fixed=cm.cam_fixed, s_bf16=False, interpret=True)
    dc = np.linalg.solve(np.asarray(S, np.float64), np.asarray(b, np.float64))
    dc = dc.reshape(6, K).T.astype(np.float32)
    dc[np.asarray(cm.cam_fixed)] = 0.0
    return dict(lam=lam, red=red, Vu=Vu, gp=gp, W18=W.reshape(18, O, L), S=S, zv=zv,
                vinv6=vinv6, b=b, dc=jnp.asarray(dc))


@pytest.mark.parametrize("robust", [True, False])
def test_schur_prepare_s_matches_pallas(robust):
    _, _, cm, R, t, Xt = _setup()
    x = _lm_inputs(cm, R, t, Xt, robust)
    tcm = interop.from_reference(cm, device="cpu")
    S, zv, vinv6, b = dk.schur_prepare_s(
        torch.tensor(1e-3), as_tensor(x["Vu"]), as_tensor(x["gp"]), tcm.pt_valid,
        as_tensor(x["W18"]), tcm.cam_t, R.shape[0], as_tensor(x["red"]),
        tcm.cam_fixed)
    assert_blocks_close("S", S, x["S"])
    assert_blocks_close("b", b, x["b"])
    assert_close(zv, x["zv"])
    assert_close(vinv6, x["vinv6"])


@pytest.mark.parametrize("fault", ["g_c_zeroed", "b_zeroed", "W_row_zeroed"])
def test_block_check_catches_a_planted_fault(fault):
    """The block-scaled check fails when a kernel writes zeros into one
    small block (the g_c columns of red, the rhs b, one of W's 18 rows) while
    the large blocks stay right."""
    _, _, cm, R, t, Xt = _setup()
    x = _lm_inputs(cm, R, t, Xt, robust=True)
    name, ref = {"g_c_zeroed": ("red", x["red"]), "b_zeroed": ("b", x["b"]),
                 "W_row_zeroed": ("W", x["W18"].reshape(6, 3, *cm.cam_t.shape))}[fault]
    bad = np.array(ref, np.float32)
    if fault == "g_c_zeroed":
        bad[:, 21:] = 0.0
    elif fault == "b_zeroed":
        bad[:] = 0.0
    else:
        bad[5, 2] = 0.0
    assert_blocks_close(name, np.array(ref), ref)
    with pytest.raises(AssertionError):
        assert_blocks_close(name, bad, ref)


@pytest.mark.parametrize("robust", [True, False])
def test_eval_assemble_bs_matches_pallas(robust):
    _, _, cm, R, t, Xt = _setup()
    x = _lm_inputs(cm, R, t, Xt, robust)
    dc = x["dc"]
    R_new = aa_to_rotmat(dc[:, :3]) @ R
    t_new = t + dc[:, 3:]
    ref = jp.fused_eval_assemble_bs(*_cm_args(cm), R_new, t_new, dc, Xt, x["W18"],
                                    x["vinv6"], x["gp"], cm.pt_valid, robust=robust,
                                    interpret=True)
    tcm = interop.from_reference(cm, device="cpu")
    got = dk.eval_assemble_bs(*_cm_args(tcm), as_tensor(R_new), as_tensor(t_new),
                              as_tensor(dc), as_tensor(Xt), as_tensor(x["W18"]),
                              as_tensor(x["vinv6"]), as_tensor(x["gp"]),
                              tcm.pt_valid, robust=robust)
    _check_eval(got, ref)


@pytest.mark.parametrize("max_obs", [4, 16])
def test_densify_matches_jax(max_obs):
    sc, _, _, _, _, _ = _setup()
    cf = np.zeros(6, bool)
    cf[:2] = True
    ref, dropped = jd.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                      sc.valid, cf, 150, max_obs=max_obs)
    got, dropped_t = td.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                                        sc.sigma2, sc.valid, cf, 150, max_obs=max_obs,
                                        device="cpu")
    assert dropped == dropped_t
    for f in ("K4", "cam_idx", "uv", "sigma2", "valid", "cam_fixed", "pt_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
