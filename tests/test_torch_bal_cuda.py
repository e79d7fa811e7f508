"""Card-only tests of BAL's camera (camera width 9): kernels B and C against
their plain versions (which the CPU tests hold to the float64 reference,
`tests/test_torch_bal.py`) on the same CUDA tensors, and whole solves on the
card, eager and graphed, against the float64 reference. They skip without
a card; this file imports no jax:
`python -m pytest --noconftest tests/test_torch_bal_cuda.py -q`.

Tolerances, as `tests/test_torch_cuda.py` holds the 6-wide kernels: cost
rtol 1e-5; red, Vu, g_p, W, S and b rtol 2e-4 / atol 2e-3 relative to the
largest entry of each block (red's U columns and g_c columns apart, each row
of Vu, g_p and W, S and b whole); zv, vinv6 and Xt_new elementwise rtol
1e-4 / atol 1e-4 of their largest; B's two calls bit for bit. A solve: the
float64 cost of its answer within 1e-5 of the reference's
(`test_torch_bal.COST_EXCESS`).
"""

import numpy as np
import pytest
import torch

import bal_reference as ref
from bundleadjustment_tpu_torch import kernels
from bundleadjustment_tpu_torch.data.bal import BALData, dense_problem
from bundleadjustment_tpu_torch.solvers import dense_ba
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from bundleadjustment_tpu_torch.solvers import lm
from torch_port_helpers import bal_scene, cuda_device  # noqa: F401

make_bal_scene = bal_scene().make_bal_scene

pytestmark = pytest.mark.cuda

COST = {"huber_delta": 2.4477, "cheirality_penalty": 1.0e4}


def _start(gt, seed):
    rng = np.random.default_rng(seed)
    K = len(gt.cameras)
    c0 = gt.cameras.copy()
    c0[1:, :3] += rng.normal(0, 0.02, (K - 1, 3))
    c0[1:, 3:6] += rng.normal(0, 0.05, (K - 1, 3))
    c0[1:, 6] *= 1 + rng.normal(0, 0.02, K - 1)
    c0[1:, 7:] = 0.0
    return c0, gt.points + rng.normal(0, 0.05, gt.points.shape)


def _bal(K, L, seed, device, max_track=None):
    obs, gt = make_bal_scene(K, L, int(L * 5.54), max_track=max_track or min(K, 64),
                             seed=seed)
    c0, p0 = _start(gt, seed)
    data = BALData(c0, p0, obs.cam_idx, obs.pt_idx, obs.uv)
    prob, cams, pts, dropped = dense_problem(data, device=device)
    assert dropped == 0
    return data, prob, cams, pts


def _close(got, want, rtol=2e-4, atol=2e-3, scale=None):
    got, want = got.double().cpu(), want.double().cpu()
    if scale is None:
        scale = want.abs().max().clamp(min=1e-30)
    err = (got - want).abs()
    assert bool((err <= atol * scale + rtol * want.abs()).all()), float((err / scale).max())


def _blocks_close(name, got, want):
    a = want.double().abs().cpu()
    if name == "red":  # [K, 54]: U columns, then g_c
        s = torch.cat([a[:, :45].max().expand(45), a[:, 45:].max().expand(9)])[None]
    elif name == "W":  # [9, 3, O, L]: one a row
        s = a.reshape(27, -1).amax(1).reshape(9, 3, 1, 1)
    elif name in ("Vu", "g_p"):
        s = a.amax(1, keepdim=True)
    else:
        s = a.max()
    _close(got, want, scale=torch.where(s > 0, s, torch.ones_like(s)))


CASES = {"K40": (40, 3000, 1), "K356": (356, 4000, 2), "K12_L0": (12, 0, 3)}


def _state(case, device):
    K, L, seed = CASES[case]
    if L == 0:
        data, prob, cams, pts = _bal(K, 400, seed, device)
        prob = dense_ba.DenseBAProblem(prob.K4, prob.cam_idx[:0], prob.uv[:0], prob.sigma2[:0],
                                       prob.valid[:0], prob.cam_fixed, prob.pt_valid[:0],
                                       camera_model="bal")
        pts = pts[:0]
    else:
        data, prob, cams, pts = _bal(K, L, seed, device)
    cm = dense_ba._to_cm(prob)
    st = dense_ba._lm_start(dk.PLAIN_OPS, cm, cams, pts, lm.LMConfig(), dense_ba._same)
    return cm, st._replace(lam=torch.tensor(1e-3, device=device))


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_b_width_9_matches_plain_on_card(cuda_device, case):
    """Kernel B at width 9, seed and back-substitution: 40 cameras (one
    tile), 356 (three tiles of 119, the back-substitution pass of its own),
    and no landmarks; two calls bit for bit."""
    cm, st = _state(case, cuda_device)
    O, L = cm.cam_t.shape
    K = cm.cam_fixed.shape[0]
    args = (*dense_ba._eval_args(cm), st.R, st.t)
    dc = torch.randn((K, 9), generator=torch.Generator(cuda_device).manual_seed(5),
                     device=cuda_device) * torch.tensor([1e-3] * 6 + [1.0, 1e-3, 1e-3],
                                                        device=cuda_device)
    dc = torch.where(cm.cam_fixed[:, None], torch.zeros_like(dc), dc)
    _S, _zv, vinv6, _b = dk.schur_prepare_s_plain(st.lam, st.Vu, st.g_p, cm.pt_valid,
                                                  st.W.reshape(27, O, L), cm.cam_t, K,
                                                  st.red, cm.cam_fixed)
    bs = (dc, st.Xt, st.W.reshape(27, O, L), vinv6, st.g_p, cm.pt_valid)
    kernels.reset_launch_counts()
    got = dk.eval_assemble(*args, st.Xt, intr=st.kk)
    got_bs = dk.eval_assemble_bs(*args, *bs, intr=st.kk)
    assert kernels.launch_counts()["dense_eval_assemble"] == 1
    assert kernels.launch_counts()["dense_eval_assemble_bs"] == 1
    assert got[1].shape == (K, 54) and got[4].shape == (9, 3, O, L)
    if L == 0:
        assert float(got[0]) == 0.0 and not got[1].any() and not got_bs[1].any()
        return
    want = dk.eval_assemble_plain(*args, st.Xt, intr=st.kk)
    want_bs = dk.eval_assemble_bs_plain(*args, *bs, intr=st.kk)
    for g_all, w_all in ((got, want), (got_bs, want_bs)):
        _close(g_all[0], w_all[0], rtol=1e-5, atol=0)
        for g, w, name in zip(g_all[1:5], w_all[1:5], ("red", "Vu", "g_p", "W")):
            _blocks_close(name, g, w)
    _close(got_bs[5], want_bs[5], rtol=1e-4, atol=1e-4)
    for fn, a in ((dk.eval_assemble, (*args, st.Xt)), (dk.eval_assemble_bs, (*args, *bs))):
        x, y = fn(*a, intr=st.kk), fn(*a, intr=st.kk)
        assert all(torch.equal(p, q) for p, q in zip(x, y))


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_c_width_9_matches_plain_on_card(cuda_device, case):
    """Kernel C and K5 at width 9: 40 cameras (two tiles of 20), 356
    (18 tiles a side) and no landmarks."""
    cm, st = _state(case, cuda_device)
    O, L = cm.cam_t.shape
    K = cm.cam_fixed.shape[0]
    args = (st.lam, st.Vu, st.g_p, cm.pt_valid, st.W.reshape(27, O, L), cm.cam_t, K)
    want = dk.schur_prepare_s_plain(*args, st.red, cm.cam_fixed)
    part_w = dk.schur_qqt_partial_plain(*args)
    # the slots that hold an observation read from valid_t (the solve's
    # call at width 9), or found by W's zeros
    for valid in ({"valid_t": cm.valid_t}, {}):
        kernels.reset_launch_counts()
        got = dk.schur_prepare_s(*args, st.red, cm.cam_fixed, **valid)
        assert kernels.launch_counts()["schur_prepare_s"] == 1
        assert got[0].shape == (9 * K, 9 * K) and got[3].shape == (9 * K,)
        _blocks_close("S", got[0], want[0])
        _blocks_close("b", got[3], want[3])
        if L:
            for g, w in zip(got[1:3], want[1:3]):  # zv, vinv6
                _close(g, w, rtol=1e-4, atol=1e-4)
        part = dk.schur_qqt_partial(*args, **valid)
        _blocks_close("S", part[0], part_w[0])
        _blocks_close("red6", part[3], part_w[3])


def test_bal_solve_on_card_eager_and_graphed(cuda_device):
    """A 40-camera BAL solve on the card: the first call eager, the second
    captured and replayed, the third replayed; each within the cost check
    of the float64 reference, the graphed ones with `ba.graph` in their
    record."""
    data, prob, cams, pts = _bal(40, 3000, 11, cuda_device)
    cfg = lm.LMConfig(max_iters=40)
    outs, graphed = [], []
    for _ in range(3):
        outs.append(dense_ba.dense_ba_solve(prob, cams, pts, cfg))
        graphed.append("ba.graph" in dense_ba.TIMER.records()[-1]["phases"])
    torch.cuda.synchronize()
    assert graphed == [False, True, True]
    assert dense_ba.TIMER.records()[-1]["counters"]["camera_width"] == 9
    p64 = ref.Problem(data.cam_idx, data.pt_idx, data.uv, np.ones(len(data.cam_idx)),
                      np.arange(40) == 0, 3000, cuda_device, ref.Arith("float64"), **COST)
    c_r, X_r, _ = ref.solve(p64, data.cameras, data.points)
    c_ref = float(p64.cost(c_r, X_r))
    for c, X, _info in outs:
        assert float(p64.cost(c.double(), X.double())) / c_ref - 1.0 <= 1e-5


def test_bal_solve_on_card_with_kernel_e(cuda_device):
    """The camera system at N = 9K by kernel E (`KERNEL_OPS_CHOL`), which
    takes any N: the same cost check."""
    data, prob, cams, pts = _bal(40, 3000, 12, cuda_device)
    c, X, _ = dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=40),
                                      ops=dk.KERNEL_OPS_CHOL)
    p64 = ref.Problem(data.cam_idx, data.pt_idx, data.uv, np.ones(len(data.cam_idx)),
                      np.arange(40) == 0, 3000, cuda_device, ref.Arith("float64"), **COST)
    c_r, X_r, _ = ref.solve(p64, data.cameras, data.points)
    assert float(p64.cost(c.double(), X.double())) / float(p64.cost(c_r, X_r)) - 1.0 <= 1e-5
