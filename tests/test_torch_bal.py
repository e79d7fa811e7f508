"""BAL's camera (axis-angle w, translation t, focal f, radial k1, k2) through
the dense exact solve, on the CPU, held to the plain float64 reference
`tests/bal_reference.py` (Snavely's equations in BAL's axes, Jacobians by
jacrev), on seeded synthetic problems of 10 cameras and 300 landmarks with
tracks of 2-10 (`benchmark/harness/bal_scene.make_bal_scene`).

The solve works in its own axes (`dense_ba.bal_axes`: a half turn about y,
so the point's depth is +z and the x residual changes sign), so the
program's Jacobians are compared with the reference's residual written in
the program's parameters: the left rotation increment in its axes, then t,
f, k1, k2 added.

Tolerances, with their reasons:
- cost, kernel B: rtol 1e-5 (a float32 sum of ~1,700 terms);
- whitened residuals: 2e-3 (pixels of up to 800 at float32's 6e-8, the
  rotation's rounding times f ~ 2000: ~2e-4);
- Jacobian rows: 2e-4 of each row's largest entry (float32 against
  float64 with one to two orders of cancellation);
- S and b of kernel C: 2e-4 of each 9x9 block's (each row's) largest entry
  (float32 sums of a few dozen products, no cancellation to speak of);
- a whole solve: the float64 cost of the program's answer exceeds the
  reference's by at most COST_EXCESS = 1e-5 relative (the float32 solve
  reaches ~3e-8); the reference run in TF32 and a solve that holds k2 at 0
  reach 1e-2 and 6e-3, and both fail it (`test_faults_fail_the_solve_check`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import bal_reference as ref
from bundleadjustment_tpu_torch.data.bal import BALData, dense_problem, read_bal, write_bal
from bundleadjustment_tpu_torch.geometry.projection import project_bal
from bundleadjustment_tpu_torch.parallel import sharded_dense_ba as tsh
from bundleadjustment_tpu_torch.solvers import dense_ba, dense_kernels, lm
from torch_port_helpers import bal_scene

make_bal_scene = bal_scene().make_bal_scene

K, L = 10, 300
N = int(L * 5.54)
COST = {"huber_delta": 2.4477, "cheirality_penalty": 1.0e4}
COST_EXCESS = 1e-5
PHASES = ("ba.schur", "ba.camera_solve", "ba.eval", "ba.lm_update")
F = torch.tensor([-1.0, 1.0, -1.0], dtype=torch.float64)  # dense_ba.bal_axes


def _start(gt, seed):
    """A start as Bundler's: 0.02 rad and 0.05 a camera, f by 2%, k1 = k2 =
    0, 0.05 a landmark; camera 0 at its truth, as the benchmark's cell
    starts."""
    rng = np.random.default_rng(seed)
    c0 = gt.cameras.copy()
    c0[1:, :3] += rng.normal(0, 0.02, (K - 1, 3))
    c0[1:, 3:6] += rng.normal(0, 0.05, (K - 1, 3))
    c0[1:, 6] *= 1 + rng.normal(0, 0.02, K - 1)
    c0[1:, 7:] = 0.0
    return c0, gt.points + rng.normal(0, 0.05, gt.points.shape)


def _scene(seed=1):
    obs, gt = make_bal_scene(K, L, N, max_track=K, seed=seed)
    c0, p0 = _start(gt, seed)
    return BALData(c0, p0, obs.cam_idx, obs.pt_idx, obs.uv), gt


def _ref_problem(data, arith="float64"):
    return ref.Problem(data.cam_idx, data.pt_idx, data.uv, np.ones(len(data.cam_idx)),
                       np.arange(K) == 0, L, "cpu", ref.Arith(arith), **COST)


def _excess(p64, c_ref, cams, pts):
    cost = p64.cost(torch.as_tensor(cams).double(), torch.as_tensor(pts).double())
    return float(cost) / c_ref - 1.0


@pytest.fixture(scope="module")
def solved():
    """A start, the program's CPU solve from it and the reference's."""
    data, gt = _scene()
    prob, cams, pts, dropped = dense_problem(data, device="cpu")
    assert dropped == 0
    c, X, info = dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=30))
    p64 = _ref_problem(data)
    cr, Xr, info_r = ref.solve(p64, data.cameras, data.points)
    return data, gt, (c, X, info), (cr, Xr, float(p64.cost(cr, Xr))), p64


# ---------------------------------------------------------------------------
# the file format and the projection
# ---------------------------------------------------------------------------


def test_bal_file_round_trip_and_solve(tmp_path, solved):
    data, _gt, (c, X, _), (cr, Xr, c_ref), p64 = solved
    path = tmp_path / "problem-10-300-pre.txt"
    write_bal(path, data)
    back = read_bal(path)
    for name in ("cameras", "points", "cam_idx", "pt_idx", "uv"):
        a, b = getattr(data, name), getattr(back, name)
        assert a.shape == b.shape and np.array_equal(np.asarray(a, b.dtype), b), name
    prob, cams, pts, _ = dense_problem(back, device="cpu")
    c2, X2, _ = dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=30))
    assert torch.equal(c2, c) and torch.equal(X2, X)  # the same problem, the same bits
    assert _excess(p64, c_ref, c2, X2) <= COST_EXCESS


def test_project_bal_is_snavelys_projection(solved):
    data = solved[0]
    cams = torch.as_tensor(data.cameras)[data.cam_idx]
    X = torch.as_tensor(data.points)[data.pt_idx]
    uv, depth = project_bal(cams, X)
    r, d_ref = torch.func.vmap(ref.residual)(cams, X, torch.zeros_like(uv),
                                             torch.ones(len(uv), dtype=uv.dtype))
    assert torch.allclose(uv, r, rtol=0, atol=1e-9) and torch.allclose(depth, d_ref)
    assert bool((depth > 0).all())


def test_bal_axes_keep_the_cost():
    """The solve's axes (module docstring): the change is an involution, and
    the program's cost at BAL's cameras is BAL's cost."""
    data, _ = _scene(seed=4)
    R = dense_ba.aa_to_rotmat(torch.as_tensor(data.cameras[:, :3]))
    t = torch.as_tensor(data.cameras[:, 3:6])
    R2, t2 = dense_ba.bal_axes(*dense_ba.bal_axes(R, t))
    assert torch.equal(R2, R) and torch.equal(t2, t)
    prob, cams, pts, _ = dense_problem(data, device="cpu")
    st = dense_ba._lm_start(dense_kernels.PLAIN_OPS, dense_ba._to_cm(prob), cams, pts,
                            lm.LMConfig(), dense_ba._same)
    want = float(_ref_problem(data).cost(torch.as_tensor(data.cameras), torch.as_tensor(data.points)))
    assert float(st.cost) == pytest.approx(want, rel=1e-5)


def test_the_benchmark_s_reference_is_this_one():
    """`benchmark/reference/bal_ba.py` carries this reference's code, each
    function and class as here, and adds the comparison."""
    import ast
    import os

    here = os.path.dirname(os.path.abspath(__file__))

    def defs(path):
        return {n.name: ast.dump(n) for n in ast.parse(open(path).read()).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}

    ours = defs(os.path.join(here, "bal_reference.py"))
    theirs = defs(os.path.join(os.path.dirname(here), "benchmark", "reference", "bal_ba.py"))
    assert {k: theirs.get(k) for k in ours} == ours
    assert {"compare", "cost_settings", "newton_decrements"} <= set(theirs)


def test_bal_scene_draws_the_stated_map():
    """The generator's map: exact counts, tracks of distinct cameras within
    the arc, every ray pair's widest angle at least MIN_RAY_DEG, every
    observation in front of its camera and inside its image, camera indices
    not in ring order; one seed, one map."""
    scene = bal_scene()
    n_cams, n_pts, n_obs = 60, 2000, 11080
    obs, gt = scene.make_bal_scene(n_cams, n_pts, n_obs, max_track=20, track_arc=12, seed=5)
    assert len(gt.cameras) == n_cams and len(gt.points) == n_pts and len(obs.cam_idx) == n_obs
    lengths = np.bincount(obs.pt_idx, minlength=n_pts)
    assert lengths.min() >= 2 and lengths.max() <= 20
    pairs = set(zip(obs.pt_idx.tolist(), obs.cam_idx.tolist()))
    assert len(pairs) == n_obs  # a camera once a track
    uv, depth = scene.project_np(gt.cameras[obs.cam_idx], gt.points[obs.pt_idx])
    assert np.allclose(uv, gt.uv) and bool((depth > 1e-6).all())
    assert bool((np.abs(uv[:, 0]) < 800).all() and (np.abs(uv[:, 1]) < 600).all())
    R = dense_ba.aa_to_rotmat(torch.as_tensor(gt.cameras[:, :3])).numpy()
    centre = -np.einsum("kji,kj->ki", R, gt.cameras[:, 3:6])  # -R^T t
    ray = gt.points[obs.pt_idx] - centre[obs.cam_idx]
    ray /= np.linalg.norm(ray, axis=1, keepdims=True)
    widest = np.zeros(n_pts)
    for p in range(n_pts):
        r = ray[obs.pt_idx == p]
        widest[p] = np.degrees(np.arccos(np.clip((r @ r.T).min(), -1, 1)))
    assert widest.min() >= scene.MIN_RAY_DEG - 1e-9
    # ring order: the cameras' azimuths are not sorted by index
    az = np.arctan2(centre[:, 0], centre[:, 2])
    assert not (np.all(np.diff(np.unwrap(az)) > 0) or np.all(np.diff(np.unwrap(az)) < 0))
    obs2, gt2 = scene.make_bal_scene(n_cams, n_pts, n_obs, max_track=20, track_arc=12, seed=5)
    assert np.array_equal(obs2.uv, obs.uv) and np.array_equal(gt2.cameras, gt.cameras)


def test_log_rotation_near_pi():
    """`log_rotation` (the solve's output) holds its accuracy where the
    angle nears pi, as the cameras of a ring around a scene do."""
    rng = np.random.default_rng(0)
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = np.concatenate([np.pi - np.logspace(-6, -1, 32), rng.uniform(0, 3, 32)])
    w = torch.as_tensor(axis * angle[:, None])
    R = dense_ba.aa_to_rotmat(w).float()
    back = dense_ba.aa_to_rotmat(dense_ba.log_rotation(R).double())
    assert float((back - R.double()).abs().max()) < 1e-6


# ---------------------------------------------------------------------------
# kernels B and C (their plain versions, which the CPU runs) at width 9
# ---------------------------------------------------------------------------


def _residual_in_program_params(d, R0, t0, kk0, X, uv):
    """BAL's residual (Snavely's equations, as the reference writes them)
    of a camera moved by the program's nine increments d: the rotation
    exp([F d_w]) R0 (the left increment in the solve's axes), then
    t0 + F d_t and (f, k1, k2) + d_k; BAL's residual with its x negated,
    as the solve's axes give it."""
    w = F * d[:3]
    z = torch.zeros((), dtype=d.dtype)
    S = torch.stack([z, -w[2], w[1], w[2], z, -w[0], -w[1], w[0], z]).reshape(3, 3)
    P = torch.linalg.matrix_exp(S) @ R0 @ X + t0 + F * d[3:6]
    kk = kk0 + d[6:9]
    p = -P[:2] / P[2]
    n2 = (p * p).sum()
    res = kk[0] * (1.0 + kk[1] * n2 + kk[2] * n2 * n2) * p - uv
    return res * torch.tensor([-1.0, 1.0], dtype=d.dtype)


def _program_eval(data, robust):
    """The program's per-slot evaluation at the start: (problem, cm,
    (rho, r, Jc, Jp) of `_eval_cm`)."""
    prob, cams, pts, _ = dense_problem(data, device="cpu")
    cm = dense_ba._to_cm(prob)
    R = dense_ba.aa_to_rotmat(cams[:, :3])
    R, t = dense_ba.bal_axes(R, cams[:, 3:6])
    out = dense_ba._eval_cm(cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t,
                            cm.fixed_t, R, t, pts.T.contiguous(), robust, cams[:, 6:9])
    return prob, cm, out


def test_kernel_b_cost_and_residuals():
    data, _ = _scene(seed=2)
    prob, cm, (rho, r, Jc, Jp) = _program_eval(data, robust=False)
    p64 = _ref_problem(data)
    r_ref, _ = p64.residuals(torch.as_tensor(data.cameras), torch.as_tensor(data.points))
    l, o = torch.nonzero(prob.valid, as_tuple=True)
    # the dense slots hold the observations landmark by landmark, in table order
    order = np.argsort(data.pt_idx, kind="stable")
    got = torch.stack([-r[0][o, l], r[1][o, l]], -1).double()
    assert float((got - r_ref[order]).abs().max()) < 2e-3
    cost, *_ = dense_kernels.eval_assemble_plain(
        *dense_ba._eval_args(cm), *dense_ba.bal_axes(
            dense_ba.aa_to_rotmat(torch.as_tensor(data.cameras[:, :3]).float()),
            torch.as_tensor(data.cameras[:, 3:6]).float()),
        torch.as_tensor(data.points.T).float().contiguous(),
        intr=torch.as_tensor(data.cameras[:, 6:9]).float())
    assert float(cost) == pytest.approx(float(p64.cost(torch.as_tensor(data.cameras),
                                                       torch.as_tensor(data.points))), rel=1e-5)


def test_kernel_b_camera_jacobian_at_one_point():
    data, _ = _scene(seed=3)
    prob, cm, (_rho, _r, Jc, Jp) = _program_eval(data, robust=False)
    l, o = [int(x) for x in torch.nonzero(prob.valid & ~prob.cam_fixed[prob.cam_idx.long()])[7]]
    k = int(prob.cam_idx[l, o])
    cam = torch.as_tensor(data.cameras[k])
    R0 = dense_ba.aa_to_rotmat(cam[:3])
    X = torch.as_tensor(data.points[l])
    uv = prob.uv[l, o].double()
    Jd, JX = torch.func.jacrev(_residual_in_program_params, argnums=(0, 4))(
        torch.zeros(9, dtype=torch.float64), R0, cam[3:6], cam[6:9], X, uv)
    got_c = torch.tensor([[float(Jc[a][i][o, l]) for i in range(9)] for a in range(2)])
    got_p = torch.tensor([[float(Jp[a][j][o, l]) for j in range(3)] for a in range(2)])
    for got, want in ((got_c, Jd), (got_p, JX)):
        scale = want.abs().amax(1, keepdim=True)
        assert float(((got.double() - want) / scale).abs().max()) < 2e-4


def test_kernel_c_matches_the_reference_schur_system():
    data, _ = _scene(seed=5)
    prob, cams, pts, _ = dense_problem(data, device="cpu")
    cm = dense_ba._to_cm(prob)
    cfg = lm.LMConfig()
    st = dense_ba._lm_start(dense_kernels.KERNEL_OPS, cm, cams, pts, cfg, dense_ba._same)
    st = st._replace(lam=torch.tensor(1e-2))
    S, b, _ = dense_ba._schur_system(dense_kernels.KERNEL_OPS, cm, "s", True, st,
                                     dense_ba._same)
    # the reference's system at the same point, in the program's parameters
    p64 = _ref_problem(data)
    c64, X64 = cams.double(), pts.double()
    r, depth = p64.residuals(c64, X64)
    R0 = dense_ba.aa_to_rotmat(c64[:, :3])
    jac = torch.func.vmap(torch.func.jacrev(_residual_in_program_params, argnums=(0, 4)))
    Jc, Jp = jac(torch.zeros((N, 9), dtype=torch.float64), R0[p64.cam], c64[p64.cam, 3:6],
                 c64[p64.cam, 6:9], X64[p64.pt], p64.uv)
    n = torch.linalg.norm(r, dim=-1)
    sw = torch.sqrt(torch.where(n <= COST["huber_delta"], torch.ones_like(n),
                                COST["huber_delta"] / n))[:, None]
    sign = torch.tensor([-1.0, 1.0], dtype=torch.float64)
    Jc = torch.where(p64.cam_fixed[p64.cam][:, None, None], torch.zeros_like(Jc), Jc)
    S_ref, b_ref, *_ = p64.schur_system(Jc * sw[..., None], Jp * sw[..., None],
                                        r * sign * sw, 1e-2)
    S_got = S.double().reshape(9, K, 9, K).permute(1, 3, 0, 2)  # [k, k', i, i']
    b_got = b.double().reshape(9, K).T
    free = torch.arange(1, K)
    for k in free:
        for k2 in free:
            want = S_ref[k, k2]
            scale = float(S_ref[k, k].abs().max())
            assert float((S_got[k, k2] - want).abs().max()) <= 2e-4 * scale, (k, k2)
        assert float((b_got[k] - b_ref[k]).abs().max()) <= 2e-4 * float(b_ref[k].abs().max())


@pytest.mark.parametrize("which", ["kernel_b", "kernel_c"])
def test_plain_kernels_in_their_blocking_at_width_9(which):
    """The plain versions summed in the kernels' blocking (`plan=`) at width
    9, against their unblocked sums (the layout the card tests hold B and C
    to)."""
    data, _ = _scene(seed=6)
    prob, cams, pts, _ = dense_problem(data, device="cpu")
    cm = dense_ba._to_cm(prob)
    st = dense_ba._lm_start(dense_kernels.KERNEL_OPS, cm, cams, pts, lm.LMConfig(),
                            dense_ba._same)
    O = cm.cam_t.shape[0]
    if which == "kernel_b":
        plan = dense_kernels.dense_eval_plan(K, L, O, n_sm=3, width=9)
        args = (*dense_ba._eval_args(cm), st.R, st.t, st.Xt)
        a = dense_kernels.eval_assemble_plain(*args, intr=st.kk)
        b = dense_kernels.eval_assemble_plain(*args, plan=plan, intr=st.kk)
        assert plan.blocks > 1 and a[1].shape == (K, 54) and a[4].shape == (9, 3, O, L)
        assert float(b[0]) == pytest.approx(float(a[0]), rel=1e-6)
        assert float((b[1] - a[1]).abs().max()) <= 1e-5 * float(a[1].abs().max())
    else:
        plan = dense_kernels.schur_s_plan(K, L, O, n_sm=132, tile=3, width=9)
        args = (st.lam, st.Vu, st.g_p, cm.pt_valid, st.W.reshape(27, O, L), cm.cam_t, K)
        a = dense_kernels.schur_qqt_partial_plain(*args)
        b = dense_kernels.schur_qqt_partial_plain(*args, plan=plan)
        assert plan.n_tiles == 4 and a[0].shape == (9 * K, 9 * K) and a[3].shape == (9, K)
        for x, y in ((a[0], b[0]), (a[3], b[3])):
            assert float((x - y).abs().max()) <= 1e-5 * float(x.abs().max())


def test_schur_plan_at_dubrovnik_356():
    """Kernel C's tiles at the cell's shape: 9T x 9T tiles that fit a block's
    shared memory."""
    plan = dense_kernels.schur_s_plan(356, 226_730, 48, n_sm=132, width=9)
    assert plan.smem_bytes <= dense_kernels.SMEM_MAX_BYTES
    assert 14 <= plan.n_tiles <= 20 and plan.tile * plan.n_tiles >= 356
    assert dense_kernels.schur_s_plan(128, 100_000, 8, 132) == dense_kernels.schur_s_plan(
        128, 100_000, 8, 132, width=6)


# ---------------------------------------------------------------------------
# a whole solve
# ---------------------------------------------------------------------------


def test_whole_solve_against_the_reference(solved):
    data, _gt, (c, X, info), (cr, Xr, c_ref), p64 = solved
    assert c.shape == (K, 9) and X.shape == (L, 3)
    # camera 0 is fixed: t, f, k1 and k2 come back bit for bit, w through a
    # float32 rotation matrix
    c0 = torch.as_tensor(data.cameras[0]).float()
    assert torch.equal(c[0, 3:], c0[3:]) and torch.allclose(c[0, :3], c0[:3], rtol=0, atol=1e-6)
    assert _excess(p64, c_ref, c, X) <= COST_EXCESS
    gap = torch.linalg.norm(p64.project(c.double(), X.double()) - p64.project(cr, Xr), dim=-1)
    assert float(torch.sqrt((gap * gap).mean())) < 1e-3
    assert float(info["cost"]) < 0.02 * float(info["cost0"])


@pytest.mark.parametrize("fault", ["tf32_reference", "k2_held_at_0"])
def test_faults_fail_the_solve_check(fault, solved):
    data, _gt, _prog, (_cr, _Xr, c_ref), p64 = solved
    if fault == "tf32_reference":
        c, X, _ = ref.solve(_ref_problem(data, "tf32"), data.cameras, data.points)
    else:
        c, X, _ = ref.solve(p64, data.cameras, data.points, hold=[8])
    assert _excess(p64, c_ref, c, X) > COST_EXCESS


# ---------------------------------------------------------------------------
# routes, spans and counters
# ---------------------------------------------------------------------------


def test_pcg_and_kernel_e_take_width_9(solved):
    data, _gt, (c, X, _info), (_cr, _Xr, c_ref), p64 = solved
    prob, cams, pts, _ = dense_problem(data, device="cpu")
    c_e, X_e, _ = dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=30),
                                          ops=dense_kernels.PLAIN_OPS_CHOL)
    assert _excess(p64, c_ref, c_e, X_e) <= COST_EXCESS
    c_p, X_p, info = dense_ba.dense_ba_solve(
        prob, cams, pts, lm.LMConfig(max_iters=30, solver="pcg", pcg_iters=60))
    assert c_p.shape == (K, 9) and float(info["cost"]) < 0.05 * float(info["cost0"])


def _long_track_problem():
    """A BAL problem with tracks longer than 64: route (c)'s O."""
    obs, _ = make_bal_scene(70, 40, 40 * 66, max_track=70, track_arc=35, seed=8)
    prob, cams, pts, dropped = dense_problem(obs, max_obs=128, device="cpu")
    assert dropped == 0 and prob.cam_idx.shape[1] > dense_ba.S_KERNEL_MAX_O
    return prob, cams, pts


@pytest.mark.parametrize("route", ["route_c", "sharded", "sharded_pcg"])
def test_routes_without_width_9_refuse_before_any_work(route, monkeypatch):
    def no_work(*a, **k):
        raise AssertionError("work began")

    for op in ("eval_assemble", "eval_assemble_bs"):
        monkeypatch.setattr(dense_kernels, op, no_work)
    monkeypatch.setattr(dense_kernels, "KERNEL_OPS", dense_kernels.KERNEL_OPS._replace(
        eval_assemble=no_work, eval_assemble_bs=no_work))
    if route == "route_c":
        prob, cams, pts = _long_track_problem()
        run = lambda: dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=2))  # noqa: E731
        words = ("route (c)", "'bal'")
    else:
        data, _ = _scene()
        prob, cams, pts, _ = dense_problem(data, device="cpu")
        cfg = lm.LMConfig(max_iters=2, solver="pcg") if route == "sharded_pcg" else None
        run = lambda: tsh.sharded_dense_ba_solve(prob, cams, pts, cfg)  # noqa: E731
        words = ("sharded", "'bal'")
    with pytest.raises(ValueError) as err:
        run()
    assert all(w in str(err.value) for w in words)


def test_an_unknown_camera_model_is_refused():
    data, _ = _scene()
    with pytest.raises(ValueError, match="camera model"):
        dense_ba.densify_problem(None, data.cam_idx, data.pt_idx, data.uv,
                                 np.ones(N, np.float32), np.ones(N, bool), np.zeros(K, bool),
                                 L, device="cpu", camera_model="fisheye")


def _record():
    return dense_ba.TIMER.records()[-1]


def _phases():
    return {n: p["count"] for n, p in _record()["phases"].items()}


@pytest.fixture
def card_stand_in(monkeypatch):
    """The graphed path engaged on CPU tensors, each capture stood in for by
    a replay (as in tests/test_torch_dense_graph.py)."""
    import contextlib

    from test_torch_dense_graph import _capture_stand_in

    rule = dense_ba.graph_engages
    monkeypatch.setattr(dense_ba, "graph_engages", lambda device, *a: rule("cuda", *a))
    monkeypatch.setattr(dense_ba, "_capture", _capture_stand_in)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())


def test_spans_and_counters_eager_and_graphed(card_stand_in):
    """The phase spans on the BAL path, eager (first call) and graphed
    (capture, then replays), with the record's three counters; the graphed
    outputs bit for bit the eager ones."""
    data, _ = _scene(seed=9)
    prob, cams, pts, _ = dense_problem(data, device="cpu")
    iters = 4
    cfg = lm.LMConfig(max_iters=iters)
    counters = {"camera_width": 9, "valid_obs": N,
                "dense_slots": L * prob.cam_idx.shape[1]}
    eager = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert _phases() == dict.fromkeys(PHASES, iters)
    assert _record()["counters"] == counters
    first = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert _phases() == {"ba.capture": 1, "ba.graph": 1, **dict.fromkeys(PHASES, iters)}
    second = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert _phases() == {"ba.graph": 1, **dict.fromkeys(PHASES, iters)}
    assert _record()["counters"] == counters
    for out in (first, second):
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
        assert torch.equal(out[2]["cost_history"], eager[2]["cost_history"])
    # a problem of another model is another key
    pin = dataclasses.replace(prob, camera_model="pinhole")
    assert (dense_ba.graph_key(pin, cams, pts, cfg, dense_kernels.KERNEL_OPS)
            != dense_ba.graph_key(prob, cams, pts, cfg, dense_kernels.KERNEL_OPS))


def test_pinhole_records_width_6():
    from test_torch_dense_graph import _problem

    prob, cams, pts = _problem("s")
    dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=1))
    assert _record()["counters"] == {
        "camera_width": 6, "valid_obs": int(prob.valid.sum()),
        "dense_slots": prob.valid.numel()}


def test_the_timer_forgets_its_records_on_request():
    """`PhaseTimer.clear_records`, where a measurement starts: the solves
    after it are the only ones kept."""
    from test_torch_dense_graph import _problem

    prob, cams, pts = _problem("s")
    dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=1))
    dense_ba.TIMER.clear_records()
    assert dense_ba.TIMER.records() == []
    dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=1))
    assert len(dense_ba.TIMER.records()) == 1
