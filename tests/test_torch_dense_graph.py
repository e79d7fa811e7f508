"""The dense solve's two paths (`solvers/dense_ba.py`): eager, and the LM
iteration replayed as CUDA graphs around the eager camera solve.

On the CPU: the engage rule and the key; the cache of keys; the eager
path bit for bit against a frozen copy of the loop as it was before the
iteration was split into segment functions (routes (s) and (c), PCG, the
sharded engine); the graphed path, with each capture stood in for by a
replay that reruns the captured function into the same output tensors, bit
for bit against the eager path; which path the solves of the pipeline,
the sharded engine and PCG take; no `ba.graph` in a CPU solve's record.

Card-only (marker `cuda`; `python -m pytest --noconftest
tests/test_torch_dense_graph.py -q -s -m cuda`): the graphs against the
eager path from the same start, at small route (s) and (c) problems and
at the benchmark cells' maps: bit for bit where two eager solves agree bit
for bit, and else both within the cells' limits
(`benchmark/limits/`) against the float64 reference (the kernels C and the
Pf `index_add_` sum with atomics); a problem edited in place captured
anew; a solve's outputs left alone by the next; the spans of each path.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from bundleadjustment_tpu_torch import kernels
from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu_torch.parallel import sharded_dense_ba as tsh
from bundleadjustment_tpu_torch.solvers import dense_ba, dense_kernels, lm
from torch_port_helpers import cuda_device  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# The two maps of tests/test_torch_spans.py, copied: that file imports the JAX
# package, and this one runs on the card's machine, which has no JAX.
def _wide_map(K=72, L=40, seed=3):
    """K cameras on a 1.4 m baseline that all see L landmarks: O = K, route
    (c)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1, -0.7, 4], [1, 0.7, 6], (L, 3))
    extr = np.zeros((K, 6))
    extr[:, 3] = -0.02 * (np.arange(K) - K / 2)
    ci = np.repeat(np.arange(K), L).astype(np.int32)
    pi = np.tile(np.arange(L), K).astype(np.int32)
    xc = pts[pi] + extr[ci, 3:]
    uv = np.stack([500 * xc[:, 0] / xc[:, 2] + 319.5, 500 * xc[:, 1] / xc[:, 2] + 239.5], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    e0 = extr.copy()
    e0[1:] += rng.normal(0, [0.01] * 3 + [0.02] * 3, (K - 1, 6))
    p0 = pts + rng.normal(0, 0.03, pts.shape)
    return np.array([500, 500, 319.5, 239.5], np.float32), ci, pi, uv, e0, p0, K, L


def _small_map():
    sc = make_synthetic_scene(n_cams=8, n_pts=200, pixel_noise=0.3, seed=32)
    return sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.extr_init, sc.points_init, 8, 200


MAPS = {"s": _small_map, "c": _wide_map}


def _problem(route, device="cpu"):
    """(problem, cams0, points0) of the small map of `route`, first two
    cameras fixed."""
    K4, ci, pi, uv, e0, p0, K, L = MAPS[route]()
    cf = np.zeros(K, bool)
    cf[:2] = True
    n = len(ci)
    prob, _ = dense_ba.densify_problem(K4, ci, pi, uv.astype(np.float32),
                                       np.ones(n, np.float32), np.ones(n, bool), cf, L,
                                       max_obs=128, device=device)
    assert dense_ba.schur_route(prob.cam_idx.shape[1]) == {"s": "s", "c": "prepare"}[route]
    return (prob, torch.from_numpy(e0.astype(np.float32)).to(device),
            torch.from_numpy(p0.astype(np.float32)).to(device))


def _outputs(out):
    cams, pts, info = out
    return [cams, pts, info["cost0"], info["cost"], info["cost_history"]]


def _assert_same_bits(a, b):
    for x, y in zip(_outputs(a), _outputs(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x.cpu(), y.cpu()), (x, y)


@pytest.fixture(autouse=True)
def _fresh_cache():
    dense_ba.GRAPHS.clear()
    yield
    dense_ba.GRAPHS.clear()


# ---------------------------------------------------------------------------
# the engage rule and the key
# ---------------------------------------------------------------------------


def _sum(x):
    return x


ENGAGE = {  # (device, reduce, solver, seen) -> graphed
    "cpu_repeat": (("cpu", None, "dense", True), False),
    "sharded_repeat": (("cuda", _sum, "dense", True), False),
    "pcg_repeat": (("cuda", None, "pcg", True), False),
    "first_call": (("cuda", None, "dense", False), False),
    "repeat": (("cuda", None, "dense", True), True),
    "repeat_cuda1": ((torch.device("cuda", 1), None, "dense", True), True),
}


@pytest.mark.parametrize("case", list(ENGAGE))
def test_engage_rule(case):
    args, want = ENGAGE[case]
    assert dense_ba.graph_engages(*args) is want


def _edit(case, prob, cams, pts, cfg, ops):
    """The arguments of a call that differs from (prob, cams, pts, cfg,
    ops) as `case` says."""
    if case == "same":
        return prob, cams, pts, cfg, ops
    if case == "uv_edited_in_place":
        prob.uv[0, 0, 0] += 0.5
        return prob, cams, pts, cfg, ops
    if case == "same_values_new_tensors":
        return (dense_ba.DenseBAProblem(*(x.clone() for x in dense_ba._problem_tensors(prob))),
                cams, pts, cfg, ops)
    if case == "new_shape":
        p2, c2, x2 = _problem("c")
        return p2, c2, x2, cfg, ops
    if case == "robust":
        return prob, cams, pts, lm.LMConfig(max_iters=cfg.max_iters, robust=False), ops
    if case == "rtol":
        return prob, cams, pts, lm.LMConfig(max_iters=cfg.max_iters, rtol=1e-6), ops
    if case == "ops":
        return prob, cams, pts, cfg, dense_kernels.KERNEL_OPS_CHOL
    if case == "start_dtype":
        return prob, cams.double(), pts, cfg, ops
    raise ValueError(case)


KEY_EDITS = ["same", "uv_edited_in_place", "same_values_new_tensors", "new_shape",
             "robust", "rtol", "ops", "start_dtype"]


@pytest.mark.parametrize("case", KEY_EDITS)
def test_graph_key(case):
    """A call repeats the key only with the same problem tensors, unedited,
    the same settings and ops; the iteration count and the start's values
    are not in it."""
    prob, cams, pts = _problem("s")
    cfg = lm.LMConfig(max_iters=3)
    ops = dense_kernels.KERNEL_OPS
    key = dense_ba.graph_key(prob, cams, pts, cfg, ops)
    assert dense_ba.graph_key(prob, cams + 1.0, pts, lm.LMConfig(max_iters=7), ops) == key
    other = dense_ba.graph_key(*_edit(case, prob, cams, pts, cfg, ops))
    assert (other == key) is (case == "same")


def test_cache_keeps_the_newest_and_lapses_dead_problems():
    cache = dense_ba.GraphCache()
    probs = {i: _problem("s")[0] for i in range(cache.SIZE + 1)}

    def visit(i):
        return cache.visit(("key", i), dense_ba._problem_tensors(probs[i]))

    assert not visit(0)[1] and not visit(1)[1]
    entry, seen = visit(0)
    assert seen and visit(0)[0] is entry
    for i in range(2, cache.SIZE + 1):  # one key too many: the oldest, key 1, goes
        assert not visit(i)[1]
    assert visit(0)[1] and visit(2)[1]
    assert not visit(1)[1]
    visit(2)[0].loop = object()
    assert cache.captured() == 1
    del probs[2]  # its problem dies: the entry lapses, and its graphs go with it
    visit(0)
    assert cache.captured() == 0 and len(cache._entries) == cache.SIZE - 1


# ---------------------------------------------------------------------------
# the eager path against the loop before the split
# ---------------------------------------------------------------------------


def _frozen_solve(prob, cam_rt6, points, config, ops, reduce=None):
    """`dense_ba_solve`'s loop as it was before it was split into segment
    functions (spans left out), frozen here as the eager path's yardstick."""
    from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat, rotmat_to_aa
    from bundleadjustment_tpu_torch.solvers.dense_kernels import _backsub_plain
    from bundleadjustment_tpu_torch.solvers.schur import block_jacobi, pcg

    dk = ops
    single = reduce is None
    if single:
        reduce = lambda x: x  # noqa: E731
    cm = dense_ba._to_cm(prob)
    K = cm.cam_fixed.shape[0]
    O, L = cm.cam_t.shape
    route = dense_ba.schur_route(O)
    R = aa_to_rotmat(cam_rt6[:, :3]).contiguous()
    t = cam_rt6[:, 3:].contiguous()
    Xt = points.T.contiguous()
    args = (cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t)
    cost, red, Vu, g_p, W = dk.eval_assemble(*args, R, t, Xt, robust=config.robust)
    cost, red = reduce(cost), reduce(red)
    cost0 = cost
    dev, dt_ = cost.device, cost.dtype
    lam = torch.tensor(config.lam0, dtype=dt_, device=dev)
    nu = torch.tensor(2.0, dtype=dt_, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    fixed = cm.cam_fixed[:, None]
    zero = torch.zeros((), dtype=dt_, device=dev)
    hist = []
    pcg_mode = config.solver == "pcg"
    for _ in range(config.max_iters):
        W18 = W.reshape(18, O, L)
        if pcg_mode:
            matvec, b, U, vinv6 = dense_ba._pcg_system(lam, red, Vu, g_p, W18, cm, reduce)
            dc = pcg(matvec, b, block_jacobi(U), config.pcg_iters)
        else:
            if single and route == "s":
                S, _zv, vinv6, b = dk.schur_prepare_s(lam, Vu, g_p, cm.pt_valid, W18,
                                                      cm.cam_t, K, red, cm.cam_fixed)
            else:
                S, b, vinv6 = dense_ba._system_unfolded(dk, route, lam, Vu, g_p, W18, cm,
                                                        red, reduce)
            dc = dk.chol_solve(S, b).reshape(6, K).T
        dc = torch.where(fixed, zero, dc).contiguous()
        R_new = (aa_to_rotmat(dc[:, :3]) @ R).contiguous()
        t_new = (t + dc[:, 3:]).contiguous()
        if pcg_mode:
            Xt_n = _backsub_plain(cm.cam_t, dc, Xt, W18, vinv6, g_p, cm.pt_valid).contiguous()
            new_cost, red_n, Vu_n, gp_n, W_n = dk.eval_assemble(
                *args, R_new, t_new, Xt_n, robust=config.robust)
        else:
            new_cost, red_n, Vu_n, gp_n, W_n, Xt_n = dk.eval_assemble_bs(
                *args, R_new, t_new, dc, Xt, W18, vinv6, g_p, cm.pt_valid,
                robust=config.robust)
        new_cost, red_n = reduce(new_cost), reduce(red_n)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        take = accept & ~done
        rel = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        R = torch.where(take, R_new, R)
        t = torch.where(take, t_new, t)
        Xt = torch.where(take, Xt_n, Xt)
        lam, nu = (
            torch.where(done, lam, torch.where(accept, lam / 3.0, lam * nu)),
            torch.where(done, nu, torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)),
        )
        cost = torch.where(take, new_cost, cost)
        done = done | (accept & (rel < config.rtol))
        red = torch.where(take, red_n, red)
        Vu = torch.where(take, Vu_n, Vu)
        g_p = torch.where(take, gp_n, g_p)
        W = torch.where(take, W_n, W)
        hist.append(new_cost)
    cams_out = torch.cat([rotmat_to_aa(R), t], -1)
    info = {"cost0": cost0, "cost": cost,
            "cost_history": torch.stack(hist) if hist else cost[None][:0]}
    return cams_out, Xt.T, info


EAGER = {  # case -> (map, solver, sharded)
    "route_s": ("s", "dense", False),
    "route_c": ("c", "dense", False),
    "pcg": ("s", "pcg", False),
    "sharded_k5": ("s", "dense", True),
    "sharded_route_c": ("c", "dense", True),
    "sharded_pcg": ("s", "pcg", True),
}


@pytest.mark.parametrize("case", list(EAGER))
def test_eager_path_matches_the_loop_before_the_split(case):
    route, solver, sharded = EAGER[case]
    prob, cams, pts = _problem(route)
    cfg = lm.LMConfig(max_iters=6, solver=solver)
    ops = dense_kernels.KERNEL_OPS
    if sharded:
        got = tsh.sharded_dense_ba_solve(prob, cams, pts, cfg)
        want = _frozen_solve(prob, cams, pts, cfg, ops, reduce=lambda x: x)
    else:
        got = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
        want = _frozen_solve(prob, cams, pts, cfg, ops)
    _assert_same_bits(got, want)
    assert got[1].stride() == want[1].stride()
    assert float(got[2]["cost"]) < float(got[2]["cost0"])


def test_kernel_e_table_matches_the_loop_before_the_split():
    prob, cams, pts = _problem("s")
    cfg = lm.LMConfig(max_iters=4)
    _assert_same_bits(
        dense_ba.dense_ba_solve(prob, cams, pts, cfg, ops=dense_kernels.PLAIN_OPS_CHOL),
        _frozen_solve(prob, cams, pts, cfg, dense_kernels.PLAIN_OPS_CHOL))


# ---------------------------------------------------------------------------
# the graphed path on the CPU, each capture stood in for by a replay
# ---------------------------------------------------------------------------


class _Replay:
    """A stand-in for a captured graph: `replay()` runs the captured
    function again and writes its outputs into those of the capture, as a
    graph's replay writes its captured buffers."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        for mine, new in zip(self.out, self.fn()):
            if new is not mine:
                mine.copy_(new)


def _capture_stand_in(fn, pool):
    graph = _Replay(fn)
    return graph, graph.out


@pytest.fixture
def card_stand_in(monkeypatch):
    """The graphed path engaged on CPU tensors, with the stand-in capture:
    the engage rule sees a card, and nothing calls into CUDA."""
    rule = dense_ba.graph_engages
    monkeypatch.setattr(dense_ba, "graph_engages",
                        lambda device, *a: rule("cuda", *a))
    monkeypatch.setattr(dense_ba, "_capture", _capture_stand_in)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())


def _phases():
    rec = dense_ba.TIMER.records()[-1]
    return {n: p["count"] for n, p in rec["phases"].items()}


PHASES = ("ba.schur", "ba.camera_solve", "ba.eval", "ba.lm_update")


@pytest.mark.parametrize("rtol", [1e-9, 0.05])
@pytest.mark.parametrize("route", ["s", "c"])
def test_graphed_path_matches_eager(route, rtol, card_stand_in):
    """First call eager; the second captures and replays, the third replays:
    both bit for bit the eager outputs, in tensors that no later solve
    writes and that alias no buffer of the graphs. At rtol 0.05 the loop is
    done within the iterations, and frozen from there on."""
    iters = 5
    prob, cams, pts = _problem(route)
    cfg = lm.LMConfig(max_iters=iters, rtol=rtol)
    kernels.reset_launch_counts()
    eager = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert _phases() == dict.fromkeys(PHASES, iters)
    first = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert _phases() == {"ba.capture": 1, "ba.graph": 1, **dict.fromkeys(PHASES, iters)}
    kept = [x.clone() for x in _outputs(first)]
    second = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert _phases() == {"ba.graph": 1, **dict.fromkeys(PHASES, iters)}
    _assert_same_bits(first, eager)
    _assert_same_bits(second, eager)
    assert all(torch.equal(a, b) for a, b in zip(kept, _outputs(first)))
    loop = dense_ba.GRAPHS._entries[next(iter(dense_ba.GRAPHS._entries))].loop
    static = {x.data_ptr() for x in (*loop.st, *loop.trial, loop.dc, loop.S, loop.b)}
    assert not static & {x.data_ptr() for x in _outputs(second)}
    assert kernels.launch_counts()["graph_replay"] == 2 * 3 * iters
    # other start values through the same graphs, and another iteration count
    cfg7 = lm.LMConfig(max_iters=7, rtol=rtol)
    _assert_same_bits(dense_ba.dense_ba_solve(prob, cams * 0.5, pts, cfg7),
                      _frozen_solve(prob, cams * 0.5, pts, cfg7, dense_kernels.KERNEL_OPS))
    assert dense_ba.GRAPHS.captured() == 1


def test_a_problem_edited_in_place_is_captured_anew(card_stand_in):
    prob, cams, pts = _problem("s")
    cfg = lm.LMConfig(max_iters=4)
    for _ in range(2):
        dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    prob.uv[:, :, 0] += 2.0
    edited = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert "ba.graph" not in _phases()  # a new key: eager
    again = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert {"ba.capture", "ba.graph"} <= set(_phases())
    _assert_same_bits(again, edited)
    _assert_same_bits(edited, _frozen_solve(prob, cams, pts, cfg, dense_kernels.KERNEL_OPS))
    assert dense_ba.GRAPHS.captured() == 2


def test_the_pipeline_sharded_and_pcg_solves_stay_eager(card_stand_in):
    """With the rule seeing a card: the pipeline's BAs densify a new problem
    each call, the sharded engine passes `reduce`, PCG is not captured; each
    run twice, none replays."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem

    sc = make_synthetic_scene(n_cams=6, n_pts=120, seed=5)
    cf = np.zeros(6, bool)
    cf[0] = True
    n = len(sc.cam_idx)
    cams, pts = torch.from_numpy(sc.extr_init), torch.from_numpy(sc.points_init)
    cfg = lm.LMConfig(max_iters=3)

    def pipeline_ba():  # as the pipeline's _solve_ba densifies and solves
        dense, _ = densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                                   np.ones(n, np.float32), np.ones(n, bool), cf, 120,
                                   device="cpu")
        return dense_ba.dense_ba_solve(dense, cams, pts, cfg)

    prob, _ = densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, np.ones(n, np.float32),
                              np.ones(n, bool), cf, 120, device="cpu")
    runs = {"pipeline": pipeline_ba,
            "sharded": lambda: tsh.sharded_dense_ba_solve(prob, cams, pts, cfg),
            "pcg": lambda: dense_ba.dense_ba_solve(prob, cams, pts,
                                                   lm.LMConfig(max_iters=3, solver="pcg"))}
    for name, run in runs.items():
        for _ in range(2):
            run()
            assert set(_phases()) == set(PHASES), name
    assert dense_ba.GRAPHS.captured() == 0
    dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert "ba.graph" in _phases()  # the control: the exact solve repeated


def test_a_cpu_solve_records_no_graph_span():
    prob, cams, pts = _problem("s")
    cfg = lm.LMConfig(max_iters=2)
    kernels.reset_launch_counts()
    for _ in range(3):
        dense_ba.dense_ba_solve(prob, cams, pts, cfg)
        assert _phases() == dict.fromkeys(PHASES, 2)
    assert dense_ba.GRAPHS.captured() == 0 and not dense_ba.GRAPHS._entries
    assert kernels.launch_counts()["graph_replay"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _solve_three(prob, cams, pts, cfg):
    """Eager (first call), capture + replay, replay: their outputs and each
    record's phases; and a second eager solve of a copy of the problem."""
    outs, phases = [], []
    for _ in range(3):
        outs.append(dense_ba.dense_ba_solve(prob, cams, pts, cfg))
        phases.append(set(_phases()))
    copy = dense_ba.DenseBAProblem(*(x.clone() for x in dense_ba._problem_tensors(prob)))
    eager2 = dense_ba.dense_ba_solve(copy, cams, pts, cfg)
    torch.cuda.synchronize()
    return outs, phases, eager2


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(_outputs(a), _outputs(b)))


def _max_diff(a, b):
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(_outputs(a)[:2], _outputs(b)[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["s", "c"])
def test_graph_matches_eager_on_card(cuda_device, route):  # noqa: F811
    prob, cams, pts = _problem(route, cuda_device)
    cfg = lm.LMConfig(max_iters=10)
    (eager, first, second), phases, eager2 = _solve_three(prob, cams, pts, cfg)
    assert phases == [set(PHASES), {"ba.capture", "ba.graph", *PHASES},
                      {"ba.graph", *PHASES}]
    deterministic = _same_bits(eager, eager2)
    print(f"route {route}: eager twice bit-identical {deterministic}; graph vs eager "
          f"bit-identical {_same_bits(first, eager)} / {_same_bits(second, eager)}, "
          f"max |diff| {_max_diff(first, eager):.3g} / {_max_diff(second, eager):.3g}")
    if deterministic:
        assert _same_bits(first, eager) and _same_bits(second, eager)
    for out in (first, second):
        np.testing.assert_allclose(out[0].cpu().numpy(), eager[0].cpu().numpy(), atol=5e-4)
        np.testing.assert_allclose(float(out[2]["cost"]), float(eager[2]["cost"]), rtol=1e-3)


def _cell(workload, device):
    """The benchmark cell's map on the card, as its generator makes it, with
    its limits and the float64 reference problem."""
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from generators.ba_solves import Requests, make_map
    from harness.cell import Cell
    from reference import global_ba as ref

    cell = Cell(workload)
    seed = 2**31 + 99
    scene, fixed = make_map(cell.config, seed)
    req = Requests(cell.config, cell.traffic, scene, fixed, device)
    p64 = ref.Problem(scene.K4, scene.cam_idx, scene.pt_idx, scene.uv, scene.sigma2, fixed,
                      scene.points_gt.shape[0], device, ref.Arith("float64"),
                      **ref.cost_settings(cell.config))
    return cell, req, req.start(seed, 0), p64, ref


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tum_fr1_xyz.global_ba", "replica_room0.global_ba"])
def test_graph_matches_eager_at_the_cells_maps_on_card(cuda_device, workload):  # noqa: F811
    cell, req, (cams, pts), p64, ref = _cell(workload, cuda_device)
    (eager, first, second), phases, eager2 = _solve_three(req.prob, cams, pts, req.lm)
    assert phases[1] == {"ba.capture", "ba.graph", *PHASES}
    deterministic = _same_bits(eager, eager2)
    R, t, X, _ = ref.solve(p64, cams, pts)
    got = {name: ref.compare(p64, (R, t, X), out[0], out[1])
           for name, out in (("eager", eager), ("eager2", eager2), ("graph", first),
                             ("graph2", second))}
    print(f"{workload}: eager twice bit-identical {deterministic}; graph vs eager "
          f"bit-identical {_same_bits(first, eager)} / {_same_bits(second, eager)}, "
          f"max |diff| {_max_diff(first, eager):.3g} / {_max_diff(second, eager):.3g}; "
          f"limits {cell.limits}; {got}")
    if deterministic:
        assert _same_bits(first, eager) and _same_bits(second, eager)
    for name, numbers in got.items():
        assert all(numbers[k] <= lim for k, lim in cell.limits.items()), (name, numbers)


@pytest.mark.cuda
def test_edit_in_place_recaptures_on_card(cuda_device):  # noqa: F811
    """Every pixel moved by noise of 2 px in place after a capture: the next
    solve is eager (a new key), the one after captures again and agrees with
    it, and both are far from the unedited problem's solve."""
    prob, cams, pts = _problem("c", cuda_device)
    cfg = lm.LMConfig(max_iters=10)
    unedited = [dense_ba.dense_ba_solve(prob, cams, pts, cfg) for _ in range(2)]
    g = torch.Generator(device=cuda_device)
    g.manual_seed(7)
    prob.uv.add_(2.0 * torch.randn(prob.uv.shape, generator=g, device=cuda_device))
    edited = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert "ba.graph" not in _phases()
    again = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    assert {"ba.capture", "ba.graph"} <= set(_phases())
    assert dense_ba.GRAPHS.captured() == 2
    np.testing.assert_allclose(again[0].cpu().numpy(), edited[0].cpu().numpy(), atol=5e-4)
    cost = [float(x[2]["cost"]) for x in (unedited[1], edited, again)]
    assert cost[2] == pytest.approx(cost[1], rel=1e-3)
    assert abs(cost[2] - cost[0]) > 0.01 * cost[0], cost


@pytest.mark.cuda
def test_outputs_outlive_the_next_solve_on_card(cuda_device):  # noqa: F811
    prob, cams, pts = _problem("s", cuda_device)
    cfg = lm.LMConfig(max_iters=10)
    dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    first = dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    kept = [x.clone() for x in _outputs(first)]
    dense_ba.dense_ba_solve(prob, cams * 1.01, pts + 0.01, cfg)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kept, _outputs(first)))
    kernels.reset_launch_counts()
    dense_ba.dense_ba_solve(prob, cams, pts, cfg)
    counts = kernels.launch_counts()
    assert counts["graph_replay"] == 30 and counts["schur_prepare_s"] == 0
    assert counts["dense_eval_assemble"] == 1  # the seed eval, eager
