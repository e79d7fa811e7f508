"""The per-layer readers of host time on the CPU: `host_busy_share.ba` and
`lm_host_ms.*` read the solver's span records (`harness/spans.py`), exactly,
on made-up records and on those of a CPU solve; and nothing where the layer
is not a global-BA solve's, where every record was made under a profiler,
or where the program keeps no span timer."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")
PHASES = ("schur", "camera_solve", "eval", "lm_update")
NAMES = ["host_busy_share.ba"] + [f"lm_host_ms.{p}" for p in PHASES]


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(start_ms, duration_ms, phases, profiled=False):
    """A root record as the solver's timer keeps it; phases {name: (self ms,
    count)}."""
    return {"name": "ba.solve", "start_ns": int(start_ms * 1e6),
            "duration_ns": int(duration_ms * 1e6), "self_ns": 0, "profiled": profiled,
            "spans": [], "phases": {f"ba.{n}": {"self_ns": int(s * 1e6), "count": c}
                                    for n, (s, c) in phases.items()}}


class Timer:
    def __init__(self, records):
        self._records = records

    def records(self):
        return list(self._records)


@pytest.fixture
def solver(monkeypatch):
    """The program's solver module, whose TIMER a test replaces."""
    from bundleadjustment_tpu_torch.solvers import dense_ba

    def put(records):
        monkeypatch.setattr(dense_ba, "TIMER", Timer(records))

    return put


LAYER = {"kind": "ba"}


def test_readers_on_made_up_records(solver):
    solver([
        record(-300, 280, {"schur": (20, 100), "camera_solve": (20, 100), "eval": (20, 100),
                           "lm_update": (20, 100)}),
        record(0, 200, {"schur": (30, 100), "camera_solve": (10, 100), "eval": (60, 100),
                        "lm_update": (80, 100)}),
        record(250, 240, {"schur": (40, 100), "camera_solve": (30, 100), "eval": (100, 100),
                          "lm_update": (40, 100)}),
        # the traced solves after the window: left out, and so is the wall
        # from the last untraced solve to the first traced one
        record(520, 900, {"schur": (900, 100)}, profiled=True),
        record(1500, 900, {"schur": (900, 100)}, profiled=True),
    ])
    got = {n: reader(n)(LAYER) for n in NAMES}
    assert got["host_busy_share.ba"] == pytest.approx(100 * (280 + 200) / (300 + 250), rel=1e-12)
    assert got["lm_host_ms.schur"] == pytest.approx((0.2 + 0.3 + 0.4) / 3, rel=1e-12)
    assert got["lm_host_ms.camera_solve"] == pytest.approx((0.2 + 0.1 + 0.3) / 3, rel=1e-12)
    assert got["lm_host_ms.eval"] == pytest.approx((0.2 + 0.6 + 1.0) / 3, rel=1e-12)
    assert got["lm_host_ms.lm_update"] == pytest.approx((0.2 + 0.8 + 0.4) / 3, rel=1e-12)


@pytest.mark.parametrize("case", ["not_ba", "all_profiled", "no_records", "no_timer"])
def test_readers_read_nothing(case, solver, monkeypatch):
    layer = {"kind": "stream"} if case == "not_ba" else LAYER
    recs = [record(t, 200, {p: (10, 100) for p in PHASES}, profiled=case == "all_profiled")
            for t in (0, 250)]
    solver([] if case == "no_records" else recs)
    if case == "no_timer":
        from bundleadjustment_tpu_torch.solvers import dense_ba

        monkeypatch.delattr(dense_ba, "TIMER")
    assert all(reader(n)(layer) is None for n in NAMES)


def test_readers_on_a_cpu_solve(monkeypatch):
    """The records of real solves (the plain kernels, 5 iterations) read as
    the records say, and only the untraced ones."""
    import torch

    from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu_torch.solvers import dense_ba, dense_kernels, lm
    from bundleadjustment_tpu_torch.utils.profiling import PhaseTimer

    sc = make_synthetic_scene(n_cams=6, n_pts=120, seed=5)
    cf = np.zeros(6, bool)
    cf[0] = True
    n = len(sc.cam_idx)
    prob, _ = dense_ba.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                                       np.ones(n, np.float32), np.ones(n, bool), cf, 120,
                                       device="cpu")

    def solve():
        dense_ba.dense_ba_solve(prob, torch.from_numpy(sc.extr_init),
                                torch.from_numpy(sc.points_init), lm.LMConfig(max_iters=5),
                                ops=dense_kernels.PLAIN_OPS)

    monkeypatch.setattr(dense_ba, "TIMER", PhaseTimer())
    solve()
    solve()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        solve()
    recs = dense_ba.TIMER.records()
    got = {n: reader(n)(LAYER) for n in NAMES}
    assert [r["profiled"] for r in recs] == [False, False, True]
    mine = recs[:2]
    assert got["host_busy_share.ba"] == pytest.approx(
        100 * mine[0]["duration_ns"] / (mine[1]["start_ns"] - mine[0]["start_ns"]), rel=1e-12)
    for p in PHASES:
        want = sum(r["phases"][f"ba.{p}"]["self_ns"] / 5 for r in mine) / 2 / 1e6
        assert got[f"lm_host_ms.{p}"] == pytest.approx(want, rel=1e-12)
