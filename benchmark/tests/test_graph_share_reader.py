"""The reader of `ba_graph_share` on the CPU: the share of the untraced
solves' span records that hold `ba.graph`, exactly, on made-up records and
on those of CPU solves (the eager path: 0%); and nothing where the layer
is not a global-BA solve's, where every record was made under a profiler,
where the program keeps no span timer, or where its solver has no graphed
path."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")
LAYER = {"kind": "ba"}


def reader():
    spec = importlib.util.spec_from_file_location(
        "ba_graph_share", os.path.join(METRICS, "ba_graph_share.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(start_ms, graphed, profiled=False):
    """A root record as the solver's timer keeps it."""
    phases = {n: {"self_ns": 1000, "count": 100}
              for n in ("ba.schur", "ba.camera_solve", "ba.eval", "ba.lm_update")}
    if graphed:
        phases["ba.graph"] = {"self_ns": 1000, "count": 1}
    return {"name": "ba.solve", "start_ns": int(start_ms * 1e6), "duration_ns": 1000,
            "self_ns": 0, "profiled": profiled, "spans": None, "phases": phases}


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


def test_reader_on_made_up_records(solver):
    solver([record(0, False), record(300, True), record(600, True), record(900, True),
            # the traced solves after the window: left out
            record(1200, False, profiled=True), record(1500, False, profiled=True)])
    assert reader()(LAYER) == pytest.approx(75.0, rel=1e-12)
    solver([record(t, True) for t in (0, 300)])
    assert reader()(LAYER) == 100.0


@pytest.mark.parametrize("case", ["not_ba", "all_profiled", "no_records", "no_timer",
                                  "no_graphed_path"])
def test_reader_reads_nothing(case, solver, monkeypatch):
    from bundleadjustment_tpu_torch.solvers import dense_ba

    layer = {"kind": "stream"} if case == "not_ba" else LAYER
    recs = [record(t, True, profiled=case == "all_profiled") for t in (0, 300)]
    solver([] if case == "no_records" else recs)
    if case == "no_timer":
        monkeypatch.delattr(dense_ba, "TIMER")
    if case == "no_graphed_path":
        monkeypatch.delattr(dense_ba, "GRAPHS")
    assert reader()(layer) is None


def test_reader_on_cpu_solves(monkeypatch):
    """CPU solves run the eager path, repeated or not: 0%."""
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
    monkeypatch.setattr(dense_ba, "TIMER", PhaseTimer())
    for _ in range(3):
        dense_ba.dense_ba_solve(prob, torch.from_numpy(sc.extr_init),
                                torch.from_numpy(sc.points_init), lm.LMConfig(max_iters=2),
                                ops=dense_kernels.PLAIN_OPS)
    assert len(dense_ba.TIMER.records()) == 3
    assert reader()(LAYER) == 0.0
