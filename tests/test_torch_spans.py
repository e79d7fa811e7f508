"""The dense solve's spans (`solvers/dense_ba.TIMER`, a `utils/profiling.
PhaseTimer`) on the CPU, with the plain kernels: one `ba.solve` a solve and
one `ba.schur`, `ba.camera_solve`, `ba.eval` and `ba.lm_update` an LM
iteration on route (s), route (c) (O > 64) and PCG; self times that add up;
the records' profiler flag and their bound; no `record_function` without a
profiler; the pipeline's report; and the spans in a Chrome trace on the
host clock of the in-memory records."""

import glob
import json
import time

import numpy as np
import pytest
import torch

from bundleadjustment_tpu.utils.profiling import PhaseTimer as SourceTimer
from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu_torch.solvers import dense_ba, dense_kernels, lm
from bundleadjustment_tpu_torch.utils.profiling import PhaseTimer, device_trace

PHASES = ("ba.schur", "ba.camera_solve", "ba.eval", "ba.lm_update")
ITERS = 3


def _wide_map(K=72, L=40, seed=3):
    """K cameras on a 1.4 m baseline that all see L landmarks: O = K."""
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
    return (np.array([500, 500, 319.5, 239.5], np.float32), ci, pi, uv, e0, p0, K, L)


def _small_map():
    sc = make_synthetic_scene(n_cams=8, n_pts=200, pixel_noise=0.3, seed=32)
    return sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.extr_init, sc.points_init, 8, 200


CASES = {"route_s": (_small_map, "dense", "s"), "route_c": (_wide_map, "dense", "prepare"),
         "pcg": (_small_map, "pcg", "s")}


def _solve(case, iters=ITERS):
    make, solver, route = CASES[case]
    K4, ci, pi, uv, e0, p0, K, L = make()
    cf = np.zeros(K, bool)
    cf[:2] = True
    n = len(ci)
    prob, _ = dense_ba.densify_problem(K4, ci, pi, uv.astype(np.float32),
                                       np.ones(n, np.float32), np.ones(n, bool), cf, L,
                                       max_obs=128, device="cpu")
    assert dense_ba.schur_route(prob.cam_idx.shape[1]) == route
    cfg = lm.LMConfig(max_iters=iters, solver=solver)
    return dense_ba.dense_ba_solve(prob, torch.from_numpy(e0.astype(np.float32)),
                                   torch.from_numpy(p0.astype(np.float32)), cfg,
                                   ops=dense_kernels.PLAIN_OPS)


@pytest.mark.parametrize("case", list(CASES))
def test_one_span_a_phase_an_iteration(case, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    n0 = dense_ba.TIMER.count["ba.solve"]
    _solve(case)
    rec = dense_ba.TIMER.records()[-1]
    assert dense_ba.TIMER.count["ba.solve"] == n0 + 1
    assert rec["name"] == "ba.solve" and rec["profiled"] is False
    assert {n: p["count"] for n, p in rec["phases"].items()} == dict.fromkeys(PHASES, ITERS)
    assert rec["spans"] is None  # each span is kept only for a profiler's trace
    selfs = [p["self_ns"] for p in rec["phases"].values()]
    assert min(selfs) >= 0 and rec["self_ns"] >= 0
    assert sum(selfs) + rec["self_ns"] == rec["duration_ns"]
    assert abs(rec["start_ns"] - time.time_ns()) < 60e9


def test_records_are_bounded_newest_last(monkeypatch):
    assert dense_ba.TIMER._kept.maxlen == PhaseTimer.KEEP == 64
    monkeypatch.setattr(PhaseTimer, "KEEP", 3)
    timer = PhaseTimer()
    monkeypatch.setattr(dense_ba, "TIMER", timer)
    for _ in range(5):
        _solve("route_s", iters=1)
    recs = timer.records()
    assert len(recs) == 3 and timer.count["ba.solve"] == 5
    assert timer.count["ba.eval"] == 5  # a root's spans join the totals as it closes
    assert [r["start_ns"] for r in recs] == sorted(r["start_ns"] for r in recs)


def test_nesting_and_the_pipelines_report():
    """Spans nest and the report keeps the source's form: inclusive totals
    by name, sorted by total."""
    t = PhaseTimer()
    _frame(t)
    rec = t.records()[-1]
    assert rec["phases"]["detect"]["count"] == 2 and rec["phases"]["blur"]["count"] == 1
    assert rec["phases"]["detect"]["self_ns"] + rec["phases"]["blur"]["self_ns"] + \
        rec["self_ns"] == rec["duration_ns"]
    rep = t.report()
    assert list(rep) == ["frame", "detect", "blur"]
    assert rep["detect"]["count"] == 2 and rep["detect"]["total_s"] >= 0.01
    src = SourceTimer()
    src.total.update(t.total)
    src.count.update(t.count)
    assert rep == src.report()


def _frame(t):
    with t.phase("frame"):
        with t.phase("detect"):
            time.sleep(0.01)
            with t.phase("blur"):
                pass
        with t.phase("detect"):
            pass


def test_nested_spans_under_a_profiler():
    """Under a profiler a root also keeps each span, with its parent, on the
    host clock of the profiler's trace, inside the root."""
    t = PhaseTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        before = time.time_ns()
        _frame(t)
        after = time.time_ns()
    rec = t.records()[-1]
    assert rec["profiled"] is True
    assert [(s[0], s[3]) for s in rec["spans"]] == [("frame", -1), ("detect", 0),
                                                   ("blur", 1), ("detect", 0)]
    t0, t1 = rec["spans"][0][1:3]
    assert t0 == rec["start_ns"] and t1 - t0 == rec["duration_ns"]
    assert all(t0 <= s[1] <= s[2] <= t1 for s in rec["spans"])
    slack_ns = 1e6  # the two clocks' offset is read once, when the timer is built
    assert before - slack_ns <= t0 and t1 <= after + slack_ns


def test_spans_are_not_counted_as_kernels(monkeypatch):
    """A profiler with host activity lays each span on the card's timeline as
    a "gpu_user_annotation" (a CUDA-typed event): the readers of the card's
    work leave the spans out. On the CPU every event of a profiled solve is
    relabelled CUDA-typed to stand in for the card's timeline."""
    import profile_port
    from bundleadjustment_tpu_torch.utils.timing import device_events

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _solve("route_s", iters=2)
    events = prof.events()
    for e in events:
        e.device_type = torch.autograd.DeviceType.CUDA
    monkeypatch.setattr(prof, "events", lambda: events)
    spans = {"ba.solve", *PHASES}
    assert spans <= {e.name for e in events}
    names = [e.name for e in device_events(prof)]
    assert names and not spans & set(names)
    assert [n for n, _ in profile_port.kernel_events(prof)] == names


def test_spans_in_the_chrome_trace(tmp_path):
    with device_trace(str(tmp_path), device="cpu"):
        _solve("route_s", iters=2)
    rec = dense_ba.TIMER.records()[-1]
    assert rec["profiled"] is True
    (path,) = glob.glob(str(tmp_path / "*.json"))
    trace = json.load(open(path))
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ann = [e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in ann} == {"ba.solve", *PHASES}
    ann.sort(key=lambda e: e["ts"])
    assert [e["name"] for e in ann] == [s[0] for s in rec["spans"]]
    slack_us = 300.0
    for e, (_name, start, end, _parent) in zip(ann, rec["spans"]):
        ts = e["ts"] + base_us
        assert start / 1e3 - slack_us <= ts <= ts + e["dur"] <= end / 1e3 + slack_us
