"""The four per-layer readers that this benchmark's BAL cell brought, on the
CPU, on made-up traces and span records: `eval_roofline.bal`,
`schur_roofline.bal` and `ba_iter_bound_share.bal` read kernel B, the Schur
step and the iteration against the least work at a camera width of 9
(`harness/bounds_bal.py`), and nothing in a cell whose cameras are not 9
wide or where the trace holds nothing of theirs; `ba_slot_fill` reads the
valid observations over the dense slots from the solver's span records'
counters, and nothing where the records hold no counters (a program
without them) or every record was made under a profiler."""

from __future__ import annotations

import pytest
from test_trace_readers import STATS, chrome, device, reader

from harness import bounds, bounds_bal
from harness.trace import Trace

# two LM iterations of route (s) at width 9: C, its finish, then the
# Cholesky, then B's back-substitution and units
ITER = [("void (anonymous namespace)::schur_tiles<9>(float const*)", 40, None),
        ("void (anonymous namespace)::schur_finish<9>(float const*)", 5, None),
        ("xxtrf4_set_info_ker(int, int*)", 2, 3),
        ("void kernel<getrf_wo_pivot_params_<float, 0> >(int)", 50, 3),
        ("void (anonymous namespace)::dense_eval_backsub<9>(float const*)", 6, None),
        ("void (anonymous namespace)::dense_eval_units<false, 9>(float const*)", 24, None),
        ("void (anonymous namespace)::dense_eval_finish<54>(float const*)", 1, None)]
HOST = [("aten::linalg_cholesky_ex", 3)]


def records(host_ops=False, drop=0, iters=2):
    evs, t = [], 0.0
    for _ in range(iters):
        for name, dur, ext in ITER:
            evs.append(chrome(name, t, dur, ext) if host_ops else device(name, t, dur))
            t += dur + 1.0
    evs = evs[:len(evs) - drop]
    if host_ops:
        evs += [{"ph": "X", "cat": "cpu_op", "name": n, "args": {"External id": i}}
                for n, i in HOST]
        return Trace.from_chrome(evs, 1e-3, 1e-3)
    return Trace.from_events(evs, 1e-3, 1e-3)


def bal_layer(**kw):
    return {"kind": "ba", "camera_width": 9, "trace": records(),
            "host_trace": records(host_ops=True), "stats": STATS, "iters": 2,
            "solve_s": 0.5e-3, "device_name": "NVIDIA H100 80GB HBM3", **kw}


def test_the_width_9_readers_take_their_kernels():
    st, layer = STATS, bal_layer()
    pk = bounds_bal.peaks(layer["device_name"])
    assert reader("schur_roofline.bal")(layer) == pytest.approx(
        100 * 2 * bounds_bal.least_s(bounds_bal.schur_work(st), pk) / (2 * 45e-6))
    least_b = (bounds_bal.least_s(bounds_bal.eval_work(st, False), pk)
               + 2 * bounds_bal.least_s(bounds_bal.eval_work(st, True), pk))
    assert reader("eval_roofline.bal")(layer) == pytest.approx(100 * least_b / (2 * 31e-6))
    assert reader("ba_iter_bound_share.bal")(layer) == pytest.approx(
        100 * bounds_bal.least_s(bounds_bal.iter_work(st), pk) / 0.25e-3)


def test_width_9_counts_exceed_the_pinhole_s():
    """The same problem at width 9 needs more than at width 6, and the
    9-wide S (81 K^2 floats) more bytes than the 6-wide (36 K^2)."""
    st = STATS
    for w9, w6 in ((bounds_bal.iter_work, bounds.iter_work),
                   (bounds_bal.schur_work, bounds.schur_work),
                   (bounds_bal.eval_work, bounds.eval_work)):
        assert all(a > b for a, b in zip(w9(st), w6(st)))
    _, s9 = bounds_bal.schur_work(st)
    _, s6 = bounds.schur_work(st)
    N9, N6 = 9 * st["K"], 6 * st["K"]
    assert s9 - s6 >= 4 * (N9 * N9 - N6 * N6)


@pytest.mark.parametrize("name", ["eval_roofline.bal", "schur_roofline.bal",
                                  "ba_iter_bound_share.bal"])
@pytest.mark.parametrize("layer", [
    {"kind": "stream"},
    bal_layer(camera_width=6),
    {k: v for k, v in bal_layer().items() if k != "camera_width"},
], ids=["not_a_ba_layer", "width_6", "no_width"])
def test_the_width_9_readers_read_nothing_outside_their_cells(name, layer):
    assert reader(name)(layer) is None


@pytest.mark.parametrize("layer", [
    bal_layer(trace=records(drop=5)),  # the last window never closes
    bal_layer(iters=3),  # fewer windows than iterations
    bal_layer(host_trace=Trace([], {}, 1e-3, 1e-3), trace=records(iters=2)),
], ids=["window_open", "windows_short", "cholesky_unnamed"])
def test_the_schur_reader_reads_nothing_without_every_window(layer):
    assert reader("schur_roofline.bal")(layer) is None


def test_eval_reader_reads_nothing_without_kernel_b():
    tr = Trace([o for o in records().ops if not o[0].startswith("dense_eval")], {},
               1e-3, 1e-3)
    assert reader("eval_roofline.bal")(bal_layer(trace=tr)) is None


class Timer:
    def __init__(self, records):
        self._records = records

    def records(self):
        return list(self._records)


def record(counters, profiled=False):
    rec = {"name": "ba.solve", "start_ns": 0, "duration_ns": 1, "self_ns": 0,
           "profiled": profiled, "spans": None, "phases": {}}
    if counters is not None:
        rec["counters"] = counters
    return rec


@pytest.fixture
def timer(monkeypatch):
    from bundleadjustment_tpu_torch.solvers import dense_ba

    def put(recs):
        monkeypatch.setattr(dense_ba, "TIMER", Timer(recs))

    return put


def test_slot_fill_reads_the_counters(timer):
    c = {"camera_width": 9, "valid_obs": 1_255_268, "dense_slots": 226_730 * 56}
    timer([record(c), record(c), record({"valid_obs": 1, "dense_slots": 1}, profiled=True)])
    assert reader("ba_slot_fill")({"kind": "ba"}) == pytest.approx(
        100 * 1_255_268 / (226_730 * 56))


@pytest.mark.parametrize("recs", [
    [record(None), record(None)],  # a program whose records hold no counters
    [record({"valid_obs": 5, "dense_slots": 8}, profiled=True)],  # profiled only
    [],  # no record
], ids=["no_counters", "profiled_only", "no_records"])
def test_slot_fill_reads_nothing_without_counters(timer, recs):
    timer(recs)
    assert reader("ba_slot_fill")({"kind": "ba"}) is None


def test_slot_fill_reads_a_cpu_solve(timer):
    """The counters as the program writes them, on a CPU solve."""
    import numpy as np

    from bundleadjustment_tpu_torch.data.bal import dense_problem
    from harness.bal_scene import make_bal_scene
    from bundleadjustment_tpu_torch.solvers import dense_ba, lm

    obs, _ = make_bal_scene(8, 100, 400, max_track=8, seed=1)
    prob, cams, pts, _ = dense_problem(obs, device="cpu")
    real = dense_ba.TIMER.records
    dense_ba.dense_ba_solve(prob, cams, pts, lm.LMConfig(max_iters=1))
    timer(real()[-1:])
    assert reader("ba_slot_fill")({"kind": "ba"}) == pytest.approx(
        100 * 400 / np.prod(prob.valid.shape))
