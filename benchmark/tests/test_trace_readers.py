"""The trace reduction and the per-layer readers on a made-up profile, on
the CPU: busy time as the union of device intervals, idle gaps put to the
host op that launched next, the session that stands, what the Schur and
kernel-B readers count as theirs, and a Schur reader that reads nothing
where it cannot close each iteration's window."""

from __future__ import annotations

import importlib.util
import os
from types import SimpleNamespace

import pytest

from harness import bounds
from harness.trace import Trace, pick

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device(name, start, dur):
    """A device record as the profiler's `events()` gives it."""
    return SimpleNamespace(name=name, device_type="DeviceType.CUDA",
                           time_range=SimpleNamespace(start=start, elapsed_us=lambda: dur))


def chrome(name, start, dur, ext):
    """A device record as the profiler's Chrome trace gives it."""
    cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
    return {"ph": "X", "cat": cat, "name": name, "ts": start, "dur": dur,
            "args": {"External id": ext}}


# two LM iterations of route (c): D, Pf, Q Q^T, then the Cholesky, then B
# (name, device us, the external id of the host op that launched it)
ITER = [("void (anonymous namespace)::schur_prepare_units(float const*)", 10, None),
        ("void at::native::indexFuncLargeIndex<float, long>(int)", 5, 1),
        ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 20, 2),
        ("xxtrf4_set_info_ker(int, int*)", 2, 3),
        ("void kernel<getrf_wo_pivot_params_<float, 0> >(int)", 50, 3),
        ("void (anonymous namespace)::dense_eval_units<true>(float const*)", 30, None),
        ("Memcpy DtoD (Device -> Device)", 4, 4)]
HOST = [("aten::index_add_", 1), ("aten::mm", 2), ("aten::linalg_cholesky_ex", 3),
        ("aten::copy_", 4)]


def records(gap=1.0, host_ops=False, drop=0):
    evs, t = [], 0.0
    for _ in range(2):
        for name, dur, ext in ITER:
            evs.append(chrome(name, t, dur, ext) if host_ops else device(name, t, dur))
            t += dur + gap
    evs = evs[:len(evs) - drop]
    if host_ops:
        evs += [{"ph": "X", "cat": "cpu_op", "name": n, "args": {"External id": i}}
                for n, i in HOST]
        return Trace.from_chrome(evs, 1e-3, 1e-3)
    return Trace.from_events(evs, 1e-3, 1e-3)


def test_busy_gaps_and_names():
    for tr in (records(), records(host_ops=True)):
        assert tr.busy_s == pytest.approx(2 * 121e-6)
        assert tr.kernel_sum_s == pytest.approx(2 * 117e-6)
        assert [k[0] for k in tr.kernels()[:3]] == [
            "schur_prepare_units", "indexFuncLargeIndex<float, long>",
            "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n"]
    gaps = dict(records(host_ops=True).idle_gaps())
    assert gaps["aten::linalg_cholesky_ex"] == pytest.approx(4e-6)
    assert gaps["launch of schur_prepare_units"] == pytest.approx(1e-6)
    assert sum(gaps.values()) == pytest.approx(13e-6)


def test_the_median_of_the_fullest_sessions_stands():
    full = [records(gap) for gap in (1.0, 2.0, 3.0)]
    assert pick(full + [records(drop=1)]) is full[1]


STATS = {"K": 4, "L": 100, "n_obs": 400, "n_slots": 350, "n_pairs": 900.0}


def ba_layer(**kw):
    """A traced run's layer: two iterations, an untraced solve of 0.5 ms."""
    return {"kind": "ba", "trace": records(), "host_trace": records(host_ops=True),
            "stats": STATS, "iters": 2, "solve_s": 0.5e-3,
            "device_name": "NVIDIA H100 80GB HBM3", **kw}


def test_readers_take_their_kernels():
    st = STATS
    layer = ba_layer()
    pk = bounds.peaks(layer["device_name"])
    # the Schur step: D, Pf and Q Q^T, up to the Cholesky's first kernel,
    # whose name the session with host ops gives
    assert reader("schur_roofline")(layer) == pytest.approx(
        100 * 2 * bounds.least_s(bounds.schur_work(st), pk) / (2 * 35e-6))
    least_b = (bounds.least_s(bounds.eval_work(st, False), pk)
               + 2 * bounds.least_s(bounds.eval_work(st, True), pk))
    assert reader("eval_roofline")(layer) == pytest.approx(100 * least_b / (2 * 30e-6))
    # the untraced solve's wall, not the traced one's (1 ms here)
    assert reader("device_idle_share.ba")(layer) == pytest.approx(100 * (1 - 242e-6 / 0.5e-3))
    assert reader("ba_iter_bound_share")(layer) == pytest.approx(
        100 * bounds.least_s(bounds.iter_work(st), pk) / 0.25e-3)
    assert reader("schur_roofline")({"kind": "stream"}) is None


def unlinked():
    """The session with host ops, with no device record linked to its op."""
    tr = records(host_ops=True)
    tr.host = {}
    return tr


@pytest.mark.parametrize("layer", [
    ba_layer(host_trace=unlinked()),  # the Cholesky's kernels not named
    ba_layer(iters=3),  # fewer windows than iterations
    ba_layer(trace=records(drop=4)),  # the last window never closes
], ids=["cholesky_unlinked", "windows_short", "window_open"])
def test_schur_reader_reads_nothing_without_every_window(layer):
    assert reader("schur_roofline")(layer) is None
