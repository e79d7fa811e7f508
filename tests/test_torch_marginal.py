"""Port parity of the timing harness: `fit_line` and `measure_marginal` of
`utils/marginal.py` give the JAX package's results for the same
deterministic `time_fn`; `sustained_ms` times a CPU call ended by its sync;
`utils/profiling.device_trace` writes a Chrome trace on the CPU and raises
for the card where there is none."""

import glob
import json
import math

import pytest
import torch

from bundleadjustment_tpu.utils import marginal as jm
from bundleadjustment_tpu_torch.utils import marginal as tm
from bundleadjustment_tpu_torch.utils.profiling import device_trace


@pytest.mark.parametrize("xs,ys", [
    ([5, 10, 20, 40], [0.05, 0.0701, 0.1102, 0.1899]),
    ([8, 24, 48, 72], [0.31, 0.52, 0.95, 1.22]),
    ([1, 2], [3.0, 5.0]),
    ([16, 48, 96, 144], [0.002 * x + 0.011 for x in (16, 48, 96, 144)]),
])
def test_fit_line_equals_jax(xs, ys):
    got, ref = tm.fit_line(xs, ys), jm.fit_line(xs, ys)
    assert got[:2] == ref[:2]
    assert got[2] == ref[2] or (math.isnan(got[2]) and math.isnan(ref[2]))


def _timer():
    """A deterministic time_fn: a line with a wobble that depends on the
    call count, so the repeats' best and the stderr are not trivial."""
    calls = {"n": 0}

    def time_fn(it):
        calls["n"] += 1
        return 0.004 + 0.0015 * it + 0.0003 * ((calls["n"] * 7) % 5)

    return time_fn


@pytest.mark.parametrize("counts,repeats", [((5, 10, 20, 40), 3), ((8, 24, 48, 72), 2),
                                            ((5, 15, 40), 3)])
def test_measure_marginal_equals_jax(counts, repeats):
    got = tm.measure_marginal(_timer(), iter_counts=counts, repeats=repeats)
    ref = jm.measure_marginal(_timer(), iter_counts=counts, repeats=repeats)
    assert got == ref
    assert abs(got["slope_s"] - 0.0015) < 1e-4 and got["iters_per_s_lo"] < got["iters_per_s"]


def test_sustained_ms_ends_with_the_sync():
    events = []
    fn = lambda: events.append("call")  # noqa: E731
    sync = lambda: events.append("sync")  # noqa: E731
    ms = tm.sustained_ms(fn, sync, n=4, reps=2)
    assert ms >= 0.0
    assert events == ["call", "sync"] + (["call"] * 4 + ["sync"]) * 2
    a = torch.randn(64, 64)
    assert tm.sustained_ms(lambda: a @ a, lambda: None, n=5, reps=2) > 0.0


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.randn(128, 128)
    with device_trace(str(tmp_path), device="cpu") as prof:
        (a @ a).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    trace = json.load(open(files[0]))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names)
    assert any("mm" in e.key for e in prof.key_averages())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            with device_trace(str(tmp_path / "card")):
                pass
