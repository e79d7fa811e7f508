"""Per-phase wall-clock accumulator threaded through the pipeline, and a
device trace around a code region.

`PhaseTimer` is copied from `bundleadjustment_tpu/utils/profiling.py`, so
that the port runs where the JAX package is absent. Phases are host wall
time; on a CUDA device they include only the device work that the phase
waits for (the pipeline fetches every result it branches on).
`device_trace` takes the place of the JAX package's `jax.profiler` trace:
a `torch.profiler` session that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulates wall time + call counts per named phase."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self):
        """{phase: {"total_s", "count", "mean_ms"}} sorted by total."""
        out = {}
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            t, c = self.total[name], self.count[name]
            out[name] = {"total_s": round(t, 4), "count": c,
                         "mean_ms": round(1000.0 * t / max(c, 1), 3)}
        return out


@contextlib.contextmanager
def device_trace(log_dir, device="cuda"):
    """`torch.profiler` trace of a code region, written into `log_dir` as a
    Chrome trace (`<host>_<pid>.<ms>.pt.trace.json`, which TensorBoard and
    chrome://tracing read): host and card activity on "cuda" (which needs a
    card), host only on "cpu". Yields the profiler, whose `key_averages()`
    sums the region by operator and kernel."""
    import torch

    from bundleadjustment_tpu_torch.device import resolve_device

    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
