"""Per-phase wall-clock accumulator threaded through the pipeline.

Copied from `bundleadjustment_tpu/utils/profiling.py:PhaseTimer` (without
its JAX trace helper), so that the port runs where the JAX package is
absent. Phases are host wall time; on a CUDA device they include only the
device work that the phase waits for (the pipeline fetches every result it
branches on).
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
