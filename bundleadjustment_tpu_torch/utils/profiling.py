"""Per-phase wall-clock accumulator threaded through the pipeline, which is
also the port's span recorder, and a device trace around a code region.

`PhaseTimer` is copied from `bundleadjustment_tpu/utils/profiling.py`, so
that the port runs where the JAX package is absent, and grown in place into
the port's span recorder: phases nest, on each thread's own stack; each is
timed on the monotonic clock, as the source's are, and stamped on
`time.time_ns()`'s, the host clock of the profiler's Chrome trace; while a
`torch.profiler` session is enabled each also opens a `record_function` of
its name; and a timer keeps a record of each of its last `PhaseTimer.KEEP`
root spans. Its `phase` and `report` give the
pipeline what the source's give. Phases are host wall time; on a CUDA
device they include only the device work that the phase waits for (the
pipeline fetches every result it branches on; the dense solve's spans wait
for nothing, so they time the host's issue of the work).
`device_trace` takes the place of the JAX package's `jax.profiler` trace:
a `torch.profiler` session that writes a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall time + call counts per named phase, and records each
    phase as a span.

    Spans nest: each thread keeps its own stack of open spans, and a span's
    self time is its duration less the time its child spans cover. A span
    opened while a `torch.profiler` session is enabled also opens a
    `torch.profiler.record_function` of its name, so it appears in the
    profiler's trace beside the device ops it launched; with no session
    enabled it makes no such call (about 15 us each). Durations are taken on
    the monotonic clock and stamped on `time.time_ns()`'s through one offset
    read when the timer is built.

    The timer keeps, in memory, a record of each of its last `KEEP` root
    spans (a root span is one opened with no span of this timer open on its
    thread: one request). `records()` returns them, newest last, each a
    dict: "name", "start_ns", "duration_ns" and "self_ns" of the root;
    "profiled", whether a profiler was enabled at the root's entry;
    "phases", per name of the spans inside it, {"self_ns": summed self time,
    "count": n}; and "spans", for a profiled root only (else None), every
    span of the root as (name, start_ns, end_ns, index of its parent in the
    list or -1), the root first, to be laid beside the profiler's trace;
    "counters", {name: value} set by `counter` while the root was open.
    The totals of `report()` take in a root's spans when the root closes.
    """

    KEEP = 64  # root spans whose records a timer keeps

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self._kept = collections.deque(maxlen=self.KEEP)
        self._local = threading.local()
        self._offset = time.time_ns() - time.perf_counter_ns()

    def phase(self, name):
        """A context manager: the span `name`."""
        return _Span(self, name)

    def counter(self, name, value):
        """Sets the counter `name` of the open root span's record to `value`
        (nothing where no span of this timer is open on this thread)."""
        th = getattr(self._local, "th", None)
        if th is not None and th.stack:
            th.counters[name] = value

    def records(self):
        """The records of the last `KEEP` root spans, newest last."""
        return list(self._kept)

    def clear_records(self):
        """Forgets the kept records (where a measurement starts, so that its
        records hold no earlier root span)."""
        self._kept.clear()

    def report(self):
        """{phase: {"total_s", "count", "mean_ms"}} sorted by total."""
        out = {}
        for name in sorted(self.total, key=lambda n: -self.total[n]):
            t, c = self.total[name], self.count[name]
            out[name] = {"total_s": round(t, 4), "count": c,
                         "mean_ms": round(1000.0 * t / max(c, 1), 3)}
        return out


class _Thread:
    """A thread's open spans and, for its open root, the aggregate of the
    spans inside it (name -> [ns, self ns, count]) and, under a profiler,
    each span."""

    __slots__ = ("stack", "phases", "spans", "counters")

    def __init__(self):
        self.stack = []


class _Span:
    """One span of a `PhaseTimer`, as a context manager."""

    __slots__ = ("timer", "name", "th", "index", "start", "covered", "parent", "rf")

    def __init__(self, timer, name):
        self.timer = timer
        self.name = name

    def __enter__(self):
        local = self.timer._local
        th = getattr(local, "th", None)
        if th is None:
            th = local.th = _Thread()
        self.th = th
        stack = th.stack
        profiled = torch._C._autograd._profiler_enabled()
        if stack:
            self.parent = stack[-1]
        else:
            self.parent = None
            th.phases = {}
            th.counters = {}
            th.spans = [] if profiled else None
        spans = th.spans
        if spans is not None:
            self.index = len(spans)
            spans.append(None)
        stack.append(self)
        self.covered = 0  # nanoseconds covered by child spans
        self.rf = None
        # the profiler's span lies inside the recorded one
        self.start = time.perf_counter_ns()
        if profiled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        dur = time.perf_counter_ns() - self.start
        th, name, parent = self.th, self.name, self.parent
        th.stack.pop()
        spans = th.spans
        if spans is not None:
            off = self.timer._offset + self.start
            spans[self.index] = (name, off, off + dur,
                                 -1 if parent is None else parent.index)
        if parent is not None:
            parent.covered += dur
            agg = th.phases.get(name)
            if agg is None:
                th.phases[name] = [dur, dur - self.covered, 1]
            else:
                agg[0] += dur
                agg[1] += dur - self.covered
                agg[2] += 1
            return False
        timer = self.timer
        total, count = timer.total, timer.count
        total[name] += dur / 1e9
        count[name] += 1
        for n, (d, _, c) in th.phases.items():
            total[n] += d / 1e9
            count[n] += c
        timer._kept.append({
            "name": name, "start_ns": self.start + timer._offset, "duration_ns": dur,
            "self_ns": dur - self.covered, "profiled": spans is not None,
            "phases": {n: {"self_ns": v[1], "count": v[2]}
                       for n, v in th.phases.items()},
            "spans": spans, "counters": th.counters})
        return False


@contextlib.contextmanager
def device_trace(log_dir, device="cuda"):
    """`torch.profiler` trace of a code region, written into `log_dir` as a
    Chrome trace (`<host>_<pid>.<ms>.pt.trace.json`, which TensorBoard and
    chrome://tracing read): host and card activity on "cuda" (which needs a
    card), host only on "cpu". The spans of `PhaseTimer`s opened inside it
    (the dense solve's `ba.*`) are its "user_annotation" events. Yields the
    profiler, whose `key_averages()` sums the region by operator and
    kernel."""
    from bundleadjustment_tpu_torch.device import resolve_device

    acts = [torch.profiler.ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
