"""Device traces of the traced run: one call of the timed path under
`torch.profiler`, with CUDA events around it, read back from the
profiler's events, or from its Chrome trace where the host's ops are
recorded too.

The profiler on this card has two known faults: a session now and then
drops kernel records, and some sessions report every duration at half of
what CUDA events show. So a traced run makes several sessions of the same
call (`pick`): of those that hold the most device records, the one whose
busy time is the median stands. `Trace.event_s` (CUDA events around the
same call) is printed beside the profiler's figures, so a session whose
durations are off shows against it.
"""

from __future__ import annotations

import json
import os
import tempfile
import time


def short_name(name):
    """A kernel's name without its return type, its namespaces' noise and its
    arguments (at most 80 characters)."""
    name = name.replace("(anonymous namespace)::", "").replace("at::native::", "")
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:80]


def union_s(intervals):
    """Seconds covered by (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


class Trace:
    """One profiled call: its device operations as (name, start us,
    duration us, id of the host op that launched it or None, kind:
    "kernel" or "memory"), the host ops' names by that id, the host wall
    seconds and the CUDA-event seconds."""

    def __init__(self, ops, host, wall_s, event_s):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.host = host
        self.wall_s = wall_s
        self.event_s = event_s
        self.busy_s = union_s([(o[1], o[1] + o[2]) for o in self.ops])
        self.kernel_sum_s = sum(o[2] for o in self.ops if o[4] == "kernel") / 1e6
        self.span_s = ((self.ops[-1][1] + self.ops[-1][2] - self.ops[0][1]) / 1e6
                       if self.ops else 0.0)

    @classmethod
    def from_events(cls, events, wall_s, event_s):
        """From the profiler's `events()`: device operations only (this
        card's profiler links no host op to them there)."""
        ops = [(short_name(e.name), float(e.time_range.start),
                float(e.time_range.elapsed_us()), None,
                "memory" if e.name.startswith(("Memcpy", "Memset")) else "kernel")
               for e in events if str(e.device_type).endswith("CUDA")]
        return cls(ops, {}, wall_s, event_s)

    @classmethod
    def from_chrome(cls, events, wall_s, event_s):
        """From the profiler's Chrome trace, which links each device
        operation to its host op by "External id"."""
        ops, host = [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ext = (e.get("args") or {}).get("External id")
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                ops.append((short_name(e["name"]), float(e["ts"]), float(e.get("dur", 0.0)),
                            ext, "kernel" if cat == "kernel" else "memory"))
            elif cat == "cpu_op" and ext is not None:
                host.setdefault(ext, e["name"])
        return cls(ops, host, wall_s, event_s)

    def kernels(self):
        return [o for o in self.ops if o[4] == "kernel"]

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took most time."""
        tot = {}
        for name, _, dur, _, _ in self.ops:
            tot[name] = tot.get(name, 0.0) + dur / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """[[what the host launched next, seconds]]: the device's idle gaps
        inside the traced call, each put to the host op that launched the
        operation after it (a launch from outside any aten op, as the
        program's ctypes kernels are, by that operation's name)."""
        tot, end = {}, None
        for name, ts, dur, ext, _ in self.ops:
            if end is not None and ts > end:
                who = self.host.get(ext) or f"launch of {name}"
                tot[who] = tot.get(who, 0.0) + (ts - end) / 1e6
            end = ts + dur if end is None else max(end, ts + dur)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def summary(self):
        return {"wall_s": self.wall_s, "event_s": self.event_s, "busy_s": self.busy_s,
                "kernel_sum_s": self.kernel_sum_s, "span_s": self.span_s,
                "records": len(self.ops)}


def traced(fn, host_ops=False):
    """(Trace, fn's result) of one call of fn(), synchronised. Without
    `host_ops` the profiler records the card's activity only and is read
    in memory; with them it also records the host's aten ops, and the
    trace goes through a Chrome trace file under TMPDIR (about 30 MB for a
    solve), deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    event_s = e0.elapsed_time(e1) / 1e3
    if not host_ops:
        return Trace.from_events(prof.events(), wall, event_s), out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace.from_chrome(events, wall, event_s), out


def pick(traces):
    """The trace that stands: of those with the most device records, the
    median by busy time."""
    most = max(len(t.ops) for t in traces)
    full = sorted((t for t in traces if len(t.ops) == most), key=lambda t: t.busy_s)
    return full[(len(full) - 1) // 2]
