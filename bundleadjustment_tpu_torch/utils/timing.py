"""Device time of a call on the card: CUDA events around back-to-back calls
(`cuda_time`) and `torch.profiler`'s kernel records, per kernel, over
several sessions (`device_times`). `chip_smoke.py`, the tools and
`bench/frontend.py` time with these; each needs a card.
"""

from __future__ import annotations


def cuda_time(fn, reps=20, warmup=3):
    """Mean milliseconds per call of fn() on the current stream, CUDA events
    around back-to-back calls. Where the card finishes a call faster than
    the host issues the next, this is the host's per-call cost."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_name(name):
    """A profiler record's kernel name without its return type, namespace and
    arguments (at most 80 characters)."""
    name = name.split("(anonymous namespace)::")[-1]
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:80]


def device_events(prof):
    """The records of a `torch.profiler` session that are the card's work:
    its CUDA-typed events less the "gpu_user_annotation" ranges that the
    profiler lays on the card's timeline for a `record_function` span (each
    `utils/profiling.PhaseTimer` span opened under a session with host
    activity, such as the dense solve's `ba.*`)."""
    return [e for e in prof.events() if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]


def device_times(fn, reps=10, tries=3, kernel=None):
    """Device time per call of fn() from torch.profiler's kernel records
    (host gaps excluded). On an H100 a profiler session drops a few records
    (2-3 of 120-180 in most sessions) or, now and then, all of one kernel's,
    and in some sessions every kernel's durations come out at half of what
    CUDA events around the same device-bound calls show (PERF.md). So
    the times are built per kernel over `tries` sessions: in each, a
    kernel's records give its min, median, max and mean, and its launches a
    call (its records over `reps`, rounded, at least 1); "ms" is the sum
    over the kernels of mean x launches, "ms_min", "ms_median", "ms_max"
    the sums of their mins, medians and maxes, "per_kernel" each kernel's
    figures. Of the sessions that hold the most kernels (and, with `kernel`,
    a part of the name of a kernel that fn launches, that one), the one
    whose "ms" is the median counts; "sessions_ms" lists each session's
    "ms". Without a session that counts, the time is taken with CUDA events
    instead (cuda_time, "ms_source": "cuda_events", no spread)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    sessions = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = {}
        for e in device_events(prof):
            durs.setdefault(kernel_name(e.name), []).append(e.time_range.elapsed_us() / 1e3)
        if not durs or sum(map(sum, durs.values())) <= 0.0:
            continue
        if kernel is not None and not any(kernel in n for n in durs):
            continue
        per = {}
        for name, d in durs.items():
            per[name] = {"records": len(d), "launches": max(1, round(len(d) / reps)),
                         "min": min(d), "median": statistics.median(d), "max": max(d),
                         "mean": sum(d) / len(d)}
        tot = lambda k, per=per: sum(v[k] * v["launches"] for v in per.values())
        sessions.append({"ms": tot("mean"), "ms_source": "profiler", "ms_min": tot("min"),
                         "ms_median": tot("median"), "ms_max": tot("max"),
                         "per_kernel": per})
    if not sessions:
        return {"ms": cuda_time(fn), "ms_source": "cuda_events", "ms_min": None,
                "ms_median": None, "ms_max": None, "per_kernel": None,
                "sessions_ms": []}
    most = max(len(x["per_kernel"]) for x in sessions)
    full = sorted((x for x in sessions if len(x["per_kernel"]) == most),
                  key=lambda x: x["ms"])
    return {**full[(len(full) - 1) // 2], "sessions_ms": [x["ms"] for x in sessions]}
