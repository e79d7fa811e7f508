"""The program's own span records of its global-BA solves, read by the
per-layer metrics of host time: the records that the solver's span timer
(`bundleadjustment_tpu_torch.solvers.dense_ba.TIMER`, a `PhaseTimer` that
keeps its last 64 solves) holds of the solves made with no profiler
enabled. In a traced run those are the last solves of the untraced window,
the solves that set `ba_solve_ms`: the traced solves after it run under the
profiler, and their records say so.

A record has the solve's start and host duration (`ba.solve`, entry to
return; the solve does not synchronise) and, per phase span inside it, the
summed self time and the count. The profiler's Chrome trace carries the same
spans as "user_annotation" events, which `trace.Trace` does not keep.

Nothing is read where the program keeps no such records: a program without
the timer, or a run without an untraced solve."""

from __future__ import annotations

import sys

SOLVER = "bundleadjustment_tpu_torch.solvers.dense_ba"


def solves():
    """The solver's records of `ba.solve`, oldest first ([] where the program
    keeps none)."""
    timer = getattr(sys.modules.get(SOLVER), "TIMER", None)
    records = getattr(timer, "records", None)
    return [r for r in records() if r.get("name") == "ba.solve"] if records else []


def busy_share(layer):
    """100 x the host's time inside `ba.solve` over the wall from each
    untraced solve's start to the next's, summed over each pair of
    consecutive untraced solves, or None. In the closed loop that wall is the
    request's (the start's perturbation, the solve, the synchronise), the
    window's wall a solve over the very solves the numerator takes."""
    recs = solves() if layer.get("kind") == "ba" else []
    pairs = [(a, b) for a, b in zip(recs, recs[1:])
             if a.get("profiled") is False and b.get("profiled") is False]
    wall = sum(b["start_ns"] - a["start_ns"] for a, b in pairs)
    return 100.0 * sum(a["duration_ns"] for a, _ in pairs) / wall if wall > 0 else None


def phase_ms(layer, name):
    """The mean over the untraced solves of the span `name`'s self time a
    solve over its count (ms an LM iteration), or None."""
    recs = solves() if layer.get("kind") == "ba" else []
    per = [r["phases"][name]["self_ns"] / r["phases"][name]["count"]
           for r in recs if r.get("profiled") is False
           and r["phases"].get(name, {}).get("count")]
    return sum(per) / len(per) / 1e6 if per else None
