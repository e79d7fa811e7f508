"""The share of the global-BA solves that replayed the LM iteration as CUDA
graphs, in %: of the program's span records of the window's last untraced
solves (`harness/spans.py`), those that hold the span `ba.graph`, which the
solver opens around a graphed solve's iterations. A record without it is
an eager solve's: the first solve of a problem, or one that the solver's
rule keeps eager.

Nothing is read where the program's solver has no graphed path (no
`GRAPHS` cache in its module, as before the graphs came), since no record
could hold the span there, nor where it keeps no untraced record."""

import sys

from harness import spans


def read(layer):
    if layer.get("kind") != "ba":
        return None
    if getattr(sys.modules.get(spans.SOLVER), "GRAPHS", None) is None:
        return None
    recs = [r for r in spans.solves() if r.get("profiled") is False]
    if not recs:
        return None
    return 100.0 * sum("ba.graph" in r["phases"] for r in recs) / len(recs)
