"""The share of the dense layout's observation slots that hold an
observation, in %: the valid observations over the slots L x O of the
problem's [L, O] layout, from the counters that the program's solver keeps
in each solve's span record (`valid_obs`, `dense_slots`), averaged over the
window's last untraced solves (`harness/spans.py`). What the dense layout
pays for its longest track: every kernel of the iteration walks all L x O
slots. Nothing is read where the program's records hold no such counters
(a program without them), nor where no untraced record is kept."""

from harness import spans


def read(layer):
    if layer.get("kind") != "ba":
        return None
    shares = []
    for r in spans.solves():
        c = r.get("counters") or {}
        if r.get("profiled") is False and c.get("dense_slots"):
            shares.append(100.0 * c["valid_obs"] / c["dense_slots"])
    return sum(shares) / len(shares) if shares else None
