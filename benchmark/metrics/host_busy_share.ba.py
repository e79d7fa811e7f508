"""The host's busy share of a global-BA solve, in %: the host's time inside
the program's `ba.solve` span (entry to return, with no synchronise) over
the solve's wall in the window's closed loop, from one solve's start to the
next's, both summed over the consecutive solves of the program's span
records of the window's last untraced solves (`harness/spans.py`). The
share of a solve's wall during which the host was still issuing it: near
100 the host paces the card.

Numerator and denominator are taken over the same solves: over the whole
window's mean wall a solve (`layer["solve_s"]`), the share of the last
solves passes 100 where they ran slower than the window's mean (105% in a
room0 run on an H100)."""

from harness import spans


def read(layer):
    return spans.busy_share(layer)
