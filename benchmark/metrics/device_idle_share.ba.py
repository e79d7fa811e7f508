"""The card's idle share over a global-BA solve, in %: 1 minus the union of
a traced solve's device operations' intervals (profiler) over the window's
untraced wall time a solve. The profiler adds to a solve's wall time, not
to its device time, so the traced solve's own wall would count the
profiler's cost as idle."""


def read(layer):
    if layer.get("kind") != "ba":
        return None
    return 100.0 * (1.0 - layer["trace"].busy_s / layer["solve_s"])
