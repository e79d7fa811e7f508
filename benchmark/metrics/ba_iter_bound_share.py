"""The dense LM iteration's share of its least time: the least time of one
exact iteration on this problem (`harness/bounds.iter_work`: operations and
bytes of the valid observations, at the card's float32 and HBM peaks) over
the window's untraced wall time a solve per iteration, in %. It is the
whole iteration's share, beside the rooflines of its kernels: a later change
that takes a kernel off the path silences that kernel's roofline, and this
one still bounds it."""

from harness import bounds


def read(layer):
    if layer.get("kind") != "ba":
        return None
    pk = bounds.peaks(layer["device_name"])
    if pk is None:
        return None
    per_iter_s = layer["solve_s"] / layer["iters"]
    return 100.0 * bounds.least_s(bounds.iter_work(layer["stats"]), pk) / per_iter_s
