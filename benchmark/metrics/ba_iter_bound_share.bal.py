"""The dense LM iteration's share of its least time at a camera width of 9,
in a cell with BAL's camera: the least time of one exact iteration on this
problem (`harness/bounds_bal.iter_work`: operations and bytes of the valid
observations, at the card's float32 and HBM peaks) over the window's
untraced wall time a solve per iteration, in %. The whole iteration's
share, beside the rooflines of its kernels. Nothing is read in a cell
whose cameras are not 9 wide."""

from harness import bounds_bal


def read(layer):
    if layer.get("kind") != "ba" or layer.get("camera_width") != 9:
        return None
    pk = bounds_bal.peaks(layer["device_name"])
    if pk is None:
        return None
    per_iter_s = layer["solve_s"] / layer["iters"]
    return 100.0 * bounds_bal.least_s(bounds_bal.iter_work(layer["stats"]), pk) / per_iter_s
