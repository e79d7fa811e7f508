"""Kernel B's share of its roofline at a camera width of 9 over a traced
global-BA solve of a cell with BAL's camera, in %: the least time of its
calls (`harness/bounds_bal.eval_work`: the seed evaluation, then one
evaluation with the back-substitution an LM iteration) over the device time
of B's kernels (`csrc/dense_eval.cu`), by the profiler's kernel names.
Nothing is read in a cell whose cameras are not 9 wide."""

from harness import bounds_bal

B_KERNELS = ("dense_eval_units", "dense_eval_finish", "dense_eval_backsub")


def read(layer):
    if layer.get("kind") != "ba" or layer.get("camera_width") != 9:
        return None
    pk = bounds_bal.peaks(layer["device_name"])
    dev_s = sum(k[2] for k in layer["trace"].kernels() if k[0].startswith(B_KERNELS)) / 1e6
    if pk is None or dev_s <= 0:
        return None
    st = layer["stats"]
    least = (bounds_bal.least_s(bounds_bal.eval_work(st, False), pk)
             + layer["iters"] * bounds_bal.least_s(bounds_bal.eval_work(st, True), pk))
    return 100.0 * least / dev_s
