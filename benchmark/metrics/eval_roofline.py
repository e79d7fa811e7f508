"""Kernel B's share of its roofline over a traced global-BA solve, in %: the
least time of its calls (`harness/bounds.eval_work`: the seed evaluation,
then one evaluation with the back-substitution an LM iteration) over the
device time of B's kernels (`csrc/dense_eval.cu`), by the profiler's
kernel names."""

from harness import bounds

B_KERNELS = ("dense_eval_units", "dense_eval_finish", "dense_eval_backsub")


def read(layer):
    if layer.get("kind") != "ba":
        return None
    pk = bounds.peaks(layer["device_name"])
    dev_s = sum(k[2] for k in layer["trace"].kernels() if k[0].startswith(B_KERNELS)) / 1e6
    if pk is None or dev_s <= 0:
        return None
    st = layer["stats"]
    least = (bounds.least_s(bounds.eval_work(st, False), pk)
             + layer["iters"] * bounds.least_s(bounds.eval_work(st, True), pk))
    return 100.0 * least / dev_s
