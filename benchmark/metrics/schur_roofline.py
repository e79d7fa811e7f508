"""The Schur step's share of its roofline over a traced global-BA solve, in
%: the least time to form the damped Schur system once an LM iteration
(`harness/bounds.schur_work`: every slot pair once, S written once) over
the device time of whatever kernels formed it. Those are, in each
iteration, the kernels from the first of the program's Schur kernels
(C / K5 `schur_tiles`, D `schur_prepare_units`) up to the first kernel of
the camera system's Cholesky: on route (c) that takes in Pf's
`index_add_`, the library's Q Q^T and the damped U, whatever computes
them, so a change of route is read against the same yardstick.

The Cholesky's kernels are named by the session that records the host's
ops: those launched by a host op whose name holds "cholesky". Where that
session links none of them, or the solve's windows are not one an
iteration, each closed, the reader reads nothing: a window left open
would run on to the end of the solve and read the share far too low."""

from harness import bounds

START = ("schur_tiles", "schur_prepare_units")
CHOLESKY_KERNELS = ("chol_solve_kernel",)


def read(layer):
    if layer.get("kind") != "ba":
        return None
    host = layer["host_trace"]
    chol = {k[0] for k in host.kernels() if "cholesky" in host.host.get(k[3], "")}
    pk = bounds.peaks(layer["device_name"])
    dev_us, inside, opened, closed = 0.0, False, 0, 0
    for name, _ts, dur, _ext, _cat in layer["trace"].kernels():
        if not inside and name.startswith(START):
            inside, opened = True, opened + 1
        elif inside and (name in chol or name.startswith(CHOLESKY_KERNELS)):
            inside, closed = False, closed + 1
        if inside:
            dev_us += dur
    if pk is None or dev_us <= 0 or not opened == closed == layer["iters"]:
        return None
    return 100.0 * opened * bounds.least_s(bounds.schur_work(layer["stats"]), pk) / (dev_us / 1e6)
