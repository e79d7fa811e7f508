"""The Schur step's share of its roofline at a camera width of 9 over a
traced global-BA solve of a cell with BAL's camera, in %: the least time to
form the damped Schur system once an LM iteration
(`harness/bounds_bal.schur_work`: every slot pair once, S written once)
over the device time of the kernels from the first of the program's Schur
kernels (C's `schur_tiles`) up to the first kernel of the camera system's
Cholesky, in each iteration, as `schur_roofline.py` closes its windows:
the Cholesky's kernels are those that the session with the host's ops
links to a host op whose name holds "cholesky" (or kernel E's). Nothing is
read where those windows are not one an iteration, each closed, nor in a
cell whose cameras are not 9 wide."""

from harness import bounds_bal

START = ("schur_tiles", "schur_prepare_units")
CHOLESKY_KERNELS = ("chol_solve_kernel",)


def read(layer):
    if layer.get("kind") != "ba" or layer.get("camera_width") != 9:
        return None
    host = layer["host_trace"]
    chol = {k[0] for k in host.kernels() if "cholesky" in host.host.get(k[3], "")}
    pk = bounds_bal.peaks(layer["device_name"])
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
    return (100.0 * opened * bounds_bal.least_s(bounds_bal.schur_work(layer["stats"]), pk)
            / (dev_us / 1e6))
