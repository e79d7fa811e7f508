#!/usr/bin/env python3
"""Kernel E (the blocked Cholesky solve) against the library call on one
NVIDIA GPU.

    python3 profile_chol.py [--sizes 48 384 426 768 3600] [--phases]

For each N: S = A A^T + N I and b from a seeded generator (the kernel's work
does not depend on the values), then, in turns, the library call
(`cholesky_ex` + `cholesky_solve`), kernel E twice, and the library
call again. Each entry is the device milliseconds per call (chip_smoke's
`device_time`: torch.profiler kernel durations, or CUDA events where the
profiler delivers no kernel records) and the CUDA-event milliseconds per
back-to-back call. One JSON object per N, after a line with the card's
name and power limit as nvidia-smi gives them. Needs one CUDA device.

With --phases, kernel E is built again with -DCHOL_PHASES (block 0 reads
its SM's clock at the end of every phase) and launched once per N after two
warm-up launches; each object then gives block 0's clock cycles per phase,
summed over the panels: "factor" (the diagonal block), "panel_row" (the
panel row of L^T), "update" (the trailing tiles), "back_x" and "back_rows"
(the backward substitution), "copy", and each "*_wait", the grid barrier
after a phase, which also holds the wait for the slowest block. The clock
reads add a few instructions per phase, so the sum is close to but not the
kernel's own time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# the Phase enum of csrc/chol_solve.cu, by value
PHASES = ("start", "copy", "factor", "panel_row", "panel_row_wait", "update",
          "update_wait", "back_x", "back_rows", "back_wait")


def phase_library():
    """csrc/chol_solve.cu built with its phase clock, loaded with ctypes."""
    from bundleadjustment_tpu_torch import kernels

    out = os.path.join(kernels.BUILD_DIR, "libchol_solve_phases.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DCHOL_PHASES", "-o", out,
                    os.path.join(kernels.CSRC, "chol_solve.cu")], check=True)
    lib = ctypes.CDLL(out)
    P = ctypes.c_void_p
    for fn, argtypes in (*kernels.SIGNATURES["chol_solve"].items(),
                         ("chol_solve_phases", [P, P])):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def phase_cycles(lib, S, b):
    """Block 0's clock cycles per phase of one launch of kernel E."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch import kernels
    from bundleadjustment_tpu_torch.solvers import chol

    N = S.shape[0]
    bps = ctypes.c_int(0)
    kernels.check(lib.chol_solve_blocks_per_sm(ctypes.byref(bps)), "occupancy")
    sms = torch.cuda.get_device_properties(S.device).multi_processor_count
    plan = chol.launch_plan(N, sms, bps.value)
    work = torch.empty(plan["scratch_floats"], device=S.device)
    x = torch.empty(N, device=S.device)
    stamps = np.zeros((2, 16384), np.uint64)
    n = ctypes.c_uint(0)
    for _ in range(3):  # two to warm up; the stamps of the third are read
        kernels.check(lib.chol_solve_phases(stamps.ctypes.data, ctypes.byref(n)), "phases")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        kernels.check(lib.chol_solve(S.data_ptr(), b.data_ptr(), N, plan["grid"],
                                     work.data_ptr(), x.data_ptr(),
                                     kernels.stream_of(S)), "chol_solve")
        end.record()
        torch.cuda.synchronize()
    kernels.check(lib.chol_solve_phases(stamps.ctypes.data, ctypes.byref(n)), "phases")
    codes, clock = stamps[0, :n.value], stamps[1, :n.value].astype(np.int64)
    cycles = {}
    for i in range(1, len(codes)):
        name = PHASES[int(codes[i])]
        cycles[name] = cycles.get(name, 0) + int(clock[i] - clock[i - 1])
    total = int(clock[-1] - clock[0])
    return {"N": N, "grid": plan["grid"], "event_ms": start.elapsed_time(end),
            "cycles_total": total, "cycles": cycles,
            "share": {k: v / total for k, v in cycles.items()}}


def main(argv=None):
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[48, 384, 426, 768, 3600])
    ap.add_argument("--phases", action="store_true",
                    help="cycles per phase of an instrumented build instead of times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_chol: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from chip_smoke import cuda_time, device_time
    from bundleadjustment_tpu_torch.solvers import chol
    from bundleadjustment_tpu_torch.solvers.schur import cholesky_solve_nan

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    lib = phase_library() if args.phases else None
    for N in args.sizes:
        rng = np.random.default_rng(N)
        A = rng.standard_normal((N, N)).astype(np.float32)
        S = torch.from_numpy(A @ A.T + N * np.eye(N, dtype=np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
        if lib is not None:
            print(json.dumps(phase_cycles(lib, S, b)), flush=True)
            continue
        calls = {"library": lambda: cholesky_solve_nan(S, b),
                 "kernel_e": lambda: chol.chol_solve(S, b)}
        turns = ["library", "kernel_e", "kernel_e", "library"]
        out = {k: {"ms": [], "call_ms": []} for k in calls}
        for k in turns:
            ms, _ = device_time(calls[k], kernel=None if k == "library" else "chol_solve_kernel")
            out[k]["ms"].append(ms)
            out[k]["call_ms"].append(cuda_time(calls[k]))
        print(json.dumps({"N": N, "turns": turns, **out,
                          "plan": chol.card_plan(N, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
