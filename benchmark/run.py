"""Run one cell of the benchmark of `bundleadjustment_tpu_torch` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards: make the
cell's inputs from the seed, load and warm up (set-up), measure for
`--seconds`, check the outputs of the timed path against the plain
reference in `benchmark/reference/`, and print one JSON line last on
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics), `device`,
with `--trace 1` `breakdown`, and last `checks`, each number compared with
its limit (also printed last on standard error).

Exits with a code other than 0, and prints no result, where CUDA is
unavailable or has fewer cards than the cell asks for, where the program is
missing, or where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_IMPORT = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "bundleadjustment_tpu")


def process_age_s():
    """Seconds since this process started (the kernel's start time in
    /proc), or since this module was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def fail(msg, code=2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from harness.cell import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} visible")
    from harness.run_cell import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      process_age_s)
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}")
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
