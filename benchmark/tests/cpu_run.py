"""Drive a cell's run on the CPU: the harness's look for a card skipped,
everything else as `run.py` does it, with the program's plain PyTorch
versions in place of its CUDA kernels, at a size a test run holds."""

from __future__ import annotations

import copy
import time

from harness.cell import Cell
from harness.run_cell import run_cell

# a keyframe map of the track-scene generator at a size the CPU solves in
# about a second
SMALL_MAP = {"n_keyframes": 8, "n_landmarks": 300, "n_observations": 1200,
             "n_seen_by_all": 20, "max_track": None}


def small_cell(workload, **traffic):
    cell = Cell(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["map"].update(SMALL_MAP)
    cell.traffic = {**cell.traffic, "warmup_solves": 0, **traffic}
    return cell


def drive(cell, seed, seconds=0.0):
    t0 = time.perf_counter()
    return run_cell(cell, seed, seconds, False, "cpu", lambda: time.perf_counter() - t0)
