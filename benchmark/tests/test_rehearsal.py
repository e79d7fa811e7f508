"""The rehearsal of the global-BA cells' outputs check on the CPU, at each
cell's own map size, over 12 seeds: the program's CPU path (its plain
PyTorch versions of the kernels) has to pass the cell's limits on every
seed, and the control (the reference in TF32, `tests/readings.py`) has to
fail them on the first three. The room0 map's 100 LM iterations take about
5 minutes a seed on a CPU, so there the program runs 30 (it has converged
by then: the cost stops falling within 12); the fr1/xyz map runs the
cell's 100. About 40 minutes in all on 8 cores; `-n 3` runs it in three
workers.
"""

from __future__ import annotations

import pytest
from readings import readings

from harness.cell import Cell

SEEDS = [2**31 + 17 * k for k in range(12)]
CPU_ITERS = {"tum_fr1_xyz.global_ba": None, "replica_room0.global_ba": 30}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", sorted(CPU_ITERS))
def test_rehearsal(workload, seed):
    limits = Cell(workload).limits
    row = next(readings(workload, [seed], "cpu", control=seed in SEEDS[:3],
                        max_iters=CPU_ITERS[workload]))
    print(row)
    assert all(row["program"][k] <= lim for k, lim in limits.items()), row
    if "control" in row:
        assert any(row["control"][k] > lim for k, lim in limits.items()), row
