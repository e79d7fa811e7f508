"""One run of one cell: the generator's set-up, window and outputs check,
then the result line's fields."""

from __future__ import annotations

import math
import subprocess
import sys
from dataclasses import dataclass
from typing import Callable


@dataclass
class Context:
    """What a generator's `run` gets: the cell, the run's arguments, the
    device ("cuda", or "cpu" where a test drives a run without the card)
    and `age()` (seconds since the process started)."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    age: Callable[[], float]

    def log(self, msg):
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)


def card_line():
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(cell, seed, seconds, trace, device, age):
    """Run `cell` once; the result line as a dict (checks last)."""
    import torch

    ctx = Context(cell, seed, seconds, trace, device, age)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        ctx.log(f"card: {card_line()}")
    out = cell.generator.run(ctx)

    checks = {name: {"value": out["checks"].get(name), "limit": limit}
              for name, limit in cell.limits.items()}
    correct = (out["attempted"] > 0 and out["failed"] == 0 and all(
        c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    metrics = {}
    if trace:
        for name, read in cell.readers().items():
            v = read(out["layer"])
            if v is not None:
                metrics[name] = v
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        metrics = {m["name"]: out["e2e"][m["name"]] for m in cell.end_to_end}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
              "device": dev}
    if trace:
        tr = out["layer"]["trace"]
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.wall_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": out["layer"]["host_trace"].idle_gaps()}
        for i, s in enumerate(out["layer"]["sessions"]):
            ctx.log(f"profiler session {i}: {s}")
    result["checks"] = checks
    return result
