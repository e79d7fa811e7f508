"""Find a cell's pieces by the names in BENCHMARK.json.

Every piece is a file of its own under `benchmark/`, so that a later change
adds a configuration, a traffic mix, a metric or a cell's limits by adding
files and entries, and edits none:

- configuration `<c>`: `configs/<c>.json`, the file `BENCHMARK.json` names;
- traffic mix `<t>`: `traffic/<t>.json`, whose "generator" names a module
  `generators/<generator>.py` with a `run(ctx)`;
- per-layer metric `<m>`: `metrics/<m>.py` with a `read(ctx)` that returns
  a number or None (nothing to read in this cell);
- a cell `<w>`'s limits of the outputs check: `limits/<w>.json`.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of `workloads` with its configuration, traffic, limits,
    generator and the metrics it reports."""

    def __init__(self, workload, bench_path=None):
        bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
        self.name = workload
        self.entry = cells[workload]
        self.chips = int(self.entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config = load_json(os.path.join(ROOT, conf["file"]))
        self.traffic = load_json(os.path.join(HERE, "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
        self.generator = load_module(
            os.path.join(HERE, "generators", self.traffic["generator"] + ".py"),
            "benchmark_generator_" + self.traffic["generator"])
        mine = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def readers(self):
        """{metric name: read function} of the cell's per-layer metrics."""
        return {m["name"]: load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                                       "benchmark_metric_" + m["name"].replace(".", "_")).read
                for m in self.per_layer}
