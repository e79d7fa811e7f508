"""What the benchmark imports: nothing of JAX or of the JAX package
(`bundleadjustment_tpu`, its top-level name compared whole, so the port
`bundleadjustment_tpu_torch` is not it), and in `reference/` nothing of
the program either. Also the harness's refusals on a machine without a
card, and (marked `cuda`, on the card only) one short run of each cell."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX_SIDE = {"jax", "jaxlib", "flax", "bundleadjustment_tpu"}
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    for root, _dirs, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_imports_jax_or_the_jax_package():
    found = {p: top_level_imports(p) & JAX_SIDE for p in sources()}
    assert not {p: n for p, n in found.items() if n}


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        assert top_level_imports(p) <= {"__future__", "numpy", "torch"}, p


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_module_of_jax_or_the_jax_package():
    code = (f"import sys, json; sys.path[:0] = [{BENCH!r} + '/tests', {BENCH!r}, {ROOT!r}]\n"
            "from cpu_run import drive, small_cell\n"
            f"for w in {CELLS!r}: drive(small_cell(w), 7)\n"
            "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules)))")
    loaded = _modules_after(code)
    assert "bundleadjustment_tpu_torch" in loaded and not loaded & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path[:0] = [{BENCH!r}]\n"
            "import reference.global_ba\n"
            "print(json.dumps(sorted(m.split('.')[0] for m in sys.modules)))")
    assert not _modules_after(code) & (JAX_SIDE | {"bundleadjustment_tpu_torch"})


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, timeout=600,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                          "--seed", str(2**31 + 11), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and list(res)[-1] == "checks", res
    assert res["device"]["platform"] == "gpu" and res["metrics"]
