"""The port runs where jax and the JAX package are absent: importing its
modules adds no jax module and no module of `bundleadjustment_tpu`, and no
file of the port (nor chip_smoke.py, profile_port.py, profile_chol.py, the
tools or the card-only tests) imports either."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "bundleadjustment_tpu_torch")

_PROBE = """
import sys
def loaded():
    return {m for m in sys.modules if m.split(".")[0] in ("jax", "bundleadjustment_tpu")}
before = loaded()
import bundleadjustment_tpu_torch.cli
import bundleadjustment_tpu_torch.pipeline.driver
import bundleadjustment_tpu_torch.interop
import bundleadjustment_tpu_torch.solvers.dense_kernels
import bundleadjustment_tpu_torch.solvers.chol
import bundleadjustment_tpu_torch.geometry.epipolar
import bundleadjustment_tpu_torch.parallel.sharded_dense_ba
import bundleadjustment_tpu_torch.parallel.multihost
import bundleadjustment_tpu_torch.parallel.sharded_ba
import bundleadjustment_tpu_torch.parallel.scaling
import bundleadjustment_tpu_torch.parallel.posegraph
import bundleadjustment_tpu_torch.parallel.windows
import bundleadjustment_tpu_torch.data.track_scene
import bundleadjustment_tpu_torch.data.synthetic
import bundleadjustment_tpu_torch.data.replica
import bundleadjustment_tpu_torch.mapstate.scene
import bundleadjustment_tpu_torch.metrics.ate
import bundleadjustment_tpu_torch.metrics
import bundleadjustment_tpu_torch.metrics.reconstruction
import bundleadjustment_tpu_torch.pipeline.checkpoint
import bundleadjustment_tpu_torch.parallel
import bundleadjustment_tpu_torch.parallel.frontend
import bundleadjustment_tpu_torch.geometry.projection
import bundleadjustment_tpu_torch.vis
import bundleadjustment_tpu_torch.vis.pointcloud
import bundleadjustment_tpu_torch.vis.poisson
import bundleadjustment_tpu_torch.vis.live
import bundleadjustment_tpu_torch.vis.debug
import bundleadjustment_tpu_torch.bench.protocols
import bundleadjustment_tpu_torch.bench.solve
import bundleadjustment_tpu_torch.bench.frontend
import bundleadjustment_tpu_torch.ops.features
import bundleadjustment_tpu_torch.ops.hamming
import bundleadjustment_tpu_torch.ops.matching
import bundleadjustment_tpu_torch.geometry.se3
import bundleadjustment_tpu_torch.solvers.lm
import bundleadjustment_tpu_torch.utils.flops
import bundleadjustment_tpu_torch.utils.marginal
import bundleadjustment_tpu_torch.utils.timing
import chip_smoke
import profile_port
import profile_chol
print(sorted(loaded() - before))
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def _port_files():
    files = [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "profile_port.py", "profile_chol.py", "tests/test_torch_cuda.py",
        "tests/torch_port_helpers.py", "tools/trace_two_view.py",
        "tools/parent_kernels.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_port_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    files = _port_files()
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert len(files) > 20 and not offenders, offenders


def test_no_port_file_imports_the_jax_package():
    """Lazy imports inside functions (chip_smoke's phases) count too."""
    pattern = re.compile(r"^\s*(import|from)\s+bundleadjustment_tpu(\.|\s|$)", re.M)
    files = _port_files()
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert len(files) > 20 and not offenders, offenders
