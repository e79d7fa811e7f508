"""bundleadjustment_tpu_torch — the PyTorch/CUDA port of `bundleadjustment_tpu`.

The JAX package beside this one is the reference. This package mirrors its
module paths (`geometry/`, `ops/`, `solvers/`, `pipeline/`, `metrics/`,
`vis/`, `cli.py`) and re-implements the default SLAM path with PyTorch
tensors. Every Pallas kernel on that path has a hand-written CUDA C++
counterpart for Hopper in `csrc/`, built with nvcc at first use and bound
with ctypes (`kernels.py`). Beside each kernel sits a plain PyTorch version
of the same function: a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises.

This package imports torch and never jax, and nothing of the JAX package,
so it runs where that package is absent. The numpy-only modules it shares
with the JAX package are copies, each naming its source: `data/`,
`mapstate/scene.py`, the native C++ map store `native/`,
`pipeline/config.py`, `metrics/ate.py`, `geometry/np_se3.py`, `vis/mesh.py`
and `utils/profiling.py`.
"""

__version__ = "0.1.0"
