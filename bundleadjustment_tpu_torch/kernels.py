"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` file has a plain C interface. At first use it is compiled
with nvcc for Hopper (`sm_90a`) into its own shared library under
`bundleadjustment_tpu_torch/_build/` (listed in .gitignore) and loaded with
ctypes. Nothing is compiled or loaded at import time, so the CPU-only test
machine imports every module without nvcc.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises on a non-zero code. `LAUNCHES` counts,
per kernel, the calls in which its wrapper launched it, and under
"graph_replay" the replays of the dense solve's captured CUDA graphs
(`solvers/dense_ba.py`), whose kernels no wrapper launches;
`reset_launch_counts` and `launch_counts` let a caller show that a run went
through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false: every multiply and add rounds on its own, as in the plain
# PyTorch versions and the JAX kernels, so per-observation and per-landmark
# values match them bit for bit where the operation order is the same (the
# closed-form 3x3 inverse of an ill-conditioned point block would otherwise
# amplify the FMA round-off differences). These kernels are bound by memory
# and atomics, not by the floating-point rate.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong

# C signature of every entry point, by library: {lib: {fn: [argtypes]}}
SIGNATURES = {
    "hamming": {
        # q, q_batch_stride, t, tvalid, n_batch, m1, m2, chunk, n_chunks,
        # part, best, second, idx, stream
        "hamming_top2": [P, I64, P, P] + [I32] * 5 + [P] * 5,
    },
    "dense_eval": {
        # k4, R, t, dc, cam_t, uv_t, isig_t, valid_t, fixed_t, Xt,
        # W_prev, vinv6, gp_prev, pt_valid, O, L, K, robust, bs,
        # lanes_log2, warps, blocks, tile, n_tiles,
        # slab, red, cost, Vu, g_p, W, Xt_new, stream
        "dense_eval_assemble": [P] * 14 + [I32] * 10 + [P] * 8,
    },
    "schur_s": {
        # lam, red27, cam_fixed, Vu, g_p, pt_valid, W18, cam_t, O, L, K,
        # tile, chunks, slots, Sp, Rp, S, b, zv, vinv6, stream
        "schur_prepare_s": [P] * 8 + [I32] * 6 + [P] * 7,
        # lam, Vu, g_p, pt_valid, W18, cam_t, O, L, K, tile, chunks, slots,
        # Sp, Rp, S, red6, zv, vinv6, stream
        "schur_qqt_partial": [P] * 6 + [I32] * 6 + [P] * 7,
    },
    "schur_prepare": {
        # lam, Vu, g_p, pt_valid, W18, cam_t, O, L, K, slots, chunks,
        # warps, blocks, tile, n_tiles, slab, G, zv, vinv6, red6, stream
        "schur_prepare": [P] * 6 + [I32] * 9 + [P] * 6,
    },
    "chol_solve": {
        # S, b, N, grid, work, x, stream
        "chol_solve": [P, P, I32, I32, P, P, P],
        # out
        "chol_solve_blocks_per_sm": [ctypes.POINTER(I32)],
    },
}

# launches per kernel since the last reset (see module docstring)
LAUNCHES = {"hamming_top2": 0, "dense_eval_assemble": 0,
            "dense_eval_assemble_bs": 0, "schur_prepare_s": 0,
            "schur_qqt_partial": 0, "schur_prepare": 0, "chol_solve": 0,
            "graph_replay": 0}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts():
    return dict(LAUNCHES)


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def _so_path(name):
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _newest_source(src):
    """Latest mtime of a .cu file and the shared headers it may include."""
    heads = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return max(os.path.getmtime(f) for f in [src, *heads])


def build(name, force=False):
    """Compile csrc/<name>.cu to _build/lib<name>.so if missing or stale.
    Returns the seconds spent compiling (0.0 when up to date)."""
    src = os.path.join(CSRC, f"{name}.cu")
    out = _so_path(name)
    if (not force and os.path.exists(out)
            and os.path.getmtime(out) >= _newest_source(src)):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + f".{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all(force=False):
    """Build every kernel library, one nvcc process per source, all started
    together; returns {name: seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SIGNATURES)) as pool:
        futs = {name: pool.submit(build, name, force) for name in SIGNATURES}
        return {name: f.result() for name, f in futs.items()}


def lib(name):
    """The loaded ctypes library for csrc/<name>.cu (built on first use)."""
    with _lock:
        if name not in _libs:
            build(name)
            handle = ctypes.CDLL(_so_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = handle
        return _libs[name]


def stream_of(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


def check(code, fn):
    if code != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: cudaError {code}")


def require(cond, msg):
    if not cond:
        raise ValueError(msg)


def check_cuda(name, t, dtype, shape=None):
    """Validate a kernel argument: CUDA, dtype, contiguous, and shape."""
    require(t.is_cuda, f"{name}: expected a CUDA tensor, got {t.device}")
    require(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}")
    require(t.is_contiguous(), f"{name}: expected a contiguous tensor")
    if shape is not None:
        require(tuple(t.shape) == tuple(shape),
                f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
