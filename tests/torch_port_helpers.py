"""Shared helpers of the PyTorch/CUDA port's parity tests (tests/test_torch_*).

The card check runs inside a fixture, never at import time, so every test
worker collects the same tests.
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from bundleadjustment_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def as_tensor(a, device="cpu"):
    """numpy / JAX array -> tensor (uint32 descriptor words keep their bits)."""
    from bundleadjustment_tpu_torch.interop import to_tensor

    return to_tensor(a, device)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_close(got, ref, rtol=2e-4, atol=2e-3, scale=1.0):
    np.testing.assert_allclose(_np(got) / scale, _np(ref) / scale, rtol=rtol,
                               atol=atol)


def block_scale(name, ref):
    """Magnitude of each block of a kernel B / C output, broadcastable against
    `ref`: red [K,27] has one for its 21 upper-U columns and one for its 6
    g_c columns; Vu [6,L], g_p [3,L] and W [6,3,O,L] one per row; S and b
    their own max. A block that sums with cancellation is held to its own
    magnitude, so a small block (g_c near convergence, b) is not excused by
    a large one (U, S)."""
    a = np.abs(_np(ref).astype(np.float64))
    if name == "red":
        s = np.concatenate([np.full(21, a[:, :21].max()),
                            np.full(a.shape[1] - 21, a[:, 21:].max())])[None]
    elif name in ("Vu", "g_p"):
        s = a.max(axis=1, keepdims=True)
    elif name == "W":
        s = a.reshape(18, -1).max(axis=1).reshape(6, 3, 1, 1)
    else:
        s = np.asarray(a.max())
    return np.where(s > 0, s, 1.0)


def assert_blocks_close(name, got, ref, rtol=2e-4, atol=2e-3):
    """assert_close with the tolerance of each block of `ref` scaled by that
    block's magnitude (see block_scale)."""
    assert_close(got, ref, rtol=rtol, atol=atol, scale=block_scale(name, ref))


def sharded_solve_rank(rank, world_size, init_file, scene, cam_fixed, n_iters,
                       out_dir):
    """One gloo rank of the port's sharded dense solve on the CPU (the
    target of torch.multiprocessing.spawn): shards `scene` (a dict of the
    numpy fields of a SyntheticScene) round-robin over
    `world_size` ranks, solves with `n_iters` LM iterations and writes this
    rank's cameras, gathered points and costs to out_dir/rank<r>.npz."""
    import os

    from bundleadjustment_tpu_torch.parallel import multihost
    from bundleadjustment_tpu_torch.parallel.sharded_dense_ba import (
        gather_points,
        shard_dense_problem,
        sharded_dense_ba_solve,
    )
    from bundleadjustment_tpu_torch.solvers.lm import LMConfig

    multihost.init_process_group(rank, world_size, init_file, device="cpu")
    try:
        prob, pts, shard_of, local_of = shard_dense_problem(
            scene["K4"], scene["cam_idx"], scene["pt_idx"], scene["uv"],
            scene["sigma2"], scene["valid"], cam_fixed, scene["points_init"],
            world_size, rank, device="cpu")
        group = multihost.default_group()
        cams, pts, info = sharded_dense_ba_solve(
            prob, torch.from_numpy(scene["extr_init"]), pts,
            LMConfig(max_iters=n_iters), group)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), cams=cams.numpy(),
                 points=gather_points(pts, shard_of, local_of, group),
                 cost0=float(info["cost0"]), cost=float(info["cost"]))
    finally:
        multihost.destroy_process_group()
