"""Landmark-sharded dense-layout BA over torch.distributed.

Port of `bundleadjustment_tpu/parallel/sharded_dense_ba.py`. The [L, O]
landmark blocks are split round-robin across the ranks of a process group;
every point-side quantity stays on its rank, and the camera-side terms (the
cost, the per-camera rows, the Schur partial Q Q^T and its rhs rows) are
summed over the group with `all_reduce`, the counterpart of the reference's
`lax.psum` inside `shard_map`. Camera state is replicated: every rank
solves the same all-reduced Schur system and takes the same step.

Where the reference stacks all shards as [D, Ls, ...] arrays for one
program over a mesh, each rank here holds only its own [Ls, ...] slice.
With no group nothing is communicated, and the solve still takes the
sharded engine's Schur route (K5, or kernel D for O > 64): the reference's
1-device mesh. A group of one runs every collective, as a larger one does.
`COLLECTIVES` (`multihost.py`) counts the collectives issued. With PCG
each matvec all-reduces its [K, 6] back-projection.
"""

from __future__ import annotations

import numpy as np
import torch

from bundleadjustment_tpu_torch.parallel.multihost import (  # noqa: F401
    COLLECTIVES,  # re-exported: the counter the smoke and tests read here
    all_gather_rows,
    all_reduce_hook,
)
from bundleadjustment_tpu_torch.solvers.dense_ba import (
    dense_ba_solve,
    densify_numpy,
    to_problem,
)
from bundleadjustment_tpu_torch.solvers.lm import LMConfig


def shard_dense_problem(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
                        points, n_shards, rank=0, max_obs=16, device="cuda"):
    """This rank's slice of a round-robin landmark partition of a flat
    observation table: landmark l goes to shard l % n_shards at local index
    l // n_shards, padded to Ls = ceil(L / n_shards) with invalid landmarks.

    Returns (DenseBAProblem [Ls, O] on `device`, points_shard [Ls, 3],
    shard_of [L], local_of [L]); O is the same on every rank."""
    L = np.asarray(points).shape[0]
    arrays, _dropped = densify_numpy(K4, cam_idx, pt_idx, uv, sigma2, valid,
                                     cam_fixed, L, max_obs=max_obs)
    shard_of = np.arange(L) % n_shards
    local_of = np.arange(L) // n_shards
    Ls = (L + n_shards - 1) // n_shards
    mine = np.flatnonzero(shard_of == rank)

    def take(arr, fill=0):
        arr = np.asarray(arr)
        out = np.full((Ls,) + arr.shape[1:], fill, arr.dtype)
        out[local_of[mine]] = arr[mine]
        return out

    local = dict(K4=arrays["K4"], cam_idx=take(arrays["cam_idx"]),
                 uv=take(arrays["uv"]), sigma2=take(arrays["sigma2"], 1),
                 valid=take(arrays["valid"], False),
                 cam_fixed=arrays["cam_fixed"],
                 pt_valid=take(arrays["pt_valid"], False))
    prob = to_problem(local, device)
    pts = torch.from_numpy(take(np.asarray(points, np.float32))).to(prob.K4.device)
    return prob, pts, shard_of, local_of


def sharded_dense_ba_solve(prob, cams_rt6, points_shard, config=None,
                           group=None):
    """Landmark-sharded dense LM solve of this rank's shard.

    prob / points_shard: this rank's slice (`shard_dense_problem`);
    cams_rt6 [K, 6] replicated. Every rank of `group` calls it with the same
    cameras and config; None is the reference's default, PCG
    (`LMConfig(max_iters=10, solver="pcg")`). Returns (cam_rt6'
    replicated, points_shard', info)."""
    if config is None:
        config = LMConfig(max_iters=10, solver="pcg")
    return dense_ba_solve(prob, cams_rt6, points_shard, config,
                          reduce=all_reduce_hook(group))


def gather_points(points_shard, shard_of, local_of, group=None):
    """Every rank's solved points_shard [Ls, 3] back in the flat landmark
    order: numpy [L, 3] on every rank."""
    return all_gather_rows(points_shard, group).cpu().numpy()[shard_of, local_of]
