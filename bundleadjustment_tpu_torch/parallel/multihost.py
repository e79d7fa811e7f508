"""Process-group set-up for the port's distributed solvers.

Port of `bundleadjustment_tpu/parallel/multihost.py`: where the JAX package
initialises `jax.distributed`, the port initialises a `torch.distributed`
process group. NCCL on the card, gloo on the CPU; NCCL missing on a CUDA
run is an error, never a fall back to gloo. The rendezvous is a shared file
(`file://`), so parallel test workers need no free port. Every process calls
`init_process_group` with its own rank and the same file and world size.

`COLLECTIVES` counts the collectives the port's distributed solvers issue
(the sharded dense and flat engines, the windowed global BA), by name, and
the bytes all-reduced.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from bundleadjustment_tpu_torch.device import resolve_device


def init_process_group(rank, world_size, init_file, device="cuda"):
    """Join the default process group; returns the backend's name.

    device "cuda" (or "cuda:N") takes NCCL and sets this process's card
    ("cuda" alone: card rank % device_count); "cpu" takes gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend; the "
                               "sharded solve on the card needs it")
        index = dev.index if dev.index is not None else rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="file://" + os.path.abspath(init_file),
                            rank=rank, world_size=world_size)
    return backend


def destroy_process_group():
    """Leave the default process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def default_group():
    """The default process group when one is initialised, else None (one
    shard)."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "all_reduce_bytes": 0}


def all_reduce_hook(group):
    """The cross-shard sum (the reference's `psum`): identity for no group,
    else an in-place all_reduce(SUM) of the (freshly computed) tensor over
    `group`, counted in COLLECTIVES."""
    if group is None:
        return lambda x: x

    def reduce(x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVES["all_reduce_bytes"] += x.numel() * x.element_size()
        return x

    return reduce


def all_gather_rows(x, group):
    """Every rank's x [n, ...] stacked as [world, n, ...] (one all_gather,
    counted); x[None] without a group."""
    if group is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.stack(parts)


def group_rank_size(group):
    """(rank, world size) in `group`; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)
