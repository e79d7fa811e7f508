"""Process-group set-up for the port's distributed solvers.

Port of `bundleadjustment_tpu/parallel/multihost.py`: where the JAX package
initialises `jax.distributed`, the port initialises a `torch.distributed`
process group. NCCL on the card, gloo on the CPU; NCCL missing on a CUDA
run is an error, never a fall back to gloo. The rendezvous is a shared file
(`file://`), so parallel test workers need no free port. Every process calls
`init_process_group` with its own rank and the same file and world size.
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
