"""Data-parallel frame frontend: feature detection of a frame batch, the
frame axis dealt over the ranks of a torch.distributed process group.

Port of `bundleadjustment_tpu/parallel/frontend.py`, where a `shard_map`
over a 1-D device mesh detects each device's block of frames. Tracking is
sequential, but detection is not: bulk ingest (`--predetect`) detects every
frame independently. Here each rank detects its contiguous block of frames
with `ops.features.detect_batch` (one pass over the block), and one
all-gather per feature field gives every rank the whole batch, in frame
order (the blocks of ranks 0, 1, ... in turn).
"""

from __future__ import annotations

import torch

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.ops.features import (
    FeatureConfig,
    Features,
    detect_batch,
)
from bundleadjustment_tpu_torch.parallel.multihost import (
    all_gather_rows,
    group_rank_size,
)


def detect_batch_sharded(images, cfg: FeatureConfig = FeatureConfig(), group=None,
                         device="cuda"):
    """Detect features on a frame batch [B, H, W] (a numpy array or a tensor
    on any device; it is moved to `device` as float32).

    group=None: `detect_batch` of the whole batch on `device`. With a
    process group of D ranks, B is padded with zero frames to a multiple of
    D (a zero frame has no positive-response corner, so its features come
    back with valid=False everywhere), rank r detects frames [r B/D,
    (r+1) B/D) and the blocks are all-gathered; the padding is stripped.
    Returns `Features` with leading axis B on `device`.
    """
    dev = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    if group is None:
        return detect_batch(images, cfg)
    rank, size = group_rank_size(group)
    B = images.shape[0]
    per = -(-B // size)
    pad = per * size - B
    if pad:
        images = torch.cat([images, images.new_zeros((pad, *images.shape[1:]))])
    local = detect_batch(images[rank * per:(rank + 1) * per], cfg)
    fields = {}
    for k in Features.__dataclass_fields__:
        x = getattr(local, k)
        # bool as uint8: gloo gathers no bool tensors
        g = all_gather_rows(x.to(torch.uint8) if x.dtype == torch.bool else x, group)
        g = g.reshape(size * per, *x.shape[1:])[:B]
        fields[k] = g.bool() if x.dtype == torch.bool else g
    return Features(**fields)
