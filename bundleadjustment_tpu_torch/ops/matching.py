"""Descriptor matching: knn-2 search with ratio test and cross-check.

Port of `bundleadjustment_tpu/ops/matching.py`. Three entry points, one
contract:

- `match_descriptors`: the reference form, which materialises the [M1, M2]
  distance matrix (the JAX package's XLA matcher), for float descriptors
  by squared L2 (the default, as in the JAX package: one matrix product,
  `l2_distance_matrix`) or for packed binary ones by Hamming distance;
- `match_descriptors_fused`: the top-2 search runs in kernel A
  (`ops/hamming.py`), the matrix never exists;
- `match_descriptors_batch`: one query set against B train sets, one
  kernel A launch with a batch axis (keyframe neighbour search).

A match is kept when best < ratio * second (second = +inf counts as the
largest float; L2 compares distances, the square roots of the squared
ones), best <= max_dist, and, with cross_check, it is the best
query for its train index; ties go to the lowest query index. Both the
per-train minimum and the tie-break are segment minima, done with
`scatter_reduce(..., "amin")`.
"""

from __future__ import annotations

import torch

from bundleadjustment_tpu_torch.ops.hamming import (
    hamming_distance_matrix,
    hamming_top2,
)

DEFAULT_RATIO = 0.7
_BIG = torch.finfo(torch.float32).max


def _filter(best, second, idx, valid_a, m2, ratio, max_dist, cross_check):
    """Ratio test, distance gate and cross-check on [B, M1] top-2 results.
    Returns (match_idx [B, M1] int32, match_dist [B, M1] float32)."""
    second = torch.where(torch.isinf(second), torch.full_like(second, _BIG),
                         second)
    ok = torch.isfinite(best) & (best < ratio * second)
    if valid_a is not None:
        ok = ok & valid_a
    if max_dist is not None:
        ok = ok & (best <= max_dist)
    idx = idx.to(torch.int64)
    if cross_check and m2 > 0:
        B, m1 = best.shape
        safe = torch.clamp(idx, min=0)
        per_train = torch.full((B, m2), _BIG, device=best.device).scatter_reduce(
            1, safe, torch.where(ok, best, torch.full_like(best, _BIG)), "amin")
        is_best = ok & (best <= per_train.gather(1, safe))
        qidx = torch.arange(m1, device=best.device).expand(B, m1)
        first_q = torch.full((B, m2), m1, dtype=torch.int64,
                             device=best.device).scatter_reduce(
            1, safe, torch.where(is_best, qidx, torch.full_like(qidx, m1)),
            "amin")
        ok = is_best & (first_q.gather(1, safe) == qidx)
    match_idx = torch.where(ok, idx, torch.full_like(idx, -1)).to(torch.int32)
    match_dist = torch.where(ok, best, torch.full_like(best, float("inf")))
    return match_idx, match_dist


def l2_distance_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """Squared L2 distances [M1, M2] of float descriptors [M1, D], [M2, D]
    as |a|^2 + |b|^2 - 2 a.b, clamped at 0; invalid rows / columns +inf."""
    a2 = torch.sum(desc_a * desc_a, -1, keepdim=True)
    b2 = torch.sum(desc_b * desc_b, -1, keepdim=True)
    d = torch.clamp(a2 + b2.T - 2.0 * (desc_a @ desc_b.T), min=0.0)
    inf = torch.full_like(d, float("inf"))
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, inf)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, inf)
    return d


def match_descriptors(desc_a, desc_b, valid_a=None, valid_b=None,
                      metric="l2", ratio=DEFAULT_RATIO, max_dist=None,
                      cross_check=True):
    """knn-2 matching through the full distance matrix.

    metric "l2": desc_a [M1, D], desc_b [M2, D] float descriptors, squared
    distances compared in their square roots (ratio, max_dist and the
    returned distance in L2 units); "hamming": [M1, 8], [M2, 8] int32
    packed descriptors. Returns (match_idx [M1] int32, match_dist [M1]
    float32).
    """
    if metric == "l2":
        d = l2_distance_matrix(desc_a, desc_b)
    elif metric == "hamming":
        d = hamming_distance_matrix(desc_a, desc_b)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    inf = torch.full_like(d, float("inf"))
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, inf)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, inf)
    if d.shape[1] == 0:
        m1 = d.shape[0]
        return (torch.full((m1,), -1, dtype=torch.int32, device=d.device),
                torch.full((m1,), float("inf"), device=d.device))
    best, idx = torch.min(d, dim=1)
    second = d.scatter(1, idx[:, None], float("inf")).min(dim=1).values
    if metric == "l2":
        best = torch.sqrt(best)
        second = torch.sqrt(torch.where(torch.isinf(second),
                                        torch.full_like(second, _BIG), second))
    mi, md = _filter(best[None], second[None], idx[None], None, d.shape[1],
                     ratio, max_dist, cross_check)
    return mi[0], md[0]


def match_descriptors_fused(desc_a, desc_b, valid_a=None, valid_b=None,
                            ratio=DEFAULT_RATIO, max_dist=None,
                            cross_check=True):
    """Same contract as `match_descriptors`, with the top-2 search in
    kernel A (`hamming_top2`)."""
    m2 = desc_b.shape[0]
    if valid_b is None:
        valid_b = torch.ones(m2, dtype=torch.bool, device=desc_b.device)
    best, second, idx = hamming_top2(desc_a[None], desc_b[None], valid_b[None])
    mi, md = _filter(best, second, idx,
                     None if valid_a is None else valid_a[None], m2, ratio,
                     max_dist, cross_check)
    return mi[0], md[0]


def match_descriptors_batch(desc_a, descs_b, valid_a=None, valids_b=None,
                            ratio=DEFAULT_RATIO, max_dist=None,
                            cross_check=True):
    """Match ONE query set [M1, 8] against a batch of train sets [B, M2, 8]
    in one kernel A launch. Returns (idx [B, M1], dist [B, M1])."""
    B, m2 = descs_b.shape[0], descs_b.shape[1]
    if valids_b is None:
        valids_b = torch.ones((B, m2), dtype=torch.bool, device=descs_b.device)
    best, second, idx = hamming_top2(desc_a[None], descs_b, valids_b)
    va = None if valid_a is None else valid_a[None].expand(B, -1)
    return _filter(best, second, idx, va, m2, ratio, max_dist, cross_check)
