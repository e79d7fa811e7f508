"""Hamming top-2 search: kernel A and its plain PyTorch version.

Port of `bundleadjustment_tpu/ops/pallas_matching.py:hamming_top2_pallas`.
Descriptors are 256-bit, packed as 8 words per row and held as int32 tensors
(the bit patterns of the reference's uint32 words).

`hamming_top2` dispatches on the tensors' device only: CPU tensors take
`hamming_top2_plain`, CUDA tensors launch the kernel in `csrc/hamming.cu` (or
raise). Both return (best f32, second f32, idx i32) with a leading batch axis
`[B, M1]`, bit-identical to the Pallas kernel: lowest train index among tied
minima, `second` may equal `best`, and idx = -1 / best = second = +inf when no
train row is valid.
"""

from __future__ import annotations

import torch

from bundleadjustment_tpu_torch import kernels

WORDS = 8
_SHIFTS = torch.arange(32, dtype=torch.int64)


def unpack_bits(desc):
    """[..., 8] int32 packed descriptors -> [..., 256] float32 bits (0/1),
    word-major, bit i of word w at column 32 w + i."""
    w = desc.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> _SHIFTS.to(desc.device)) & 1
    return bits.reshape(desc.shape[:-1] + (32 * WORDS,)).to(torch.float32)


def hamming_distance_matrix(desc_a, desc_b):
    """Exact Hamming distances [..., M1, M2] as float32.

    |a xor b| = |a| + |b| - 2 a.b on 0/1 bit vectors: one float32 matrix
    product whose integer values (<= 256) are exact in any summation order.
    """
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    na = a.sum(-1, keepdim=True)
    nb = b.sum(-1)[..., None, :]
    return na + nb - 2.0 * (a @ b.transpose(-1, -2))


def hamming_top2_plain(q, t, tvalid):
    """Plain version. q [B or 1, M1, 8] int32; t [B, M2, 8] int32;
    tvalid [B, M2] bool. Returns (best [B,M1], second [B,M1], idx [B,M1])."""
    B = t.shape[0]
    best, second, idx = [], [], []
    for b in range(B):  # one [M1, M2] matrix at a time bounds the memory
        d = hamming_distance_matrix(q[min(b, q.shape[0] - 1)], t[b])
        d = torch.where(tvalid[b][None, :], d, torch.full_like(d, float("inf")))
        bv, bi = torch.min(d, dim=1)  # first index of the minimum
        masked = d.scatter(1, bi[:, None], float("inf"))
        sv = masked.min(dim=1).values if d.shape[1] else bv
        bi = torch.where(torch.isinf(bv), torch.full_like(bi, -1), bi)
        best.append(bv)
        second.append(sv)
        idx.append(bi.to(torch.int32))
    return torch.stack(best), torch.stack(second), torch.stack(idx)


def _top2_empty(q, t):
    B, M1 = t.shape[0], q.shape[1]
    inf = torch.full((B, M1), float("inf"), device=q.device)
    return inf, inf.clone(), torch.full((B, M1), -1, dtype=torch.int32,
                                        device=q.device)


def hamming_top2(q, t, tvalid):
    """Top-2 Hamming search of q against each of the B train sets in t.

    q [1 or B, M1, 8] int32 (a single query set is shared across the batch);
    t [B, M2, 8] int32; tvalid [B, M2] bool.
    """
    kernels.require(q.dim() == 3 and t.dim() == 3 and q.shape[-1] == WORDS
                    and t.shape[-1] == WORDS, "hamming_top2: [B, M, 8] inputs")
    kernels.require(q.shape[0] in (1, t.shape[0]), "hamming_top2: batch mismatch")
    if t.shape[1] == 0:
        return _top2_empty(q, t)
    if not q.is_cuda:
        return hamming_top2_plain(q, t, tvalid)
    B, M1, M2 = t.shape[0], q.shape[1], t.shape[1]
    kernels.check_cuda("q", q, torch.int32)
    kernels.check_cuda("t", t, torch.int32, (B, M2, WORDS))
    kernels.check_cuda("tvalid", tvalid, torch.bool, (B, M2))
    best = torch.empty((B, M1), dtype=torch.float32, device=q.device)
    second = torch.empty_like(best)
    idx = torch.empty((B, M1), dtype=torch.int32, device=q.device)
    q_bstride = 0 if q.shape[0] == 1 else M1 * WORDS
    code = kernels.lib("hamming").hamming_top2(
        q.data_ptr(), q_bstride, t.data_ptr(), tvalid.data_ptr(), B, M1, M2,
        best.data_ptr(), second.data_ptr(), idx.data_ptr(),
        kernels.stream_of(q))
    kernels.check(code, "hamming_top2")
    if M1:
        kernels.LAUNCHES["hamming_top2"] += 1
    return best, second, idx
