"""Hamming top-2 search: kernel A and its plain PyTorch version.

Port of `bundleadjustment_tpu/ops/pallas_matching.py:hamming_top2_pallas`.
Descriptors are 256-bit, packed as 8 words per row and held as int32 tensors
(the bit patterns of the reference's uint32 words).

`hamming_top2` dispatches on the tensors' device only: CPU tensors take
`hamming_top2_plain`, CUDA tensors launch the kernel in `csrc/hamming.cu` (or
raise), cut into train chunks by the host plan `hamming_plan`;
`hamming_top2_plain(..., plan=)` merges the same pieces on the CPU. Both
return (best f32, second f32, idx i32) with a leading batch axis
`[B, M1]`, bit-identical to the Pallas kernel: lowest train index among tied
minima, `second` may equal `best`, and idx = -1 / best = second = +inf when no
train row is valid.
"""

from __future__ import annotations

import torch

from collections import namedtuple

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


# Kernel A's blocking (csrc/hamming.cu): warps a block, queries a lane, the
# most train rows a block stages, and the fewest a chunk takes when the
# train axis is split to fill the card.
HAM_WARPS = 4
HAM_QPT = 2
HAM_CHUNK_MAX = 1024
HAM_CHUNK_MIN = 64

HammingPlan = namedtuple("HammingPlan", "q_tile q_tiles chunk n_chunks blocks "
                         "scratch_bytes")


def hamming_plan(B, M1, M2, n_sm):
    """Kernel A's launch plan: query tiles of 32 HAM_QPT queries; the train
    rows in n_chunks chunks of `chunk` <= HAM_CHUNK_MAX rows, as many as
    give about two blocks an SM (q_tiles B n_chunks >= 2 n_sm) while a
    chunk keeps HAM_CHUNK_MIN rows; the four warps of a block take four
    consecutive quarters of its chunk. scratch_bytes: the chunks' top-2
    planes, when there are several chunks."""
    q_tile = 32 * HAM_QPT
    q_tiles = -(-M1 // q_tile)
    base = max(1, q_tiles * B)
    n_chunks = max(1, -(-M2 // HAM_CHUNK_MAX),
                   min(-(-2 * n_sm // base), -(-M2 // HAM_CHUNK_MIN)))
    chunk = max(1, -(-M2 // n_chunks))
    n_chunks = max(1, -(-M2 // chunk))
    return HammingPlan(q_tile, q_tiles, chunk, n_chunks, q_tiles * n_chunks * B,
                       12 * B * n_chunks * M1 if n_chunks > 1 else 0)


def hamming_pieces(M2, plan):
    """The train ranges [a, e) in the kernel's merge order: each chunk's
    warp quarters, chunk by chunk (a quarter may be empty)."""
    out = []
    for c in range(plan.n_chunks):
        r0 = c * plan.chunk
        n = max(0, min(plan.chunk, M2 - r0))
        sub = -(-n // HAM_WARPS)
        for w in range(HAM_WARPS):
            a = r0 + min(n, w * sub)
            out.append((a, r0 + min(n, (w + 1) * sub)))
    return out


def merge_top2(run, piece, offset):
    """Fold the top-2 of a later train range (its indices from `offset`)
    into the running one: its best replaces the running best only if
    strictly smaller, and second is the smaller of the loser's best and
    the winner's second."""
    b1, s1, i1 = run
    b2, s2, i2 = piece
    i2 = torch.where(i2 >= 0, i2 + offset, i2)
    lt = b2 < b1
    return (torch.where(lt, b2, b1),
            torch.where(lt, torch.minimum(b1, s2), torch.minimum(s1, b2)),
            torch.where(lt, i2, i1))


def hamming_top2_plain(q, t, tvalid, plan=None):
    """Plain version. q [B or 1, M1, 8] int32; t [B, M2, 8] int32;
    tvalid [B, M2] bool. Returns (best [B,M1], second [B,M1], idx [B,M1]).
    With a `plan` (hamming_plan) each of the kernel's train pieces gets its
    own top-2, merged in the kernel's order (`merge_top2`); the result is
    the same bits."""
    if plan is not None:
        run = _top2_empty(q, t)
        for a, e in hamming_pieces(t.shape[1], plan):
            if e > a:
                run = merge_top2(run, hamming_top2_plain(q, t[:, a:e], tvalid[:, a:e]), a)
        return run
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
    kernels.require(q.data_ptr() % 16 == 0 and t.data_ptr() % 16 == 0,
                    "hamming_top2: q and t must be 16-byte aligned")
    plan = hamming_plan(B, M1, M2, torch.cuda.get_device_properties(q.device)
                        .multi_processor_count)
    best = torch.empty((B, M1), dtype=torch.float32, device=q.device)
    second = torch.empty_like(best)
    idx = torch.empty((B, M1), dtype=torch.int32, device=q.device)
    part = (torch.empty((plan.scratch_bytes // 4,), dtype=torch.int32, device=q.device)
            if plan.scratch_bytes else None)
    q_bstride = 0 if q.shape[0] == 1 else M1 * WORDS
    code = kernels.lib("hamming").hamming_top2(
        q.data_ptr(), q_bstride, t.data_ptr(), tvalid.data_ptr(), B, M1, M2,
        plan.chunk, plan.n_chunks, None if part is None else part.data_ptr(),
        best.data_ptr(), second.data_ptr(), idx.data_ptr(), kernels.stream_of(q))
    kernels.check(code, "hamming_top2")
    if M1:
        kernels.LAUNCHES["hamming_top2"] += 1
    return best, second, idx
