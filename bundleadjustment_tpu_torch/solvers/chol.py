"""Blocked Cholesky solve of the dense Schur camera system (kernel E).

Port of `bundleadjustment_tpu/solvers/pallas_chol.py`: `chol_solve(S, b)`
replaces `pallas_chol_solve` (one CUDA kernel, `csrc/chol_solve.cu`), and
`chol_solve_plain` is the same arithmetic step by step in plain PyTorch: a
right-looking factor over 8-row panels, the 8x8 diagonal block factored
column by column with the pivot clamp sqrt(max(d, 1e-20)), its inverse by
forward substitution on the identity, then the forward and the backward
substitution in 8-row blocks against the stored inverse diagonal factors.

Both take S [N, N] and b [N] in float32 for any N >= 1 (the reference wants
N % 8 == 0, TPU tiling; here a last panel of fewer than 8 rows is padded
with the identity) and return x [N]. S is not overwritten.

A non-positive pivot is clamped, not reported, as in the reference: an
indefinite S gives huge or non-finite values instead of the NaN that
`schur.cholesky_solve_nan` returns. The LM loop rejects such a step through
its cost test (`accept` needs a finite lower cost).

Tolerance against float64 `numpy.linalg.solve`: relative max error < 1e-5
on well-conditioned systems (the reference's own test bound); on the LM
systems it grows with cond(S) like any float32 factorisation, and kernel
and plain version then agree with each other more closely than either does
with float64.

The dense solve keeps the library call (`cholesky_solve_nan`) by default, as
the reference's `solve_fused` keeps XLA's; `dense_kernels.KERNEL_OPS_CHOL`
and `PLAIN_OPS_CHOL` put these functions in its place.
"""

from __future__ import annotations

import torch

from bundleadjustment_tpu_torch import kernels

PANEL = 8
EPS = 1e-20
# the kernel keeps the right-hand side in shared memory: N floats within the
# 224 KB one block may take next to its static 8x8 blocks (227 KB on sm_90)
MAX_N = 224 * 1024 // 4


def _chol8_inv(D):
    """Column-by-column Cholesky of an 8x8 SPD block and the inverse of the
    factor. Returns (LT [8,8] upper = L^T, Linv [8,8] lower = L^-1)."""
    cols = torch.arange(PANEL, device=D.device)
    rows = []
    R = D
    for c in range(PANEL):
        r = R[c] / torch.sqrt(torch.clamp(R[c, c], min=EPS))
        r = torch.where(cols >= c, r, torch.zeros_like(r))
        rows.append(r)
        R = R - r[:, None] * r[None, :]
    LT = torch.stack(rows)
    eye = torch.eye(PANEL, dtype=D.dtype, device=D.device)
    xrows = []
    for c in range(PANEL):
        acc = eye[c]
        for k in range(c):
            acc = acc - LT[k, c] * xrows[k]
        xrows.append(acc / torch.clamp(LT[c, c], min=EPS))
    return LT, torch.stack(xrows)


def chol_solve_plain(S, b):
    """Plain version of kernel E: x with S x = b, S [N,N] SPD, b [N]."""
    N = S.shape[0]
    nb = (N + PANEL - 1) // PANEL
    Np = nb * PANEL
    R = torch.eye(Np, dtype=S.dtype, device=S.device)
    R[:N, :N] = S
    vec = torch.zeros(Np, dtype=S.dtype, device=S.device)
    vec[:N] = b
    panels, inverses = [], []
    for j in range(nb):
        p, q = j * PANEL, (j + 1) * PANEL
        _, Linv = _chol8_inv(R[p:q, p:q])
        A = Linv @ R[p:q, q:]  # [8, Np - q]: the panel of L^T
        R[q:, q:] -= A.T @ A
        y = Linv @ vec[p:q]
        vec[p:q] = y
        vec[q:] -= y @ A
        panels.append(A)
        inverses.append(Linv)
    for j in range(nb - 1, -1, -1):
        p, q = j * PANEL, (j + 1) * PANEL
        t = panels[j] @ vec[q:]
        vec[p:q] = inverses[j].T @ (vec[p:q] - t)
    return vec[:N].clone()


def chol_solve(S, b):
    """Kernel E: x [N] with S x = b for S [N,N] symmetric positive definite
    and b [N], float32, any N from 1 to MAX_N (the right-hand side lives in
    the block's shared memory). CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if not S.is_cuda:
        return chol_solve_plain(S, b)
    N = S.shape[0]
    f32 = torch.float32
    kernels.check_cuda("S", S, f32, (N, N))
    kernels.check_cuda("b", b, f32, (N,))
    kernels.require(N >= 1, "chol_solve: empty system")
    kernels.require(N <= MAX_N, f"chol_solve: N = {N} exceeds {MAX_N}")
    nb = (N + PANEL - 1) // PANEL
    work = torch.empty(N * N + nb * PANEL * PANEL, dtype=f32, device=S.device)
    x = torch.empty((N,), dtype=f32, device=S.device)
    code = kernels.lib("chol_solve").chol_solve(
        S.data_ptr(), b.data_ptr(), N, work.data_ptr(), x.data_ptr(),
        kernels.stream_of(S))
    kernels.check(code, "chol_solve")
    kernels.LAUNCHES["chol_solve"] += 1
    return x
