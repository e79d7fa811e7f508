"""Blocked Cholesky solve of the dense Schur camera system (kernel E).

Port of `bundleadjustment_tpu/solvers/pallas_chol.py`: `chol_solve(S, b)`
replaces `pallas_chol_solve` (one CUDA kernel, `csrc/chol_solve.cu`,
launched cooperatively over many blocks), and `chol_solve_plain` is the
same arithmetic step by step in plain PyTorch: a right-looking factor over
P-row panels, the PxP diagonal block factored column by column with the
pivot clamp sqrt(max(d, 1e-20)), its inverse by forward substitution on the
identity, then the forward and the backward substitution in P-row blocks
against the stored inverse diagonal factors. The plain version's P defaults
to the reference's 8; the kernel's is `PANEL_E` (32), and
`chol_solve_plain(S, b, panel=PANEL_E)` has the kernel's blocking.

Both take S [N, N] and b [N] in float32 (the kernel for N from 1 to MAX_N,
the plain version for any N >= 1; the reference wants N % 8 == 0, TPU
tiling; here a last panel of fewer than P rows is padded with the identity)
and return x [N]. S is not overwritten. The kernel's
scratch is [S | b] with rows padded to 4 floats and the inverse diagonal
factors, N ld + P^2 ceil(N / P) floats; `launch_plan` sizes it and the grid.

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

import ctypes

import torch

from bundleadjustment_tpu_torch import kernels

PANEL = 8  # the reference's panel: the plain version's default
PANEL_E = 32  # kernel E's panel
TILE = 64  # kernel E's trailing-update tile (TILE x TILE outputs a block)
EPS = 1e-20
# the kernel indexes the N x N input with 32-bit unsigned integers and steps
# past the last element by up to 4 x its grid's threads: N^2 < 2^31
MAX_N = 46_340


def _chol_inv(D):
    """Column-by-column Cholesky of a PxP SPD block and the inverse of the
    factor. Returns (LT [P,P] upper = L^T, Linv [P,P] lower = L^-1)."""
    P = D.shape[0]
    cols = torch.arange(P, device=D.device)
    rows = []
    R = D
    for c in range(P):
        r = R[c] / torch.sqrt(torch.clamp(R[c, c], min=EPS))
        r = torch.where(cols >= c, r, torch.zeros_like(r))
        rows.append(r)
        R = R - r[:, None] * r[None, :]
    LT = torch.stack(rows)
    eye = torch.eye(P, dtype=D.dtype, device=D.device)
    xrows = []
    for c in range(P):
        acc = eye[c]
        for k in range(c):
            acc = acc - LT[k, c] * xrows[k]
        xrows.append(acc / torch.clamp(LT[c, c], min=EPS))
    return LT, torch.stack(xrows)


def chol_solve_plain(S, b, panel=PANEL):
    """Plain version of kernel E: x with S x = b, S [N,N] SPD, b [N], over
    `panel`-row panels."""
    N = S.shape[0]
    nb = (N + panel - 1) // panel
    Np = nb * panel
    R = torch.eye(Np, dtype=S.dtype, device=S.device)
    R[:N, :N] = S
    vec = torch.zeros(Np, dtype=S.dtype, device=S.device)
    vec[:N] = b
    panels, inverses = [], []
    for j in range(nb):
        p, q = j * panel, (j + 1) * panel
        _, Linv = _chol_inv(R[p:q, p:q])
        A = Linv @ R[p:q, q:]  # [P, Np - q]: the panel of L^T
        R[q:, q:] -= A.T @ A
        y = Linv @ vec[p:q]
        vec[p:q] = y
        vec[q:] -= y @ A
        panels.append(A)
        inverses.append(Linv)
    for j in range(nb - 1, -1, -1):
        p, q = j * panel, (j + 1) * panel
        t = panels[j] @ vec[q:]
        vec[p:q] = inverses[j].T @ (vec[p:q] - t)
    return vec[:N].clone()


def launch_plan(N, sms, blocks_per_sm):
    """Kernel E's launch for an N x N system on a card with `sms` SMs that
    hold `blocks_per_sm` of its blocks each: {"panel", "panels", "grid"
    (blocks: all co-resident, as the cooperative launch needs, and no more
    than the first trailing update has tiles, at least 1), "tiles_first_step",
    "grid_barriers" (the length of the dependency chain: 3 per panel less
    one), "ld" (the scratch's row stride: N + 1 rounded up to 4, so that a
    panel's columns start 16-byte aligned), "scratch_floats"}."""
    P = PANEL_E
    panels = (N + P - 1) // P
    q = min(P, N)
    rt = (N - q + TILE - 1) // TILE
    ct = (N + 1 - q + TILE - 1) // TILE
    tiles = rt * ct - rt * (rt - 1) // 2
    ld = (N + 4) // 4 * 4
    return {"panel": P, "panels": panels,
            "grid": max(1, min(sms * blocks_per_sm, tiles)),
            "tiles_first_step": tiles, "grid_barriers": 3 * panels - 1,
            "ld": ld, "scratch_floats": N * ld + panels * P * P}


_blocks_per_sm: dict[int, int] = {}


def card_plan(N, device):
    """`launch_plan` for the card that holds `device` (its SM count and the
    kernel's occupancy there, asked once per card)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _blocks_per_sm:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            code = kernels.lib("chol_solve").chol_solve_blocks_per_sm(ctypes.byref(out))
        kernels.check(code, "chol_solve_blocks_per_sm")
        kernels.require(out.value >= 1, "chol_solve: the kernel does not fit an SM")
        _blocks_per_sm[idx] = out.value
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return launch_plan(N, sms, _blocks_per_sm[idx])


def chol_solve(S, b):
    """Kernel E: x [N] with S x = b for S [N,N] symmetric positive definite
    and b [N], float32, N from 1 to MAX_N. CPU tensors run the plain version
    with the kernel's panels; CUDA tensors launch the kernel or raise."""
    if not S.is_cuda:
        return chol_solve_plain(S, b, PANEL_E)
    N = S.shape[0]
    f32 = torch.float32
    kernels.check_cuda("S", S, f32, (N, N))
    kernels.check_cuda("b", b, f32, (N,))
    kernels.require(1 <= N <= MAX_N, f"chol_solve: N = {N} not in 1 .. {MAX_N}")
    plan = card_plan(N, S.device)
    work = torch.empty(plan["scratch_floats"], dtype=f32, device=S.device)
    x = torch.empty((N,), dtype=f32, device=S.device)
    code = kernels.lib("chol_solve").chol_solve(
        S.data_ptr(), b.data_ptr(), N, plan["grid"], work.data_ptr(),
        x.data_ptr(), kernels.stream_of(S))
    kernels.check(code, "chol_solve")
    kernels.LAUNCHES["chol_solve"] += 1
    return x
