"""Schur-complement normal equations for the flat engine.

Port of `bundleadjustment_tpu/solvers/schur.py`. The camera system
S dc = b with S = U - W V^-1 W^T, b = -(g_c - W V^-1 g_p), then
dp = -V^-1 (g_p + W^T dc). The JAX `segment_sum` block build becomes
`index_add_`. Two solve modes, as the reference's:

- dense: S materialised (the matvec applied to the identity), Cholesky;
- pcg: matrix-free conjugate gradient on S with a block-Jacobi (damped
  6x6 U blocks) preconditioner, a fixed number of iterations with no host
  synchronisation inside (`pcg`, shared by the flat, dense and sharded
  engines).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class BABlocks:
    U: torch.Tensor  # [K, 6, 6] damped camera blocks
    V_inv: torch.Tensor  # [L, 3, 3]
    W: torch.Tensor  # [N, 6, 3]
    g_c: torch.Tensor  # [K, 6]
    g_p: torch.Tensor  # [L, 3]
    cam_idx: torch.Tensor  # [N]
    pt_idx: torch.Tensor  # [N]


def sym3_inv(V):
    """Batched closed-form 3x3 symmetric inverse via the adjugate."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e = V[..., 1, 1], V[..., 1, 2]
    f = V[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20,
                                torch.full_like(det, 1e-20), det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    adj = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([B, D, E], -1),
        torch.stack([C, E, F], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _segment_sum(x, idx, n):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add_(0, idx, x)


def build_blocks(r, Jc, Jp, cam_idx, pt_idx, n_cams, n_pts, lam, cam_fixed,
                 pt_fixed):
    """Damped Schur blocks from per-observation residuals/Jacobians
    (Marquardt damping lam * clip(diag, 1e-6); identity for fixed blocks)."""
    Uc = torch.einsum("nri,nrj->nij", Jc, Jc)
    Vp = torch.einsum("nri,nrj->nij", Jp, Jp)
    W = torch.einsum("nri,nrj->nij", Jc, Jp)
    gc = torch.einsum("nri,nr->ni", Jc, r)
    gp = torch.einsum("nri,nr->ni", Jp, r)
    U = _segment_sum(Uc, cam_idx, n_cams)
    V = _segment_sum(Vp, pt_idx, n_pts)
    g_c = _segment_sum(gc, cam_idx, n_cams)
    g_p = _segment_sum(gp, pt_idx, n_pts)

    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    dU = torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=1e-6)
    dV = torch.clamp(torch.diagonal(V, dim1=-2, dim2=-1), min=1e-6)
    U = U + (lam * dU)[..., None] * eye6
    V = V + (lam * dV)[..., None] * eye3
    U = torch.where(cam_fixed[:, None, None], eye6, U)
    V = torch.where(pt_fixed[:, None, None], eye3, V)
    zero = torch.zeros((), dtype=U.dtype, device=U.device)
    g_c = torch.where(cam_fixed[:, None], zero, g_c)
    g_p = torch.where(pt_fixed[:, None], zero, g_p)
    return BABlocks(U, sym3_inv(V), W, g_c, g_p, cam_idx, pt_idx)


def schur_matvec(blocks, x):
    """S @ x for a batch x [B, K, 6], matrix-free: Ux - W V^-1 W^T x."""
    Ux = torch.einsum("kij,bkj->bki", blocks.U, x)
    Wx = torch.einsum("nij,bni->bnj", blocks.W, x[:, blocks.cam_idx])
    L = blocks.V_inv.shape[0]
    y = torch.zeros((x.shape[0], L, 3), dtype=x.dtype,
                    device=x.device).index_add_(1, blocks.pt_idx, Wx)
    z = torch.einsum("lij,blj->bli", blocks.V_inv, y)
    Wz = torch.einsum("nij,bnj->bni", blocks.W, z[:, blocks.pt_idx])
    back = torch.zeros_like(x).index_add_(1, blocks.cam_idx, Wz)
    return Ux - back


def schur_rhs(blocks):
    """b = -(g_c - W V^-1 g_p)."""
    z = torch.einsum("lij,lj->li", blocks.V_inv, blocks.g_p)
    Wz = torch.einsum("nij,nj->ni", blocks.W, z[blocks.pt_idx])
    red = _segment_sum(Wz, blocks.cam_idx, blocks.g_c.shape[0])
    return -(blocks.g_c - red)


def back_substitute(blocks, dc):
    """dp = -V^-1 (g_p + W^T dc)."""
    Wx = torch.einsum("nij,ni->nj", blocks.W, dc[blocks.cam_idx])
    y = _segment_sum(Wx, blocks.pt_idx, blocks.V_inv.shape[0])
    return -torch.einsum("lij,lj->li", blocks.V_inv, blocks.g_p + y)


def cholesky_solve_nan(S, b):
    """Solve S x = b for SPD S without a host sync: `cholesky_ex` reports a
    failed factorization in `info` instead of raising, and a non-PD S then
    yields NaN (as the JAX Cholesky does), so the LM step is rejected."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where(info[..., None] == 0, x, torch.full_like(x, float("nan")))


def solve_schur_dense(blocks):
    """Materialize S (matvec applied to the identity) and Cholesky-solve."""
    K = blocks.U.shape[0]
    eye = torch.eye(K * 6, dtype=blocks.U.dtype, device=blocks.U.device)
    cols = schur_matvec(blocks, eye.reshape(K * 6, K, 6)).reshape(K * 6, K * 6)
    S = cols.T + 1e-8 * eye
    b = schur_rhs(blocks).reshape(-1)
    return cholesky_solve_nan(S, b).reshape(K, 6)


def _guard(x):
    """The reference's 1e-30 guard of a CG denominator (a 0-d tensor)."""
    return torch.where(torch.abs(x) < 1e-30, torch.full_like(x, 1e-30), x)


def pcg(matvec, b, Minv, max_iters):
    """Block-Jacobi preconditioned CG on S x = b from x = 0: `matvec(x)`
    gives S x for x [K, 6], Minv [K, 6, 6] is the preconditioner. Runs
    exactly `max_iters` iterations; alpha and beta stay 0-d tensors on the
    device, so nothing synchronises with the host.

    The reference's tolerance stops nothing: its "freeze once converged"
    (`bundleadjustment_tpu/solvers/schur.py:181-182`) keeps the new iterate
    on both branches, and the dense engine's loop has no tolerance at all.
    For parity the port runs every iteration too."""
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("kij,kj->ki", Minv, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(max_iters):
        Sp = matvec(p)
        alpha = rz / _guard(torch.sum(p * Sp))
        x = x + alpha * p
        r = r - alpha * Sp
        z = torch.einsum("kij,kj->ki", Minv, r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / _guard(rz)) * p
        rz = rz_new
    return x


def block_jacobi(U):
    """The preconditioner: the inverses of the damped 6x6 U blocks
    (`inv_ex`: a singular block gives non-finite values, as the reference's
    `jnp.linalg.inv`, instead of a host-side error check)."""
    return torch.linalg.inv_ex(U)[0]


def solve_schur_pcg(blocks, max_iters=50, tol=1e-6):
    """Matrix-free PCG solve of S dc = b. `tol` is accepted for the
    reference's signature and, as there, stops nothing (see `pcg`)."""
    del tol
    return pcg(lambda x: schur_matvec(blocks, x[None])[0], schur_rhs(blocks),
               block_jacobi(blocks.U), max_iters)
