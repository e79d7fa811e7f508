"""Dense-BA kernels B (eval + assembly, optional back-substitution), C
(Schur-S with the folded damped U), K5 (C's unfolded per-shard partial) and
D (Schur prepare), with their plain PyTorch versions.

Port of `bundleadjustment_tpu/solvers/pallas_dense_eval.py`:

- `eval_assemble` / `eval_assemble_bs` replace `fused_eval_assemble` /
  `fused_eval_assemble_bs` (one CUDA kernel, `csrc/dense_eval.cu`, with a
  back-substitution flag);
- `schur_prepare_s` replaces `fused_schur_prepare_s(..., red27=...,
  cam_fixed=...)`, the single-device `fold_u=True` path, in float32
  (`csrc/schur_s.cu`);
- `schur_qqt_partial` replaces `fused_schur_prepare_s(...)` without red27,
  the sharded engine's `fold_u=False` path (K5; kernel C's landmark loop
  launched onto zero, in C's (i, k) order);
- `schur_prepare` replaces `fused_schur_prepare` (K6; `csrc/
  schur_prepare.cu`), whose G feeds the outside `pf_index_add` / `qqt`
  product for large O.

Each wrapper dispatches on the device of its tensors: CPU tensors run the
plain version below it, CUDA tensors launch the kernel or raise. Inputs and
outputs use the reference's component-major layouts, so a test can hand the
same arrays to both packages.

Tolerances against the plain versions (and against the JAX kernels): the
kernels sum per-camera rows and S entries with float atomics, in an order
that changes from run to run; cost agrees to rtol 1e-5, the block outputs to
rtol 2e-4 / atol 2e-3 relative to each block's own magnitude.
"""

from __future__ import annotations

import torch

from collections import namedtuple

from bundleadjustment_tpu_torch import kernels
from bundleadjustment_tpu_torch.solvers.chol import chol_solve, chol_solve_plain
from bundleadjustment_tpu_torch.solvers.schur import cholesky_solve_nan

N_RED = 27  # 21 upper-triangle U rows + 6 gradient rows per camera


# ---------------------------------------------------------------------------
# kernel B: eval + assembly (+ landmark back-substitution)
# ---------------------------------------------------------------------------


def _backsub_plain(cam_t, dc, Xt, W18_prev, vinv6, gp_prev, pt_valid):
    """Xt_new = Xt - V^-1 (g_p + sum_o W_o^T dc[cam_o]) for valid points."""
    dcg = dc[cam_t.long()]  # [O, L, 6]
    y = [torch.sum(sum(W18_prev[i * 3 + j] * dcg[..., i] for i in range(6)), 0)
         for j in range(3)]
    a = [gp_prev[j] + y[j] for j in range(3)]
    v = vinv6
    dp = [-(v[0] * a[0] + v[1] * a[1] + v[2] * a[2]),
          -(v[1] * a[0] + v[3] * a[1] + v[4] * a[2]),
          -(v[2] * a[0] + v[4] * a[1] + v[5] * a[2])]
    dp = torch.stack(dp)
    dp = torch.where(pt_valid[None, :], dp, torch.zeros_like(dp))
    return Xt + dp


def eval_assemble_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t,
                        Xt, robust=True):
    """Plain version of kernel B without back-substitution.
    Returns (cost, red [K,27], Vu [6,L], g_p [3,L], W [6,3,O,L])."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import _assemble_cm, _eval_cm

    rho, r, Jc, Jp = _eval_cm(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t,
                              R, t, Xt, robust)
    red, Vu, g_p, W = _assemble_cm(cam_t, R.shape[0], r, Jc, Jp)
    return torch.sum(rho), red, Vu, g_p, W


def eval_assemble_bs_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R,
                           t, dc, Xt, W18_prev, vinv6, gp_prev, pt_valid,
                           robust=True):
    """Plain version of kernel B with back-substitution: evaluates at the
    trial landmarks. Returns (cost, red, Vu, g_p, W, Xt_new [3,L])."""
    Xt_new = _backsub_plain(cam_t, dc, Xt, W18_prev, vinv6, gp_prev, pt_valid)
    out = eval_assemble_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t,
                              R, t, Xt_new, robust)
    return (*out, Xt_new)


def _launch_eval(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t, Xt,
                 robust, bs):
    O, L = cam_t.shape
    K = R.shape[0]
    dev = cam_t.device
    f32 = torch.float32
    kernels.check_cuda("K4", K4, f32, (4,))
    kernels.check_cuda("R", R, f32, (K, 3, 3))
    kernels.check_cuda("t", t, f32, (K, 3))
    kernels.check_cuda("cam_t", cam_t, torch.int32, (O, L))
    kernels.check_cuda("uv_t", uv_t, f32, (2, O, L))
    kernels.check_cuda("inv_sigma_t", inv_sigma_t, f32, (O, L))
    kernels.check_cuda("valid_t", valid_t, torch.bool, (O, L))
    kernels.check_cuda("fixed_t", fixed_t, torch.bool, (O, L))
    kernels.check_cuda("Xt", Xt, f32, (3, L))
    if bs is not None:
        dc, W18_prev, vinv6, gp_prev, pt_valid = bs
        kernels.check_cuda("dc", dc, f32, (K, 6))
        kernels.check_cuda("W18_prev", W18_prev, f32, (18, O, L))
        kernels.check_cuda("vinv6", vinv6, f32, (6, L))
        kernels.check_cuda("gp_prev", gp_prev, f32, (3, L))
        kernels.check_cuda("pt_valid", pt_valid, torch.bool, (L,))
        bs_ptrs = [x.data_ptr() for x in bs]
    else:
        bs_ptrs = [None] * 5
    red = torch.zeros((K, N_RED), dtype=f32, device=dev)
    cost = torch.zeros((), dtype=f32, device=dev)
    Vu = torch.empty((6, L), dtype=f32, device=dev)
    g_p = torch.empty((3, L), dtype=f32, device=dev)
    W = torch.empty((18, O, L), dtype=f32, device=dev)
    Xt_new = torch.empty((3, L), dtype=f32, device=dev) if bs is not None else None
    dc_ptr, w_ptr, v_ptr, gp_ptr, ptv_ptr = bs_ptrs
    code = kernels.lib("dense_eval").dense_eval_assemble(
        K4.data_ptr(), R.data_ptr(), t.data_ptr(), dc_ptr, cam_t.data_ptr(),
        uv_t.data_ptr(), inv_sigma_t.data_ptr(), valid_t.data_ptr(),
        fixed_t.data_ptr(), Xt.data_ptr(), w_ptr, v_ptr, gp_ptr, ptv_ptr,
        O, L, K, int(bool(robust)), int(bs is not None),
        red.data_ptr(), cost.data_ptr(), Vu.data_ptr(), g_p.data_ptr(),
        W.data_ptr(), None if Xt_new is None else Xt_new.data_ptr(),
        kernels.stream_of(cam_t))
    kernels.check(code, "dense_eval_assemble")
    if L:
        name = "dense_eval_assemble" if bs is None else "dense_eval_assemble_bs"
        kernels.LAUNCHES[name] += 1
    out = (cost, red, Vu, g_p, W.reshape(6, 3, O, L))
    return out if bs is None else (*out, Xt_new)


def eval_assemble(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t, Xt,
                  robust=True):
    """Kernel B seed eval: (cost, red [K,27], Vu [6,L], g_p [3,L],
    W [6,3,O,L]) at (R, t, Xt)."""
    if not cam_t.is_cuda:
        return eval_assemble_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t,
                                   fixed_t, R, t, Xt, robust)
    return _launch_eval(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t,
                        Xt, robust, None)


def eval_assemble_bs(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t, dc,
                     Xt, W18_prev, vinv6, gp_prev, pt_valid, robust=True):
    """Kernel B with fused back-substitution: (cost, red, Vu, g_p, W, Xt_new)
    evaluated at the trial landmarks Xt_new."""
    if not cam_t.is_cuda:
        return eval_assemble_bs_plain(K4, cam_t, uv_t, inv_sigma_t, valid_t,
                                      fixed_t, R, t, dc, Xt, W18_prev, vinv6,
                                      gp_prev, pt_valid, robust)
    return _launch_eval(K4, cam_t, uv_t, inv_sigma_t, valid_t, fixed_t, R, t,
                        Xt, robust, (dc, W18_prev, vinv6, gp_prev, pt_valid))


# ---------------------------------------------------------------------------
# kernel C: Schur prepare + S with the folded damped U
# ---------------------------------------------------------------------------


def _point_prepare_plain(lam, Vu, g_p, pt_valid):
    """Damped V (identity for invalid points), closed-form V^-1 (vinv6),
    chol(V^-1) as a nested list C[j][m], and zv = V^-1 g_p."""
    v00, v01, v02, v11, v12, v22 = (Vu[i] for i in range(6))
    v00 = v00 + lam * torch.clamp(v00, min=1e-6)
    v11 = v11 + lam * torch.clamp(v11, min=1e-6)
    v22 = v22 + lam * torch.clamp(v22, min=1e-6)
    one, zero = torch.ones_like(v00), torch.zeros_like(v00)
    v00, v11, v22 = (torch.where(pt_valid, v, one) for v in (v00, v11, v22))
    v01, v02, v12 = (torch.where(pt_valid, v, zero) for v in (v01, v02, v12))
    A = v11 * v22 - v12 * v12
    B = v02 * v12 - v01 * v22
    Cc = v01 * v12 - v02 * v11
    det = v00 * A + v01 * B + v02 * Cc
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20,
                                torch.full_like(det, 1e-20), det)
    D = v00 * v22 - v02 * v02
    E = v01 * v02 - v00 * v12
    F = v00 * v11 - v01 * v01
    i00, i01, i02 = A * inv_det, B * inv_det, Cc * inv_det
    i11, i12, i22 = D * inv_det, E * inv_det, F * inv_det
    vinv6 = torch.stack([i00, i01, i02, i11, i12, i22])
    l00 = torch.sqrt(torch.clamp(i00, min=1e-20))
    l10 = i01 / l00
    l20 = i02 / l00
    l11 = torch.sqrt(torch.clamp(i11 - l10 * l10, min=1e-20))
    l21 = (i12 - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp(i22 - l20 * l20 - l21 * l21, min=1e-20))
    C = [[l00, zero, zero], [l10, l11, zero], [l20, l21, l22]]
    gp = g_p
    zv = torch.stack([i00 * gp[0] + i01 * gp[1] + i02 * gp[2],
                      i01 * gp[0] + i11 * gp[1] + i12 * gp[2],
                      i02 * gp[0] + i12 * gp[1] + i22 * gp[2]])
    return vinv6, C, zv


def damped_system(lam, red27, cam_fixed, S_qqt, red6):
    """The damped Schur system (S, b) of one LM iteration from the undamped
    camera rows red27 [K,27] and the point terms S_qqt = +Q Q^T [6K,6K] and
    red6 = sum W zv [6,K]: S = the block-diagonal damped U (identity blocks
    for fixed cameras, the reference's `_damp_U_cm`) + 1e-8 I - S_qqt and
    b = -(g_c - red6) (g_c zero for fixed cameras), all in (i, k) order (row
    i*K + k), so the solution comes back as [6, K]."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import SYM6_IDX

    K = red27.shape[0]
    U = red27[:, torch.from_numpy(SYM6_IDX).to(red27.device)]  # [K, 6, 6]
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    dU = torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=1e-6)
    U = U + (lam * dU)[..., None] * eye6
    U = torch.where(cam_fixed[:, None, None], eye6, U)
    g_c = torch.where(cam_fixed[:, None], torch.zeros_like(red27[:, 21:]),
                      red27[:, 21:])
    E = torch.zeros((6, K, 6, K), dtype=U.dtype, device=U.device)
    ar = torch.arange(K, device=U.device)
    E[:, ar, :, ar] = U
    S = (E.reshape(6 * K, 6 * K)
         + 1e-8 * torch.eye(6 * K, dtype=U.dtype, device=U.device) - S_qqt)
    return S, -(g_c.T - red6).reshape(-1)


def schur_prepare_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams):
    """Plain version of kernel D. Returns (G [18,O,L] = W chol(V^-1) in rows
    i*3 + m, zv [3,L], vinv6 [6,L], red6 [6,K] = sum W zv per camera)."""
    vinv6, C, zv = _point_prepare_plain(lam, Vu, g_p, pt_valid)
    G = torch.stack([sum(W18[i * 3 + j] * C[j][m][None, :] for j in range(3))
                     for i in range(6) for m in range(3)])  # [18, O, L]
    wz = torch.stack([sum(W18[i * 3 + j] * zv[j][None, :] for j in range(3))
                      for i in range(6)])  # [6, O, L]
    # index_add_ along dim 0, then [6, K]: along dim 1 it is slower on the
    # card and sums in another order
    red6 = torch.zeros((n_cams, 6), dtype=wz.dtype, device=wz.device).index_add_(
        0, cam_t.reshape(-1).long(), wz.reshape(6, -1).T).T.contiguous()
    return G, zv, vinv6, red6


def pf_index_add(G, cam_t, n_cams):
    """Pf [L*K, 18]: Pf[l*K + k] = sum_o [cam_o == k] G[:, o, l] (one
    index_add_; the reference's one-hot Pf contraction)."""
    L = cam_t.shape[1]
    slot = (torch.arange(L, device=cam_t.device)[None, :] * n_cams
            + cam_t.long()).reshape(-1)
    return torch.zeros((L * n_cams, 18), dtype=G.dtype,
                       device=G.device).index_add_(0, slot, G.reshape(18, -1).T)


def qqt(Pf, n_cams):
    """Q Q^T [6K, 6K] from Pf [L*K, 18] (columns i*3 + m), with Q's rows in
    (i, k) order (row i*K + k); a plain matrix product."""
    K = n_cams
    L = Pf.shape[0] // K
    Q = Pf.reshape(L, K, 6, 3).permute(2, 1, 0, 3).reshape(6 * K, 3 * L)
    return Q @ Q.T


def schur_qqt_partial_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams):
    """Plain version of K5. Returns (S_qqt [6K,6K] = +Q Q^T, zv [3,L],
    vinv6 [6,L], red6 [6,K]), in (i, k) order."""
    G, zv, vinv6, red6 = schur_prepare_plain(lam, Vu, g_p, pt_valid, W18,
                                             cam_t, n_cams)
    return qqt(pf_index_add(G, cam_t, n_cams), n_cams), zv, vinv6, red6


def schur_prepare_s_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams, red27,
                          cam_fixed):
    """Plain version of kernel C. Returns (S [6K,6K], zv [3,L], vinv6 [6,L],
    b [6K]), S = U_damped_embed + 1e-8 I - Q Q^T and b = -(g_c - sum W zv),
    both in (i, k) order (row i*K + k)."""
    S_qqt, zv, vinv6, red6 = schur_qqt_partial_plain(lam, Vu, g_p, pt_valid,
                                                     W18, cam_t, n_cams)
    S, b = damped_system(lam, red27, cam_fixed, S_qqt, red6)
    return S, zv, vinv6, b


def _check_prepare_args(lam, Vu, g_p, pt_valid, W18, cam_t):
    O, L = cam_t.shape
    f32 = torch.float32
    kernels.check_cuda("lam", lam, f32, ())
    kernels.check_cuda("Vu", Vu, f32, (6, L))
    kernels.check_cuda("g_p", g_p, f32, (3, L))
    kernels.check_cuda("pt_valid", pt_valid, torch.bool, (L,))
    kernels.check_cuda("W18", W18, f32, (18, O, L))
    kernels.check_cuda("cam_t", cam_t, torch.int32, (O, L))
    return O, L


def schur_prepare_s(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams, red27,
                    cam_fixed):
    """Kernel C: the damped Schur system of one LM iteration.

    lam: 0-d float32 tensor (stays on the device); Vu [6,L]; g_p [3,L];
    pt_valid [L] bool; W18 [18,O,L]; cam_t [O,L] int32; red27 [K,27];
    cam_fixed [K] bool. Returns (S, zv, vinv6, b) as the plain version.
    """
    if not cam_t.is_cuda:
        return schur_prepare_s_plain(lam, Vu, g_p, pt_valid, W18, cam_t,
                                     n_cams, red27, cam_fixed)
    O, L = _check_prepare_args(lam, Vu, g_p, pt_valid, W18, cam_t)
    K = n_cams
    dev = cam_t.device
    f32 = torch.float32
    kernels.check_cuda("red27", red27, f32, (K, N_RED))
    kernels.check_cuda("cam_fixed", cam_fixed, torch.bool, (K,))
    S = torch.empty((6 * K, 6 * K), dtype=f32, device=dev)
    b = torch.empty((6 * K,), dtype=f32, device=dev)
    zv = torch.empty((3, L), dtype=f32, device=dev)
    vinv6 = torch.empty((6, L), dtype=f32, device=dev)
    code = kernels.lib("schur_s").schur_prepare_s(
        lam.data_ptr(), red27.data_ptr(), cam_fixed.data_ptr(), Vu.data_ptr(),
        g_p.data_ptr(), pt_valid.data_ptr(), W18.data_ptr(), cam_t.data_ptr(),
        O, L, K, S.data_ptr(), b.data_ptr(), zv.data_ptr(), vinv6.data_ptr(),
        kernels.stream_of(cam_t))
    kernels.check(code, "schur_prepare_s")
    kernels.LAUNCHES["schur_prepare_s"] += 1
    return S, zv, vinv6, b


def schur_qqt_partial(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams):
    """K5: the per-shard Schur partial of the sharded engine.

    Same inputs as kernel D. Returns (S_qqt [6K,6K] = +Q Q^T, zv [3,L],
    vinv6 [6,L], red6 [6,K] = sum W zv), S_qqt and red6 in (i, k) order as
    kernel C's: no U, no g_c, no jitter (the caller all-reduces them and
    folds in the replicated damped U, `damped_system`)."""
    if not cam_t.is_cuda:
        return schur_qqt_partial_plain(lam, Vu, g_p, pt_valid, W18, cam_t,
                                       n_cams)
    O, L = _check_prepare_args(lam, Vu, g_p, pt_valid, W18, cam_t)
    K = n_cams
    dev = cam_t.device
    f32 = torch.float32
    S = torch.empty((6 * K, 6 * K), dtype=f32, device=dev)
    red6 = torch.empty((6, K), dtype=f32, device=dev)
    zv = torch.empty((3, L), dtype=f32, device=dev)
    vinv6 = torch.empty((6, L), dtype=f32, device=dev)
    code = kernels.lib("schur_s").schur_qqt_partial(
        lam.data_ptr(), Vu.data_ptr(), g_p.data_ptr(), pt_valid.data_ptr(),
        W18.data_ptr(), cam_t.data_ptr(), O, L, K, S.data_ptr(),
        red6.data_ptr(), zv.data_ptr(), vinv6.data_ptr(),
        kernels.stream_of(cam_t))
    kernels.check(code, "schur_qqt_partial")
    kernels.LAUNCHES["schur_qqt_partial"] += 1
    return S, zv, vinv6, red6


def schur_prepare(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams):
    """Kernel D: the Schur prepare of one LM iteration, G to memory.

    lam: 0-d float32 tensor; Vu [6,L]; g_p [3,L]; pt_valid [L] bool;
    W18 [18,O,L]; cam_t [O,L] int32. Returns (G [18,O,L], zv [3,L],
    vinv6 [6,L], red6 [6,K]) as the plain version."""
    if not cam_t.is_cuda:
        return schur_prepare_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams)
    O, L = _check_prepare_args(lam, Vu, g_p, pt_valid, W18, cam_t)
    K = n_cams
    dev = cam_t.device
    f32 = torch.float32
    G = torch.empty((18, O, L), dtype=f32, device=dev)
    zv = torch.empty((3, L), dtype=f32, device=dev)
    vinv6 = torch.empty((6, L), dtype=f32, device=dev)
    red6 = torch.empty((6, K), dtype=f32, device=dev)
    code = kernels.lib("schur_prepare").schur_prepare(
        lam.data_ptr(), Vu.data_ptr(), g_p.data_ptr(), pt_valid.data_ptr(),
        W18.data_ptr(), cam_t.data_ptr(), O, L, K, G.data_ptr(), zv.data_ptr(),
        vinv6.data_ptr(), red6.data_ptr(), kernels.stream_of(cam_t))
    kernels.check(code, "schur_prepare")
    kernels.LAUNCHES["schur_prepare"] += 1
    return G, zv, vinv6, red6


# The per-iteration functions of the dense LM solve. `dense_ba_solve` takes
# the dispatching wrappers by default; a comparison on the card can pass
# PLAIN_OPS to run the same solve through the plain versions. The camera
# system S x = b goes to the library call (`cholesky_solve_nan`) in both, as
# the reference's `solve_fused` keeps XLA's Cholesky; the *_CHOL tables
# differ in that field only and solve it with kernel E (`chol.chol_solve`)
# or its plain version.
DenseOps = namedtuple("DenseOps", "eval_assemble eval_assemble_bs "
                      "schur_prepare_s schur_qqt_partial schur_prepare "
                      "chol_solve")
KERNEL_OPS = DenseOps(eval_assemble, eval_assemble_bs, schur_prepare_s,
                      schur_qqt_partial, schur_prepare, cholesky_solve_nan)
PLAIN_OPS = DenseOps(eval_assemble_plain, eval_assemble_bs_plain,
                     schur_prepare_s_plain, schur_qqt_partial_plain,
                     schur_prepare_plain, cholesky_solve_nan)
KERNEL_OPS_CHOL = KERNEL_OPS._replace(chol_solve=chol_solve)
PLAIN_OPS_CHOL = PLAIN_OPS._replace(chol_solve=chol_solve_plain)
