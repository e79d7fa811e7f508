"""Dense-BA kernels B (eval + assembly, optional back-substitution) and C
(Schur-S with the folded damped U), with their plain PyTorch versions.

Port of `bundleadjustment_tpu/solvers/pallas_dense_eval.py`:

- `eval_assemble` / `eval_assemble_bs` replace `fused_eval_assemble` /
  `fused_eval_assemble_bs` (one CUDA kernel, `csrc/dense_eval.cu`, with a
  back-substitution flag);
- `schur_prepare_s` replaces `fused_schur_prepare_s(..., red27=...,
  cam_fixed=...)`, the single-device `fold_u=True` path, in float32
  (`csrc/schur_s.cu`).

Each wrapper dispatches on the device of its tensors: CPU tensors run the
plain version below it, CUDA tensors launch the kernel or raise. Inputs and
outputs use the reference's component-major layouts, so a test can hand the
same arrays to both packages.

Tolerances against the plain versions (and against the JAX kernels): the
kernels sum per-camera rows and S entries with float atomics, in an order
that changes from run to run; cost agrees to rtol 1e-5, the block outputs to
rtol 2e-4 / atol 2e-3 (S and b scaled by max|S|).
"""

from __future__ import annotations

import torch

from collections import namedtuple

from bundleadjustment_tpu_torch import kernels

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


def damped_u_embed(lam, red27, cam_fixed):
    """The block-diagonal damped U (identity blocks for fixed cameras) in
    (i, k) row order, plus 1e-8 I: [6K, 6K]."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import SYM6_IDX

    K = red27.shape[0]
    idx6 = torch.from_numpy(SYM6_IDX).to(red27.device)
    U = red27[:, idx6]  # [K, 6, 6]
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    dU = torch.clamp(torch.diagonal(U, dim1=-2, dim2=-1), min=1e-6)
    U = U + (lam * dU)[..., None] * eye6
    U = torch.where(cam_fixed[:, None, None], eye6, U)
    E = torch.zeros((6, K, 6, K), dtype=U.dtype, device=U.device)
    ar = torch.arange(K, device=U.device)
    E[:, ar, :, ar] = U
    E = E.reshape(6 * K, 6 * K)
    return E + 1e-8 * torch.eye(6 * K, dtype=U.dtype, device=U.device)


def schur_prepare_s_plain(lam, Vu, g_p, pt_valid, W18, cam_t, n_cams, red27,
                          cam_fixed):
    """Plain version of kernel C. Returns (S [6K,6K], zv [3,L], vinv6 [6,L],
    b [6K]), S = U_damped_embed + 1e-8 I - Q Q^T and b = -(g_c - sum W zv),
    both in (i, k) order (row i*K + k)."""
    O, L = cam_t.shape
    K = n_cams
    vinv6, C, zv = _point_prepare_plain(lam, Vu, g_p, pt_valid)
    G = torch.stack([sum(W18[i * 3 + j] * C[j][m][None, :] for j in range(3))
                     for i in range(6) for m in range(3)])  # [18, O, L]
    wz = torch.stack([sum(W18[i * 3 + j] * zv[j][None, :] for j in range(3))
                      for i in range(6)])  # [6, O, L]
    cam = cam_t.long()
    red6 = torch.zeros((K, 6), dtype=wz.dtype, device=wz.device).index_add_(
        0, cam.reshape(-1), wz.reshape(6, -1).T)
    g_c = torch.where(cam_fixed[:, None], torch.zeros_like(red6), red27[:, 21:])
    b = -(g_c - red6).T.reshape(-1)
    # Pf[l, k, i, m] = sum_o [cam_o == k] G[i, m, o, l]; Q rows in (i, k) order
    slot = (torch.arange(L, device=cam.device)[None, :] * K + cam).reshape(-1)
    Pf = torch.zeros((L * K, 18), dtype=G.dtype, device=G.device).index_add_(
        0, slot, G.reshape(18, -1).T)
    Q = Pf.reshape(L, K, 6, 3).permute(2, 1, 0, 3).reshape(6 * K, 3 * L)
    S = damped_u_embed(lam, red27, cam_fixed) - Q @ Q.T
    return S, zv, vinv6, b


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
    O, L = cam_t.shape
    K = n_cams
    dev = cam_t.device
    f32 = torch.float32
    kernels.check_cuda("lam", lam, f32, ())
    kernels.check_cuda("red27", red27, f32, (K, N_RED))
    kernels.check_cuda("cam_fixed", cam_fixed, torch.bool, (K,))
    kernels.check_cuda("Vu", Vu, f32, (6, L))
    kernels.check_cuda("g_p", g_p, f32, (3, L))
    kernels.check_cuda("pt_valid", pt_valid, torch.bool, (L,))
    kernels.check_cuda("W18", W18, f32, (18, O, L))
    kernels.check_cuda("cam_t", cam_t, torch.int32, (O, L))
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


# The three per-iteration functions of the dense LM solve. `dense_ba_solve`
# takes the dispatching wrappers by default; a comparison on the card can
# pass PLAIN_OPS to run the same solve through the plain versions.
DenseOps = namedtuple("DenseOps", "eval_assemble eval_assemble_bs schur_prepare_s")
KERNEL_OPS = DenseOps(eval_assemble, eval_assemble_bs, schur_prepare_s)
PLAIN_OPS = DenseOps(eval_assemble_plain, eval_assemble_bs_plain,
                     schur_prepare_s_plain)
