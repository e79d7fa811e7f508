"""Plain reference of the global bundle adjustment, and the comparison that
decides whether a solve of the program is correct.

It imports torch and numpy only: nothing of the program under test, nothing
of the JAX package. It works on the flat observation table the benchmark
generated (camera, landmark, pixel, variance per observation), never on the
program's dense layout.

The problem, as the configuration states it: minimise
sum_obs rho(|| (pi(R_c X_p + t_c) - uv) / sigma ||) over every camera but
the fixed ones and every landmark, where pi is the pinhole projection with
(fx, fy, cx, cy), rho the Huber function at the configuration's
`huber_delta` (on the whitened residual's norm: 0.5 r^2 inside, delta
(r - delta / 2) outside) and an observation whose point lies at depth
z <= 1e-6 costs its `cheirality_penalty` instead (`cost_settings`). Cameras are world-to-camera axis-angle + translation ("rt6").

`solve` is Levenberg-Marquardt with the exact Schur complement over the
landmarks, in float64: one 6x6 block of S per pair of observations of a
landmark, summed per camera pair; the camera system by Cholesky; Huber by
iteratively reweighted least squares. It runs until a step no longer lowers
the cost by a relative 1e-13 or `max_iters` pass. `precision="tf32"` is the
control: the same solve in float32 with the operands of every matrix
product rounded to TF32 (10 mantissa bits, fp32 accumulation), as
`torch.backends.cuda.matmul.allow_tf32 = True` would compute them.

A cost made of reprojections alone leaves the scale of the map free (one
camera fixed), and lets a weakly seen direction wander under rounding. So
`compare` holds a solution to the reference only in forms the problem fixes:
the cost, each observation's predicted pixel, and each camera and landmark
against where the problem puts it given the rest of the program's solution.
"""

from __future__ import annotations

import numpy as np
import torch

PAIR_CHUNK = 1 << 20  # observation pairs a block product takes at once


# ---------------------------------------------------------------------------
# arithmetic in the reference's precision
# ---------------------------------------------------------------------------


def round_tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Arith:
    """dtype and matrix product of one solve: float64, or the TF32 control."""

    def __init__(self, precision):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}: float64 or tf32")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def mm(self, a, b):
        if self.tf32:
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)


def skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def aa_to_R(r):
    """Rodrigues: axis-angle [..., 3] -> [..., 3, 3]."""
    th = torch.linalg.norm(r, dim=-1)[..., None, None]
    small = th < 1e-12
    ths = torch.where(small, torch.ones_like(th), th)
    Kx = skew(r) / ths
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(Kx.shape)
    R = eye + torch.sin(ths) * Kx + (1 - torch.cos(ths)) * (Kx @ Kx)
    return torch.where(small, eye + skew(r), R)


def R_to_aa(R):
    """Log map [..., 3, 3] -> [..., 3] for rotations below pi."""
    cos = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2).clamp(-1, 1)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2
    sin = torch.linalg.norm(v, dim=-1)
    th = torch.atan2(sin, cos)
    scale = torch.where(sin < 1e-12, torch.ones_like(sin), th / sin.clamp(min=1e-300))
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# the problem
# ---------------------------------------------------------------------------


def cost_settings(config):
    """The cost's constants as the configuration's `solve` states them: the
    keyword arguments of `Problem`."""
    sv = config["solve"]
    return {"huber_delta": float(sv["huber_delta"]),
            "cheirality_penalty": float(sv["cheirality_penalty"])}


class Problem:
    """The flat observation table on a device, in the solve's dtype, with
    the pairs of observations that share a landmark."""

    def __init__(self, K4, cam_idx, pt_idx, uv, sigma2, cam_fixed, n_points,
                 device, arith, *, huber_delta, cheirality_penalty):
        self.a = arith
        self.delta = huber_delta
        self.penalty = cheirality_penalty
        dt = arith.dtype
        self.device = torch.device(device)
        t = lambda x, d: torch.as_tensor(np.asarray(x), dtype=d, device=self.device)  # noqa: E731
        self.K4 = t(K4, dt)
        self.cam = t(cam_idx, torch.int64)
        self.pt = t(pt_idx, torch.int64)
        self.uv = t(uv, dt)
        self.isig = 1.0 / torch.sqrt(t(sigma2, dt))
        self.cam_fixed = t(cam_fixed, torch.bool)
        self.K = int(self.cam_fixed.shape[0])
        self.L = int(n_points)
        # ordered pairs (a, b) of observations of one landmark, a and b both
        # of free cameras: the blocks of S = U - W V^-1 W^T
        cam = np.asarray(cam_idx, np.int64)
        pt = np.asarray(pt_idx, np.int64)
        free = ~np.asarray(cam_fixed, bool)[cam]
        idx = np.flatnonzero(free)
        order = idx[np.argsort(pt[idx], kind="stable")]
        p = pt[order]
        starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1]]) if len(p) else np.zeros(0, np.int64)
        sizes = np.diff(np.r_[starts, len(p)])
        sq = sizes * sizes
        base, n = np.repeat(starts, sq), np.repeat(sizes, sq)
        q = np.arange(len(base)) - np.repeat(np.cumsum(sq) - sq, sq)
        pa, pb = base + q // n, base + q % n
        self.pair_a = torch.as_tensor(order[pa], device=self.device)
        self.pair_b = torch.as_tensor(order[pb], device=self.device)
        free_cams = np.flatnonzero(~np.asarray(cam_fixed, bool))
        self.free = torch.as_tensor(free_cams, device=self.device)

    def camera_frame(self, R, t, X):
        """Points in their observing cameras' frames [N, 3]."""
        return self.a.mm(R[self.cam], X[self.pt][..., None])[..., 0] + t[self.cam]

    def residuals(self, R, t, X):
        """Whitened residuals [N, 2] and depths [N]."""
        xc = self.camera_frame(R, t, X)
        z = xc[:, 2]
        zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        uvp = torch.stack([self.K4[0] * xc[:, 0] / zs + self.K4[2],
                           self.K4[1] * xc[:, 1] / zs + self.K4[3]], -1)
        return (uvp - self.uv) * self.isig[:, None], z

    def cost_terms(self, r, z):
        n = torch.linalg.norm(r, dim=-1)
        rho = torch.where(n <= self.delta, 0.5 * n * n, self.delta * (n - 0.5 * self.delta))
        return torch.where(z > 1e-6, rho, torch.full_like(rho, self.penalty))

    def cost(self, R, t, X):
        r, z = self.residuals(R, t, X)
        return self.cost_terms(r, z).sum()

    def project(self, R, t, X):
        """Predicted pixels [N, 2]."""
        r, _ = self.residuals(R, t, X)
        return r / self.isig[:, None] + self.uv

    def linearize(self, R, t, X):
        """Cost, and the IRLS-weighted Jacobians of every observation:
        Jc [N, 2, 6] (left rotation increment, translation), Jp [N, 2, 3]
        and residuals r [N, 2]."""
        xc = self.camera_frame(R, t, X)
        z = xc[:, 2]
        zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        fx, fy = self.K4[0], self.K4[1]
        uvp = torch.stack([fx * xc[:, 0] / zs + self.K4[2],
                           fy * xc[:, 1] / zs + self.K4[3]], -1)
        r = (uvp - self.uv) * self.isig[:, None]
        rho = self.cost_terms(r, z)
        n = torch.linalg.norm(r, dim=-1).clamp(min=1e-12)
        w = torch.where(n <= self.delta, torch.ones_like(n), self.delta / n)
        w = torch.where(z > 1e-6, w, torch.zeros_like(w))
        sw = (torch.sqrt(w) * self.isig)[:, None, None]
        zero = torch.zeros_like(zs)
        duv = torch.stack([torch.stack([fx / zs, zero, -fx * xc[:, 0] / zs ** 2], -1),
                           torch.stack([zero, fy / zs, -fy * xc[:, 1] / zs ** 2], -1)],
                          -2) * sw  # [N, 2, 3]
        RX = xc - t[self.cam]
        Jc = torch.cat([self.a.mm(duv, -skew(RX)), duv], -1)  # [N, 2, 6]
        Jp = self.a.mm(duv, R[self.cam])  # [N, 2, 3]
        Jc = torch.where(self.cam_fixed[self.cam][:, None, None], torch.zeros_like(Jc), Jc)
        return rho.sum(), Jc, Jp, r * torch.sqrt(w)[:, None]

    def step(self, Jc, Jp, r, lam):
        """The damped Gauss-Newton step by the Schur complement over the
        landmarks: (dc [K, 6], dp [L, 3])."""
        mm, dt, dev = self.a.mm, self.a.dtype, self.device
        K, L = self.K, self.L
        JcT, JpT = Jc.transpose(1, 2), Jp.transpose(1, 2)
        U = torch.zeros((K, 6, 6), dtype=dt, device=dev).index_add_(0, self.cam, mm(JcT, Jc))
        gc = torch.zeros((K, 6), dtype=dt, device=dev).index_add_(
            0, self.cam, mm(JcT, r[..., None])[..., 0])
        V = torch.zeros((L, 3, 3), dtype=dt, device=dev).index_add_(0, self.pt, mm(JpT, Jp))
        gp = torch.zeros((L, 3), dtype=dt, device=dev).index_add_(
            0, self.pt, mm(JpT, r[..., None])[..., 0])
        W = mm(JcT, Jp)  # [N, 6, 3]
        eye6 = torch.eye(6, dtype=dt, device=dev)
        eye3 = torch.eye(3, dtype=dt, device=dev)
        U = U + lam * torch.diagonal(U, dim1=1, dim2=2).clamp(min=1e-6)[..., None] * eye6
        V = V + lam * torch.diagonal(V, dim1=1, dim2=2).clamp(min=1e-6)[..., None] * eye3
        has = torch.zeros(L, dtype=torch.bool, device=dev)
        has[self.pt] = True
        V = torch.where(has[:, None, None], V, eye3)
        Vinv = torch.linalg.inv(V)
        Y = mm(W, Vinv[self.pt])  # [N, 6, 3]
        S = torch.zeros((K * K, 6, 6), dtype=dt, device=dev)
        for s in range(0, len(self.pair_a), PAIR_CHUNK):
            a, b = self.pair_a[s:s + PAIR_CHUNK], self.pair_b[s:s + PAIR_CHUNK]
            S.index_add_(0, self.cam[a] * K + self.cam[b],
                         mm(Y[a], W[b].transpose(1, 2)))
        S = -S.reshape(K, K, 6, 6)
        S[torch.arange(K), torch.arange(K)] += U
        b = -(gc - torch.zeros((K, 6), dtype=dt, device=dev).index_add_(
            0, self.cam, mm(Y, gp[self.pt][..., None])[..., 0]))
        f = self.free
        Sf = S[f][:, f].permute(0, 2, 1, 3).reshape(6 * len(f), 6 * len(f))
        Sf = 0.5 * (Sf + Sf.T)
        Lc, info = torch.linalg.cholesky_ex(Sf)
        dc = torch.zeros((K, 6), dtype=dt, device=dev)
        if int(info) != 0:
            return None
        dc[f] = torch.cholesky_solve(b[f].reshape(-1, 1), Lc).reshape(-1, 6)
        wdc = mm(W.transpose(1, 2), dc[self.cam][..., None])[..., 0]  # [N, 3]
        rhs = gp + torch.zeros((L, 3), dtype=dt, device=dev).index_add_(0, self.pt, wdc)
        dp = -mm(Vinv, rhs[..., None])[..., 0]
        return dc, dp


def solve(prob, cams0, pts0, max_iters=60, lam0=1e-4, rtol=1e-13):
    """LM from (cams0 [K, 6], pts0 [L, 3]); returns (R [K,3,3], t [K,3],
    X [L,3], info) in the problem's dtype."""
    dt = prob.a.dtype
    R = aa_to_R(torch.as_tensor(cams0, device=prob.device).to(dt)[:, :3])
    t = torch.as_tensor(cams0, device=prob.device).to(dt)[:, 3:].clone()
    X = torch.as_tensor(pts0, device=prob.device).to(dt).clone()
    cost, Jc, Jp, r = prob.linearize(R, t, X)
    cost0, lam, accepted, it = float(cost), lam0, 0, 0
    for it in range(1, max_iters + 1):
        st = prob.step(Jc, Jp, r, lam)
        if st is None:
            lam *= 10
            continue
        dc, dp = st
        R_n = prob.a.mm(aa_to_R(dc[:, :3]), R)
        t_n, X_n = t + dc[:, 3:], X + dp
        c_n, Jc_n, Jp_n, r_n = prob.linearize(R_n, t_n, X_n)
        if bool(torch.isfinite(c_n)) and float(c_n) < float(cost):
            rel = (float(cost) - float(c_n)) / float(cost)
            R, t, X, cost, Jc, Jp, r = R_n, t_n, X_n, c_n, Jc_n, Jp_n, r_n
            lam, accepted = max(lam / 3, 1e-12), accepted + 1
            if rel < rtol:
                break
        else:
            lam *= 10
            if lam > 1e8:
                break
    return R, t, X, {"cost0": cost0, "cost": float(cost), "iters": it,
                     "accepted": accepted}


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def newton_decrements(J, r, index, n):
    """Per block i of n: sqrt(g_i^T H_i^-1 g_i), g_i and H_i the gradient
    and Gauss-Newton block of the cost in block i alone (J [N, 2, d] the
    observations' Jacobians in it, index [N] their block); NaN for a block
    no observation moves."""
    d = J.shape[-1]
    H = torch.zeros((n, d, d), dtype=J.dtype, device=J.device).index_add_(
        0, index, J.transpose(1, 2) @ J)
    g = torch.zeros((n, d), dtype=J.dtype, device=J.device).index_add_(
        0, index, (J.transpose(1, 2) @ r[..., None])[..., 0])
    moved = torch.diagonal(H, dim1=1, dim2=2).sum(-1) > 0
    out = torch.full((n,), float("nan"), dtype=J.dtype, device=J.device)
    step = torch.linalg.solve(H[moved], g[moved][..., None])[..., 0]
    out[moved] = torch.sqrt((g[moved] * step).sum(-1).clamp(min=0))
    return out


def compare(prob64, ref, cams, pts):
    """The numbers that decide a solve, program solution (`cams` [K, 6],
    `pts` [L, 3], any float dtype) against the reference solution `ref`
    (R, t, X from `solve` on the float64 problem `prob64`):

    - cost_excess: (cost(program) - cost(reference)) / cost(reference),
      both costs in float64;
    - reproj_gap_rms_px: the root mean square over observations of the
      distance between an observation's pixel as the program's solution
      predicts it and as the reference's does;
    - cam_gap: the largest over free cameras, and pt_gap_rms: the root mean
      square over landmarks, of the block's Newton decrement at the
      program's solution, sqrt(g^T H^-1 g), with g and H the gradient and
      Gauss-Newton block of the cost in that camera (landmark) alone,
      everything else held at the program's values (units of the pixel
      noise): how far the camera (landmark) lies from where the problem
      puts it given the rest. Half the landmarks' squared decrements
      summed is the cost they could still shed. It needs no alignment.

    The landmarks and pixels are taken by their root mean square, the
    cameras by the largest: once converged, the program's float32 LM
    accepts steps that lower its cost by rounding, and these move a few
    weakly seen landmarks (a short baseline, at 4-8 m) by up to 0.07 px,
    so their largest gap swings by two orders from solve to solve, while
    the root mean square and the cameras hold steady.
    """
    R_r, t_r, X_r = ref
    dt, dev = torch.float64, prob64.device
    cams = torch.as_tensor(cams, device=dev).to(dt)
    R_p, t_p = aa_to_R(cams[:, :3]), cams[:, 3:]
    X_p = torch.as_tensor(pts, device=dev).to(dt)
    c_ref = prob64.cost(R_r, t_r, X_r)
    c_prog = prob64.cost(R_p, t_p, X_p)
    gap_px = torch.linalg.norm(prob64.project(R_p, t_p, X_p)
                               - prob64.project(R_r, t_r, X_r), dim=-1)
    _, Jc, Jp, r = prob64.linearize(R_p, t_p, X_p)
    cam_gap = newton_decrements(Jc, r, prob64.cam, prob64.K)[prob64.free].nan_to_num(0)
    pt_gap = newton_decrements(Jp, r, prob64.pt, prob64.L)
    pt_gap = pt_gap[~torch.isnan(pt_gap)]
    return {"cost_excess": float((c_prog - c_ref) / c_ref),
            "reproj_gap_rms_px": float(torch.sqrt((gap_px * gap_px).mean())),
            "cam_gap": float(cam_gap.max()),
            "pt_gap_rms": float(torch.sqrt((pt_gap * pt_gap).mean()))}
