"""Plain reference of bundle adjustment with BAL's camera, in float64.

It imports torch and numpy only: nothing of the program under test and
nothing of the JAX package. It works on the flat observation table (camera,
landmark, pixel, variance per observation), never on the program's dense
layout, and writes the camera's equations as Snavely's reprojection error
states them (Agarwal, Snavely, Seitz, Szeliski, "Bundle Adjustment in the
Large", ECCV 2010; Ceres's `SnavelyReprojectionError`), in BAL's own axes:

    P = R(w) X + t,  p = -P_xy / P_z,  r = 1 + k1 |p|^2 + k2 |p|^4,
    u_hat = f r p,   residual = (u_hat - u) / sigma,

a camera being the nine numbers (w, t, f, k1, k2) and u in pixels about the
principal point. The Jacobians come from `torch.func.jacrev` of that
function, as Ceres differentiates the error automatically, so nothing is
shared with a Jacobian written out by hand.

The cost is the program's: the Huber function at `huber_delta` of each
whitened residual's norm, and `cheirality_penalty` instead for an
observation whose point lies at depth -P_z <= 1e-6 (behind the camera).
`solve` is Levenberg-Marquardt with the exact Schur complement over the
landmarks and a dense Cholesky of the camera system, Huber by iteratively
reweighted least squares; every camera parameter moves additively (as Ceres
moves BAL's), the fixed cameras not at all.

`precision="tf32"` is the control: the same solve in float32 with the
operands of every matrix product rounded to TF32 (10 mantissa bits), as
`allow_tf32` would compute them. PyTorch's own TF32 switches stay off, so
only those roundings differ.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAIR_CHUNK = 1 << 20  # observation pairs a block product takes at once
D = 9  # parameters a camera


def round_tf32(x):
    """float32 -> a TF32 value (10 mantissa bits), as float32: Veltkamp's
    split at 13 bits, in arithmetic alone, so that vmap and jacrev pass
    through it (its derivative is exactly 1)."""
    c = x * 8193.0
    return c - (c - x)


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


def rotate(w, X, mm=torch.matmul):
    """R(w) X for an axis-angle w [3] and a point X [3] (Rodrigues, with the
    first-order form near w = 0, as Ceres's AngleAxisRotatePoint)."""
    th2 = (w * w).sum()
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    k = w / th
    c, s = torch.cos(th), torch.sin(th)
    Kmat = torch.stack([torch.zeros_like(th), -k[2], k[1], k[2], torch.zeros_like(th),
                        -k[0], -k[1], k[0], torch.zeros_like(th)]).reshape(3, 3)
    R = c * torch.eye(3, dtype=w.dtype, device=w.device) + s * Kmat + (1 - c) * torch.outer(k, k)
    full = mm(R, X[:, None])[:, 0]
    small = X + torch.linalg.cross(w, X)
    return torch.where(th2 > 1e-12, full, small)


def residual(cam, X, uv, isig, mm=torch.matmul):
    """Snavely's whitened reprojection error [2] of point X [3] in camera
    cam [9] = (w, t, f, k1, k2), and the point's depth -P_z."""
    P = rotate(cam[:3], X, mm) + cam[3:6]
    p = -P[:2] / P[2]
    n2 = (p * p).sum()
    r = 1.0 + cam[7] * n2 + cam[8] * n2 * n2
    return (cam[6] * r * p - uv) * isig, -P[2]


class Problem:
    """The flat observation table on a device, in the solve's dtype, with
    the ordered pairs of free-camera observations that share a landmark."""

    def __init__(self, cam_idx, pt_idx, uv, sigma2, cam_fixed, n_points, device,
                 arith, *, huber_delta, cheirality_penalty):
        self.a = arith
        self.delta = huber_delta
        self.penalty = cheirality_penalty
        dt = arith.dtype
        self.device = torch.device(device)
        t = lambda x, d: torch.as_tensor(np.asarray(x), dtype=d, device=self.device)  # noqa: E731
        self.cam = t(cam_idx, torch.int64)
        self.pt = t(pt_idx, torch.int64)
        self.uv = t(uv, dt)
        self.isig = 1.0 / torch.sqrt(t(sigma2, dt))
        self.cam_fixed = t(cam_fixed, torch.bool)
        self.K = int(self.cam_fixed.shape[0])
        self.L = int(n_points)
        cam = np.asarray(cam_idx, np.int64)
        pt = np.asarray(pt_idx, np.int64)
        free = ~np.asarray(cam_fixed, bool)[cam]
        idx = np.flatnonzero(free)
        order = idx[np.argsort(pt[idx], kind="stable")]
        p = pt[order]
        starts = (np.flatnonzero(np.r_[True, p[1:] != p[:-1]]) if len(p)
                  else np.zeros(0, np.int64))
        sizes = np.diff(np.r_[starts, len(p)])
        sq = sizes * sizes
        base, n = np.repeat(starts, sq), np.repeat(sizes, sq)
        q = np.arange(len(base)) - np.repeat(np.cumsum(sq) - sq, sq)
        self.pair_a = torch.as_tensor(order[base + q // n], device=self.device)
        self.pair_b = torch.as_tensor(order[base + q % n], device=self.device)
        self.free = torch.as_tensor(np.flatnonzero(~np.asarray(cam_fixed, bool)),
                                    device=self.device)

    def _res(self, cam, X, uv, isig):
        return residual(cam, X, uv, isig, self.a.mm)

    def residuals(self, cams, X):
        """Whitened residuals [N, 2] and depths [N]."""
        return torch.func.vmap(self._res)(cams[self.cam], X[self.pt], self.uv, self.isig)

    def cost_terms(self, r, depth):
        n = torch.linalg.norm(r, dim=-1)
        rho = torch.where(n <= self.delta, 0.5 * n * n, self.delta * (n - 0.5 * self.delta))
        return torch.where(depth > 1e-6, rho, torch.full_like(rho, self.penalty))

    def cost(self, cams, X):
        return self.cost_terms(*self.residuals(cams, X)).sum()

    def project(self, cams, X):
        """Predicted pixels [N, 2]."""
        r, _ = self.residuals(cams, X)
        return r / self.isig[:, None] + self.uv

    def linearize(self, cams, X):
        """Cost, and the IRLS-weighted Jacobians of every observation by
        jacrev: Jc [N, 2, 9], Jp [N, 2, 3], residuals r [N, 2]."""
        r, depth = self.residuals(cams, X)
        rho = self.cost_terms(r, depth)
        jac = torch.func.vmap(torch.func.jacrev(
            lambda c, x, u, s: self._res(c, x, u, s)[0], argnums=(0, 1)))
        Jc, Jp = jac(cams[self.cam], X[self.pt], self.uv, self.isig)
        n = torch.linalg.norm(r, dim=-1).clamp(min=1e-12)
        w = torch.where(n <= self.delta, torch.ones_like(n), self.delta / n)
        w = torch.where(depth > 1e-6, w, torch.zeros_like(w))
        sw = torch.sqrt(w)[:, None, None]
        Jc = torch.where(self.cam_fixed[self.cam][:, None, None], torch.zeros_like(Jc),
                         Jc * sw)
        return rho.sum(), Jc, Jp * sw, r * sw[..., 0]

    def schur_system(self, Jc, Jp, r, lam):
        """The damped Schur system over the landmarks at Jacobians Jc
        [N, 2, 9], Jp [N, 2, 3] and residuals r [N, 2]: S [K, K, 9, 9]
        (block (k, k') = U_k [k = k'] - sum W_a V^-1 W_b^T over the pairs of
        observations a of k and b of k' of one landmark), b [K, 9], and W
        [N, 9, 3], V^-1 [L, 3, 3], g_p [L, 3] for the back-substitution.
        U and V carry Marquardt's damping lam * max(diag, 1e-6); a landmark
        that nothing observes has V = I."""
        mm, dt, dev = self.a.mm, self.a.dtype, self.device
        K, L = self.K, self.L
        JcT, JpT = Jc.transpose(1, 2), Jp.transpose(1, 2)
        U = torch.zeros((K, D, D), dtype=dt, device=dev).index_add_(0, self.cam, mm(JcT, Jc))
        gc = torch.zeros((K, D), dtype=dt, device=dev).index_add_(
            0, self.cam, mm(JcT, r[..., None])[..., 0])
        V = torch.zeros((L, 3, 3), dtype=dt, device=dev).index_add_(0, self.pt, mm(JpT, Jp))
        gp = torch.zeros((L, 3), dtype=dt, device=dev).index_add_(
            0, self.pt, mm(JpT, r[..., None])[..., 0])
        W = mm(JcT, Jp)  # [N, 9, 3]
        eyeD = torch.eye(D, dtype=dt, device=dev)
        eye3 = torch.eye(3, dtype=dt, device=dev)
        U = U + lam * torch.diagonal(U, dim1=1, dim2=2).clamp(min=1e-6)[..., None] * eyeD
        V = V + lam * torch.diagonal(V, dim1=1, dim2=2).clamp(min=1e-6)[..., None] * eye3
        has = torch.zeros(L, dtype=torch.bool, device=dev)
        has[self.pt] = True
        V = torch.where(has[:, None, None], V, eye3)
        Vinv = torch.linalg.inv(V)
        Y = mm(W, Vinv[self.pt])  # [N, 9, 3]
        S = torch.zeros((K * K, D, D), dtype=dt, device=dev)
        for s in range(0, len(self.pair_a), PAIR_CHUNK):
            a, b = self.pair_a[s:s + PAIR_CHUNK], self.pair_b[s:s + PAIR_CHUNK]
            S.index_add_(0, self.cam[a] * K + self.cam[b], mm(Y[a], W[b].transpose(1, 2)))
        S = -S.reshape(K, K, D, D)
        S[torch.arange(K), torch.arange(K)] += U
        b = -(gc - torch.zeros((K, D), dtype=dt, device=dev).index_add_(
            0, self.cam, mm(Y, gp[self.pt][..., None])[..., 0]))
        return S, b, W, Vinv, gp

    def step(self, Jc, Jp, r, lam):
        """The damped Gauss-Newton step by the Schur complement over the
        landmarks: (dc [K, 9], dp [L, 3]), or None where the camera system
        is not positive definite."""
        mm, dt, dev = self.a.mm, self.a.dtype, self.device
        S, b, W, Vinv, gp = self.schur_system(Jc, Jp, r, lam)
        f = self.free
        Sf = S[f][:, f].permute(0, 2, 1, 3).reshape(D * len(f), D * len(f))
        Sf = 0.5 * (Sf + Sf.T)
        Lc, info = torch.linalg.cholesky_ex(Sf)
        if int(info) != 0:
            return None
        dc = torch.zeros((self.K, D), dtype=dt, device=dev)
        dc[f] = torch.cholesky_solve(b[f].reshape(-1, 1), Lc).reshape(-1, D)
        wdc = mm(W.transpose(1, 2), dc[self.cam][..., None])[..., 0]  # [N, 3]
        rhs = gp + torch.zeros((self.L, 3), dtype=dt, device=dev).index_add_(0, self.pt, wdc)
        dp = -mm(Vinv, rhs[..., None])[..., 0]
        return dc, dp


def solve(prob, cams0, pts0, max_iters=100, lam0=1e-4, rtol=1e-13, hold=()):
    """LM from (cams0 [K, 9], pts0 [L, 3]); returns (cams [K, 9], X [L, 3],
    info) in the problem's dtype. The camera parameters whose indices
    `hold` lists keep their start in every camera."""
    dt = prob.a.dtype
    cams = torch.as_tensor(cams0, device=prob.device).to(dt).clone()
    X = torch.as_tensor(pts0, device=prob.device).to(dt).clone()
    held = torch.zeros(D, dtype=torch.bool, device=prob.device)
    held[list(hold)] = True

    def linearize(c, x):
        cost, Jc, Jp, r = prob.linearize(c, x)
        return cost, torch.where(held, torch.zeros_like(Jc), Jc), Jp, r

    cost, Jc, Jp, r = linearize(cams, X)
    cost0, lam, accepted, it = float(cost), lam0, 0, 0
    for it in range(1, max_iters + 1):
        st = prob.step(Jc, Jp, r, lam)
        if st is None:
            lam *= 10
            continue
        dc, dp = st
        c_n, X_n = cams + torch.where(held, torch.zeros_like(dc), dc), X + dp
        cost_n, Jc_n, Jp_n, r_n = linearize(c_n, X_n)
        if bool(torch.isfinite(cost_n)) and float(cost_n) < float(cost):
            rel = (float(cost) - float(cost_n)) / float(cost)
            cams, X, cost, Jc, Jp, r = c_n, X_n, cost_n, Jc_n, Jp_n, r_n
            lam, accepted = max(lam / 3, 1e-12), accepted + 1
            if rel < rtol:
                break
        else:
            lam *= 10
            if lam > 1e8:
                break
    return cams, X, {"cost0": cost0, "cost": float(cost), "iters": it,
                     "accepted": accepted}
