"""Two-view relative pose: vectorized RANSAC for Essential & Homography.

Port of `bundleadjustment_tpu/geometry/epipolar.py`. A fixed batch of minimal
samples is drawn, all hypotheses are solved with one batched SVD and scored
against all correspondences with one [B, N] computation, and the argmax is
refit twice on its inliers: static shapes, no data-dependent control flow.

Essential: normalized 8-point algorithm + projection onto the essential
manifold; decomposition to 4 (R, t) candidates with cheirality voting.
Homography: normalized 4-point DLT; Faugeras SVD decomposition to 8
candidates with cheirality + plane-normal disambiguation.

Everything is float32 on the device of the inputs. The batched SVDs, `eigh`,
`inv` and `det` go to `torch.linalg`, as the reference leaves them to XLA:
no hand-written kernel is inside.

Randomness: the reference draws its samples from a JAX key; those bits
cannot be reproduced here. Every estimator takes a `torch.Generator` (on the
CPU, so that a run on the card and a run on the CPU draw the same samples)
and, instead of it, the sample indices themselves (`idx`, `idx_e`, `idx_h`),
which is how a test feeds both packages the same samples.

SVD / eigh conventions: null vectors come back with either sign. E is
defined up to sign (the four-way decomposition absorbs it), H is divided by
H[2,2], and triangulated points divide the sign out.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from bundleadjustment_tpu_torch.geometry.se3 import rotmat_to_aa

CHI2_E = 3.841  # 95% chi2, 1 dof: point-to-epipolar-line distance
CHI2_H = 5.991  # 95% chi2, 2 dof: symmetric transfer
SCORE_GAMMA_E = 5.991  # ORB-SLAM truncated score offsets
SCORE_GAMMA_H = 5.991


@dataclass
class TwoViewResult:
    rt6: torch.Tensor  # [6] relative world->camera transform (frame1 -> frame2)
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # int32
    used_homography: torch.Tensor  # bool
    score_ratio: torch.Tensor  # SH / (SH + SE)
    E: torch.Tensor  # [3,3] best essential
    H: torch.Tensor  # [3,3] best homography
    ok: torch.Tensor  # bool: the chosen model passed the acceptance (E-path
    #   with more than min_e_inliers cheirality-positive points, or an H
    #   decomposition that keeps a candidate)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _normalize_points(uv, valid):
    """Hartley normalization: zero-mean, mean distance sqrt(2). Returns (x, T)."""
    n = torch.clamp(valid.sum(), min=1)
    zero = torch.zeros((), dtype=uv.dtype, device=uv.device)
    mean = torch.where(valid[:, None], uv, zero).sum(0) / n
    d = torch.where(valid, torch.linalg.norm(uv - mean, dim=-1), zero)
    s = 2.0 ** 0.5 / torch.clamp(d.sum() / n, min=1e-9)
    one = torch.ones_like(s)
    T = torch.stack([torch.stack([s, zero, -s * mean[0]]),
                     torch.stack([zero, s, -s * mean[1]]),
                     torch.stack([zero, zero, one])])
    return (uv - mean) * s, T


def sample_indices(generator, valid, n_hyp, sample_size):
    """[n_hyp, sample_size] int64 indices drawn with replacement from the
    valid correspondences, on valid's device. The draw itself runs on the
    generator's device (the CPU)."""
    p = valid.to(device=generator.device, dtype=torch.float32)
    if not bool(p.any()):
        return torch.zeros((n_hyp, sample_size), dtype=torch.int64,
                           device=valid.device)
    idx = torch.multinomial(p.expand(n_hyp, -1), sample_size, replacement=True,
                            generator=generator)
    return idx.to(valid.device)


def _pixels_to_normalized(uv, K4):
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    return torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[:, :1])], -1)


# ---------------------------------------------------------------------------
# Essential matrix
# ---------------------------------------------------------------------------


def _epipolar_rows(x1, x2):
    """Rows of x2^T F x1 = 0: [..., 9]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], -1)


def _eight_point(x1, x2):
    """Batched normalized 8-point. x1, x2: [B, 8, 2] -> E_norm [B, 3, 3]."""
    A = _epipolar_rows(x1, x2)  # [B, 8, 9]
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return vt[..., 8, :].reshape(-1, 3, 3)


def _fit_nullvec_weighted(A, w):
    """Smallest eigenvector of sum_i w_i a_i a_i^T (A: [N, 9], w: [N])."""
    M = (A * w[:, None]).T @ A
    _, vecs = torch.linalg.eigh(M)
    return vecs[:, 0]


def _eight_point_all(x1, x2, w):
    """Weighted least-squares epipolar fit over ALL correspondences."""
    return _fit_nullvec_weighted(_epipolar_rows(x1, x2), w).reshape(3, 3)


def _project_to_essential(E):
    """Project onto the essential manifold: singular values -> (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device))
    return U @ d @ Vt


def _epipolar_chi2(E, x1h, x2h, inv_sigma2):
    """Squared point-to-epipolar-line distances both ways, scaled. [B, N]."""
    l2 = torch.einsum("bij,nj->bni", E, x1h)  # line in image 2
    l1 = torch.einsum("bji,nj->bni", E, x2h)  # line in image 1
    num = torch.einsum("ni,bni->bn", x2h, l2) ** 2
    d2_2 = num / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d2_1 = num / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d2_1 * inv_sigma2, d2_2 * inv_sigma2


def _truncated_score(d1, d2, valid, chi2, gamma):
    """ORB-SLAM score: sum over inliers (both chi2 under the threshold) of
    (gamma - d1) + (gamma - d2). Returns (score [...], inlier mask [..., N])."""
    ok = (d1 < chi2) & (d2 < chi2) & valid
    score = torch.where(ok, (gamma - d1) + (gamma - d2),
                        torch.zeros_like(d1)).sum(-1)
    return score, ok


def estimate_essential(generator, uv1, uv2, valid, K4, n_hyp=256, sigma=1.0,
                       idx=None):
    """RANSAC essential matrix in normalized camera coordinates.

    `idx` [n_hyp, 8] are the minimal samples; None draws them from
    `generator`. Returns (E [3,3], score, inliers [N])."""
    x1 = _pixels_to_normalized(uv1, K4)
    x2 = _pixels_to_normalized(uv2, K4)
    if idx is None:
        idx = sample_indices(generator, valid, n_hyp, 8)
    E = _project_to_essential(_eight_point(x1[idx], x2[idx]))

    x1h, x2h = _homogeneous(x1), _homogeneous(x2)
    # sigma in pixels -> normalized units (approx using fx)
    inv_sigma2 = (K4[0] / sigma) ** 2
    d1, d2 = _epipolar_chi2(E, x1h, x2h, inv_sigma2)
    score, ok = _truncated_score(d1, d2, valid[None, :], CHI2_E, SCORE_GAMMA_E)
    best = torch.argmax(score)

    # local optimization: refit on the best hypothesis' inliers (2 rounds)
    E_best, inl, score_best = E[best], ok[best], score[best]
    for _ in range(2):
        E_ref = _project_to_essential(_eight_point_all(x1, x2, inl.to(x1.dtype)))
        d1r, d2r = _epipolar_chi2(E_ref[None], x1h, x2h, inv_sigma2)
        score_r, ok_r = _truncated_score(d1r[0], d2r[0], valid, CHI2_E,
                                         SCORE_GAMMA_E)
        better = score_r >= score_best
        E_best = torch.where(better, E_ref, E_best)
        inl = torch.where(better, ok_r, inl)
    return E_best, torch.maximum(score_best, score_r), inl


def _triangulate_cheirality(R, t, x1, x2, inliers):
    """For each candidate motion (R [C,3,3], t [C,3]): linear two-view
    triangulation in normalized coordinates and the inliers with positive
    depth in both views. Returns (count [C], X [C,N,3], good [C,N])."""
    C, N = R.shape[0], x1.shape[0]
    P2 = torch.cat([R, t[..., None]], -1)  # [C, 3, 4]
    P1 = torch.eye(3, 4, dtype=R.dtype, device=R.device)
    r0 = (x1[:, 0, None] * P1[2] - P1[0]).expand(C, N, 4)
    r1 = (x1[:, 1, None] * P1[2] - P1[1]).expand(C, N, 4)
    r2 = x2[None, :, 0, None] * P2[:, None, 2] - P2[:, None, 0]
    r3 = x2[None, :, 1, None] * P2[:, None, 2] - P2[:, None, 1]
    rows = torch.stack([r0, r1, r2, r3], 2)  # [C, N, 4, 4]
    _, _, vt = torch.linalg.svd(rows)
    Xh = vt[..., 3, :]
    w = torch.where(torch.abs(Xh[..., 3]) < 1e-12,
                    torch.full_like(Xh[..., 3], 1e-12), Xh[..., 3])
    X = Xh[..., :3] / w[..., None]
    z1 = X[..., 2]
    z2 = (X * R[:, None, 2]).sum(-1) + t[:, None, 2]
    # parallax guard: reject points at infinity
    finite = torch.all(torch.abs(X) < 1e4, dim=-1)
    good = inliers[None, :] & (z1 > 0) & (z2 > 0) & finite
    return good.sum(-1), X, good


def decompose_essential(E, uv1, uv2, valid, K4):
    """4-way (R, t) decomposition + cheirality vote.

    Returns (rt6 [6] relative transform frame1->frame2 in world->cam sense,
    n_good, points [N,3] triangulated in frame1, good_mask [N])."""
    x1 = _pixels_to_normalized(uv1, K4)
    x2 = _pixels_to_normalized(uv2, K4)
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))  # enforce det +1
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    counts, Xs, goods = _triangulate_cheirality(cands_R, cands_t, x1, x2, valid)
    best = torch.argmax(counts)
    rt = torch.cat([rotmat_to_aa(cands_R[best]), cands_t[best]])
    return rt, counts[best], Xs[best], goods[best]


# ---------------------------------------------------------------------------
# Homography
# ---------------------------------------------------------------------------


def _dlt_rows(x1, x2):
    """The two DLT rows of each correspondence: ([..., 9], [..., 9])."""
    u, v = x1[..., 0], x1[..., 1]
    up, vp = x2[..., 0], x2[..., 1]
    zeros = torch.zeros_like(u)
    ones = torch.ones_like(u)
    r1 = torch.stack([-u, -v, -ones, zeros, zeros, zeros, up * u, up * v, up], -1)
    r2 = torch.stack([zeros, zeros, zeros, -u, -v, -ones, vp * u, vp * v, vp], -1)
    return r1, r2


def _four_point_h(x1, x2):
    """Batched 4-point DLT homography. x1, x2: [B, 4, 2] -> H [B, 3, 3]."""
    A = torch.cat(_dlt_rows(x1, x2), dim=1)  # [B, 8, 9]
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return vt[..., 8, :].reshape(x1.shape[0], 3, 3)


def _safe_div(x, eps=1e-12):
    """x with entries of magnitude below eps replaced by eps (a divisor)."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def _homography_chi2(H, uv1h, uv2h, inv_sigma2):
    """Symmetric transfer chi2 [B, N] both directions."""
    Hx1 = torch.einsum("bij,nj->bni", H, uv1h)
    e12 = ((Hx1[..., :2] / _safe_div(Hx1[..., 2])[..., None]
            - uv2h[None, :, :2]) ** 2).sum(-1)
    Hinv = torch.linalg.inv(H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device))
    Hx2 = torch.einsum("bij,nj->bni", Hinv, uv2h)
    e21 = ((Hx2[..., :2] / _safe_div(Hx2[..., 2])[..., None]
            - uv1h[None, :, :2]) ** 2).sum(-1)
    return e21 * inv_sigma2, e12 * inv_sigma2


def estimate_homography(generator, uv1, uv2, valid, n_hyp=256, sigma=1.0,
                        idx=None):
    """RANSAC homography in pixel coordinates with Hartley normalization.

    `idx` [n_hyp, 4] are the minimal samples; None draws them from
    `generator`. Returns (H [3,3] with H[2,2] = 1, score, inliers [N])."""
    x1n, T1 = _normalize_points(uv1, valid)
    x2n, T2 = _normalize_points(uv2, valid)
    if idx is None:
        idx = sample_indices(generator, valid, n_hyp, 4)
    Hn = _four_point_h(x1n[idx], x2n[idx])
    T2inv = torch.linalg.inv(T2)
    H = T2inv[None] @ Hn @ T1[None]  # denormalize
    H = H / _safe_div(H[:, 2:3, 2:3])

    uv1h, uv2h = _homogeneous(uv1), _homogeneous(uv2)
    inv_sigma2 = 1.0 / (sigma * sigma)
    d1, d2 = _homography_chi2(H, uv1h, uv2h, inv_sigma2)
    score, ok = _truncated_score(d1, d2, valid[None, :], CHI2_H, SCORE_GAMMA_H)
    best = torch.argmax(score)

    # local optimization: weighted DLT refit on the inliers (normalized coords)
    H_best, inl, score_best = H[best], ok[best], score[best]
    A = torch.cat(_dlt_rows(x1n, x2n), dim=0)  # [2N, 9]
    for _ in range(2):
        w = inl.to(uv1.dtype)
        Hn_ref = _fit_nullvec_weighted(A, torch.cat([w, w])).reshape(3, 3)
        H_ref = T2inv @ Hn_ref @ T1
        H_ref = H_ref / _safe_div(H_ref[2, 2])
        d1r, d2r = _homography_chi2(H_ref[None], uv1h, uv2h, inv_sigma2)
        score_r, ok_r = _truncated_score(d1r[0], d2r[0], valid, CHI2_H,
                                         SCORE_GAMMA_H)
        better = score_r >= score_best
        H_best = torch.where(better, H_ref, H_best)
        inl = torch.where(better, ok_r, inl)
    return H_best, torch.maximum(score_best, score_r), inl


def decompose_homography(H, uv1, uv2, valid, K4):
    """Faugeras SVD homography decomposition + cheirality/visibility vote.

    Produces the 8 candidate motions of K^-1 H K and picks the one with the
    most in-front points whose plane normal faces the camera. Returns
    (rt6, n_good, points, good_mask)."""
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
                     torch.stack([zero, zero, one])]).to(H.dtype)
    Kinv = torch.stack([torch.stack([1 / fx, zero, -cx / fx]),
                        torch.stack([zero, 1 / fy, -cy / fy]),
                        torch.stack([zero, zero, one])]).to(H.dtype)
    A = Kinv @ H @ K
    s = torch.linalg.svdvals(A)
    A = A / torch.clamp(s[1], min=1e-12)  # normalize by the middle singular value
    U, s, Vt = torch.linalg.svd(A)
    d1, d2, d3 = s[0], s[1], s[2]
    V = Vt.T
    detUV = torch.linalg.det(U) * torch.linalg.det(V)

    # Faugeras: x1 = +-sqrt((d1^2-d2^2)/(d1^2-d3^2)), x3 = +-sqrt((d2^2-d3^2)/(d1^2-d3^2))
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1v = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3v = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    # 8 candidates: d' = +d2 with the four sign pairs, then d' = -d2
    sgn = torch.tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]] * 2,
                       dtype=H.dtype, device=H.device)
    plus = torch.arange(8, device=H.device) < 4
    x1, x3 = sgn[:, 0] * x1v, sgn[:, 1] * x3v
    d2m = torch.clamp(d2, min=1e-12)
    # closed-form rotation about the y-axis:
    # d' = +d2: sin = (d1-d3) x1 x3 / d2, cos = (d1 x3^2 + d3 x1^2) / d2
    # d' = -d2: sin = (d1+d3) x1 x3 / d2, cos = (d3 x1^2 - d1 x3^2) / d2
    sin_t = torch.where(plus, (d1 - d3) * x1 * x3 / d2m, (d1 + d3) * x1 * x3 / d2m)
    cos_t = torch.where(plus, (d1 * x3 * x3 + d3 * x1 * x1) / d2m,
                        (d3 * x1 * x1 - d1 * x3 * x3) / d2m)
    z8, o8 = torch.zeros_like(x1), torch.ones_like(x1)
    Rp_plus = torch.stack([torch.stack([cos_t, z8, -sin_t], -1),
                           torch.stack([z8, o8, z8], -1),
                           torch.stack([sin_t, z8, cos_t], -1)], -2)
    Rp_minus = torch.stack([torch.stack([cos_t, z8, sin_t], -1),
                            torch.stack([z8, -o8, z8], -1),
                            torch.stack([sin_t, z8, -cos_t], -1)], -2)
    Rp = torch.where(plus[:, None, None], Rp_plus, Rp_minus)
    tp = torch.where(plus[:, None],
                     (d1 - d3) * torch.stack([x1, z8, -x3], -1),
                     (d1 + d3) * torch.stack([x1, z8, x3], -1))
    np_ = torch.stack([x1, z8, x3], -1)
    Rs = detUV * (U @ Rp @ Vt)  # [8, 3, 3]
    ts = tp @ U.T  # [8, 3]
    ns = np_ @ V.T

    x1n = _pixels_to_normalized(uv1, K4)
    x2n = _pixels_to_normalized(uv2, K4)
    tns = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    cnt, Xs, goods = _triangulate_cheirality(Rs, tns, x1n, x2n, valid)
    # cheirality dominates; plane-normal-facing-camera breaks ties
    counts = cnt * 2 + (ns[:, 2] < 0).to(cnt.dtype)
    best = torch.argmax(counts)
    rt = torch.cat([rotmat_to_aa(Rs[best]), tns[best]])
    return rt, goods[best].sum(), Xs[best], goods[best]


# ---------------------------------------------------------------------------
# Combined recoverPose
# ---------------------------------------------------------------------------


def recover_pose_two_view(generator, uv1, uv2, valid, K4, n_hyp=256, sigma=1.0,
                          h_ratio=0.4, min_e_inliers=100, idx_e=None,
                          idx_h=None):
    """Full two-view model selection + pose recovery.

    Computes both the E and the H score; if SH / (SH + SE) > h_ratio the
    homography decomposition is used, else the essential one. `ok` is False
    when the chosen model fails the acceptance: an E-path with at most
    min_e_inliers cheirality-positive inliers, or an H decomposition with no
    surviving candidate; callers then fall back (constant velocity / failed
    initialisation).

    uv1, uv2 [N,2] float32 pixels, valid [N] bool, K4 [4], all on one device.
    `idx_e` [n_hyp,8] and `idx_h` [n_hyp,4] are the minimal samples; where one
    is None it is drawn from `generator` (E first, then H). Returns
    TwoViewResult; `rt6` maps frame-1 camera coordinates to frame-2 camera
    coordinates (chain with the previous pose at the call site)."""
    if idx_e is None:
        idx_e = sample_indices(generator, valid, n_hyp, 8)
    if idx_h is None:
        idx_h = sample_indices(generator, valid, n_hyp, 4)
    E, score_e, inl_e = estimate_essential(None, uv1, uv2, valid, K4, n_hyp,
                                           sigma, idx=idx_e)
    H, score_h, inl_h = estimate_homography(None, uv1, uv2, valid, n_hyp, sigma,
                                            idx=idx_h)
    ratio = score_h / torch.clamp(score_h + score_e, min=1e-9)
    use_h = ratio > h_ratio

    rt_e, n_e, _, good_e = decompose_essential(E, uv1, uv2, inl_e, K4)
    rt_h, n_h, _, good_h = decompose_homography(H, uv1, uv2, inl_h, K4)
    return TwoViewResult(
        rt6=torch.where(use_h, rt_h, rt_e),
        inliers=torch.where(use_h, good_h, good_e),
        n_inliers=torch.where(use_h, n_h, n_e).to(torch.int32),
        used_homography=use_h,
        score_ratio=ratio,
        E=E,
        H=H,
        ok=torch.where(use_h, n_h > 0, n_e > min_e_inliers),
    )
