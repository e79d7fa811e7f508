"""Multi-scale feature detection + oriented binary descriptors on tensors.

Port of `bundleadjustment_tpu/ops/features.py:detect_and_describe`: FAST-16
corners gated and ranked by the Harris response over a 1.2-scale pyramid,
3x3 non-maximum suppression, sub-pixel refinement, intensity-centroid
orientation, and rotation-steered BRIEF-256 packed into 8 words per
keypoint (int32 tensors holding the reference's uint32 bit patterns).

Numerics follow the reference op by op: the separable filters are shifted
slices with weighted adds (no convolution, so no cuDNN path), the pyramid
resize is two float32 matrix products with the same antialiased linear
weights `jax.image.resize` uses, and the top-k is an exact selection that
ranks equal scores lowest index first (a stable descending sort), as
`lax.top_k` does. The BRIEF pattern comes from numpy with seed 1234, like
the reference's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class FeatureConfig:
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0 / 255.0
    harris_k: float = 0.04
    detector: str = "fast_harris"  # "fast_harris" | "harris" | "shi_tomasi"
    border: int = 16


@dataclass
class Features:
    xy: torch.Tensor  # [M, 2] level-0 pixel coordinates (x, y)
    response: torch.Tensor  # [M]
    octave: torch.Tensor  # [M] int32
    angle: torch.Tensor  # [M]
    sigma2: torch.Tensor  # [M]
    desc: torch.Tensor  # [M, 8] int32 packed 256-bit descriptors
    valid: torch.Tensor  # [M] bool


_FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)


def brief_pattern(n_bits=256, patch=31, seed=1234):
    """Seeded Gaussian BRIEF sampling pattern [n_bits, 4] = (x1, y1, x2, y2)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, patch / 5.0, size=(n_bits, 4))
    lim = patch // 2 - 2
    return np.clip(pts, -lim, lim).astype(np.float32)


_BRIEF = brief_pattern()


def _disc_offsets(radius=15):
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = (ys * ys + xs * xs) <= radius * radius
    return ys[mask].astype(np.int64), xs[mask].astype(np.int64)


_ORI_DY, _ORI_DX = _disc_offsets()


def _gauss_kernel(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _corr1d(img, kernel, dim):
    """1D cross-correlation with zero 'same' padding along `dim`, as shifted
    slices and weighted adds in tap order (zero taps skipped)."""
    k = np.asarray(kernel, np.float32)
    r = (k.shape[0] - 1) // 2
    n = img.shape[dim]
    dim = dim % img.dim()
    pad = [0, 0] * (img.dim() - dim - 1) + [r, r]
    xp = F.pad(img, pad)
    out = torch.zeros_like(img)
    for i in range(k.shape[0]):
        if k[i] == 0.0:
            continue
        out = out + float(k[i]) * xp.narrow(dim, i, n)
    return out


def _sep_conv(img, kernel):
    return _corr1d(_corr1d(img, kernel, -1), kernel, -2)


def gaussian_blur(img, sigma=2.0, radius=3):
    return _sep_conv(img, _gauss_kernel(sigma, radius))


def harris_response(img, k=0.04, window_sigma=1.5):
    """Harris response map and Shi-Tomasi min-eigenvalue map."""
    ix = _corr1d(_corr1d(img, [-1.0, 0.0, 1.0], 1), [1.0, 2.0, 1.0], 0)
    iy = _corr1d(_corr1d(img, [-1.0, 0.0, 1.0], 0), [1.0, 2.0, 1.0], 1)
    s = _sep_conv(torch.stack([ix * ix, iy * iy, ix * iy]), _gauss_kernel(window_sigma, 3))
    sxx, syy, sxy = s[0], s[1], s[2]
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    half = 0.5 * tr
    shi = half - torch.sqrt(torch.clamp(half * half - det, min=0.0))
    return det - k * tr * tr, shi


def fast_corners(img, threshold):
    """FAST-16: >= 9 contiguous circle pixels all brighter or all darker."""
    shifted = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
                           for dy, dx in _FAST_CIRCLE])
    bright = shifted > (img + threshold)[None]
    dark = shifted < (img - threshold)[None]
    weights = (1 << torch.arange(16, dtype=torch.int64, device=img.device))

    def contiguous9(m):
        code = torch.sum(m.to(torch.int64) * weights[:, None, None], 0)
        y = code | (code << 16)
        for _ in range(8):
            y = y & (y >> 1)
        return (y & 0xFFFF) != 0

    return contiguous9(bright) | contiguous9(dark)


@functools.lru_cache(maxsize=256)
def resize_matrix(dst, src):
    """[dst, src] antialiased linear-resize weights, the matrix
    `jax.image.resize(eye(src), (dst, src), "linear")` produces (triangle
    kernel widened by 1/scale when downsampling, columns normalised, samples
    outside the input zeroed), computed in float32 as JAX does."""
    scale = dst / src
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(dst, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.0) - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(src, dtype=np.float32)[:, None])
         / np.float32(kernel_scale))
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    tot = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    w = np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)
    return w.T.copy()  # [dst, src]


def _resize_linear(img, h_out, w_out):
    wh = torch.from_numpy(resize_matrix(h_out, img.shape[0])).to(img.device)
    ww = torch.from_numpy(resize_matrix(w_out, img.shape[1])).to(img.device)
    return (wh @ img) @ ww.T


def _nms3(score):
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= neigh


def orientation_angles(img_blur, ys, xs):
    """Intensity-centroid orientation over a radius-15 disc."""
    H, W = img_blur.shape
    dy = torch.from_numpy(_ORI_DY).to(img_blur.device)
    dx = torch.from_numpy(_ORI_DX).to(img_blur.device)
    yy = torch.clamp(ys[:, None] + dy[None, :], 0, H - 1)
    xx = torch.clamp(xs[:, None] + dx[None, :], 0, W - 1)
    patch = img_blur[yy, xx]
    m10 = torch.sum(patch * dx[None, :].to(patch.dtype), 1)
    m01 = torch.sum(patch * dy[None, :].to(patch.dtype), 1)
    return torch.atan2(m01, m10)


def pack_bits(bits):
    """[M, 256] {0,1} -> [M, 8] int32 words (bit i of word w = bit 32 w + i)."""
    b = bits.to(torch.int64).reshape(bits.shape[0], 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, -1)
    words = words - ((words >> 31) & 1) * (1 << 32)  # uint32 -> int32 bits
    return words.to(torch.int32)


def brief_descriptors(img_blur, ys, xs, angles):
    """Rotation-steered BRIEF-256, packed to [M, 8] int32."""
    H, W = img_blur.shape
    pat = torch.from_numpy(_BRIEF).to(img_blur.device)
    ca, sa = torch.cos(angles), torch.sin(angles)

    def rot(px, py):
        return (ca[:, None] * px[None] - sa[:, None] * py[None],
                sa[:, None] * px[None] + ca[:, None] * py[None])

    r1x, r1y = rot(pat[:, 0], pat[:, 1])
    r2x, r2y = rot(pat[:, 2], pat[:, 3])
    xf, yf = xs[:, None].to(torch.float32), ys[:, None].to(torch.float32)
    x1 = torch.clamp(torch.round(xf + r1x).to(torch.int64), 0, W - 1)
    y1 = torch.clamp(torch.round(yf + r1y).to(torch.int64), 0, H - 1)
    x2 = torch.clamp(torch.round(xf + r2x).to(torch.int64), 0, W - 1)
    y2 = torch.clamp(torch.round(yf + r2y).to(torch.int64), 0, H - 1)
    return pack_bits(img_blur[y1, x1] < img_blur[y2, x2])


def _top_k(flat, n):
    """Exact top-n, equal values ranked lowest index first."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:n], idx[:n]


def _detect_level(img, n_keep, cfg: FeatureConfig):
    H, W = img.shape
    harris, shi = harris_response(img, cfg.harris_k)
    ninf = torch.full_like(harris, -float("inf"))
    if cfg.detector == "fast_harris":
        score = torch.where(fast_corners(img, cfg.fast_threshold), harris, ninf)
    elif cfg.detector == "harris":
        score = harris
    elif cfg.detector == "shi_tomasi":
        score = shi
    else:
        raise ValueError(f"unknown detector {cfg.detector!r}")
    score = torch.where(_nms3(score), score, ninf)
    b = cfg.border
    inb = torch.zeros_like(score, dtype=torch.bool)
    inb[b:H - b, b:W - b] = True
    score = torch.where(inb, score, ninf)

    vals, idx = _top_k(score.reshape(-1), n_keep)
    ys = idx // W
    xs = idx % W
    valid = torch.isfinite(vals) & (vals > 0)

    # sub-pixel refinement: 1D quadratic fit on the raw response surface
    resp = harris if cfg.detector != "shi_tomasi" else shi
    ym = torch.clamp(ys - 1, 0, H - 1)
    yp = torch.clamp(ys + 1, 0, H - 1)
    xm = torch.clamp(xs - 1, 0, W - 1)
    xp = torch.clamp(xs + 1, 0, W - 1)
    c = resp[ys, xs]
    dxn = resp[ys, xp] - resp[ys, xm]
    dxd = 2.0 * (2.0 * c - resp[ys, xp] - resp[ys, xm])
    dyn = resp[yp, xs] - resp[ym, xs]
    dyd = 2.0 * (2.0 * c - resp[yp, xs] - resp[ym, xs])
    tiny = lambda d: torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)
    off_x = torch.clamp(dxn / tiny(dxd), -0.5, 0.5)
    off_y = torch.clamp(dyn / tiny(dyd), -0.5, 0.5)
    xs_f = xs.to(torch.float32) + off_x
    ys_f = ys.to(torch.float32) + off_y

    blur = gaussian_blur(img)
    angles = orientation_angles(blur, ys, xs)
    desc = brief_descriptors(blur, ys, xs, angles)
    return ys_f, xs_f, vals, angles, desc, valid


def level_allocations(cfg: FeatureConfig):
    """Per-level keypoint budget, geometric in 1/scale like ORB."""
    inv = 1.0 / cfg.scale_factor
    weights = np.array([inv**i for i in range(cfg.n_levels)])
    alloc = np.floor(cfg.n_features * weights / weights.sum()).astype(int)
    alloc[0] += cfg.n_features - alloc.sum()
    return [max(int(a), 8) for a in alloc]


def detect_and_describe(image, cfg: FeatureConfig = FeatureConfig()):
    """Full pyramid detection on one grayscale image [H, W] in [0, 1]
    (float32 tensor on the device to run on). Returns `Features` with
    M = sum of per-level allocations, xy in level-0 pixels."""
    H, W = image.shape
    allocs = level_allocations(cfg)
    outs = []
    img_l = image
    for lvl in range(cfg.n_levels):
        scale = cfg.scale_factor**lvl
        if lvl > 0:
            h_l = max(int(round(H / scale)), 2 * cfg.border + 8)
            w_l = max(int(round(W / scale)), 2 * cfg.border + 8)
            img_l = _resize_linear(image, h_l, w_l)
        ys, xs, resp, ang, desc, valid = _detect_level(img_l, allocs[lvl], cfg)
        n = allocs[lvl]
        outs.append((
            torch.stack([xs, ys], -1) * scale, resp,
            torch.full((n,), lvl, dtype=torch.int32, device=image.device), ang,
            torch.full((n,), scale * scale, dtype=torch.float32,
                       device=image.device),
            desc, valid))
    cat = [torch.cat([o[i] for o in outs]) for i in range(7)]
    xy, resp, octv, ang, sig, desc, valid = cat
    resp = torch.where(valid, resp, torch.full_like(resp, -float("inf")))
    return Features(xy=xy, response=resp, octave=octv, angle=ang, sigma2=sig,
                    desc=desc, valid=valid)
