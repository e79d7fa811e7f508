"""Multi-scale feature detection + oriented binary descriptors on tensors.

Port of `bundleadjustment_tpu/ops/features.py:detect_and_describe`: FAST-16
corners gated and ranked by the Harris response over a 1.2-scale pyramid,
3x3 non-maximum suppression, sub-pixel refinement, intensity-centroid
orientation, and rotation-steered BRIEF-256 packed into 8 words per
keypoint (int32 tensors holding the reference's uint32 bit patterns).

`detect_batch` detects a batch of frames [B, H, W] in one pass: every step
works on the whole batch (the image helpers act on the last two axes), and
`detect_and_describe(image)` is `detect_batch(image[None])` at B = 1, so a
frame detected alone and in a batch goes through the same code.

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
# the disc's (dy, dx) zero-padded to a power of two for `_pairwise_sum`: a
# padded offset is the keypoint itself at weight 0, so it adds +0 to the
# moments, as zeros padded onto the products would
_ORI_OFFSETS = np.zeros((2, 1 << (len(_ORI_DY) - 1).bit_length()), np.int64)
_ORI_OFFSETS[:, :len(_ORI_DY)] = _ORI_DY, _ORI_DX


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
    """Harris response map and Shi-Tomasi min-eigenvalue map of [..., H, W]."""
    ix = _corr1d(_corr1d(img, [-1.0, 0.0, 1.0], -1), [1.0, 2.0, 1.0], -2)
    iy = _corr1d(_corr1d(img, [-1.0, 0.0, 1.0], -2), [1.0, 2.0, 1.0], -1)
    s = _sep_conv(torch.stack([ix * ix, iy * iy, ix * iy]), _gauss_kernel(window_sigma, 3))
    sxx, syy, sxy = s[0], s[1], s[2]
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    half = 0.5 * tr
    shi = half - torch.sqrt(torch.clamp(half * half - det, min=0.0))
    return det - k * tr * tr, shi


def fast_corners(img, threshold):
    """FAST-16 on [..., H, W]: >= 9 contiguous circle pixels all brighter or
    all darker."""
    shifted = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(-2, -1))
                           for dy, dx in _FAST_CIRCLE])
    bright = shifted > (img + threshold)[None]
    dark = shifted < (img - threshold)[None]
    weights = (1 << torch.arange(16, dtype=torch.int64, device=img.device))
    weights = weights.reshape(16, *([1] * img.dim()))

    def contiguous9(m):
        code = torch.sum(m.to(torch.int64) * weights, 0)
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


@functools.lru_cache(maxsize=256)
def _const(device, name, *args):
    """A constant of the detector on `device`, copied there once: "resize"
    (resize_matrix(*args)), "disc" (the orientation disc's offsets) or
    "brief" (the BRIEF pattern). A copy from the host's pageable memory
    waits for the card, so none is made inside a batch of device work
    after the first."""
    a = {"resize": lambda: resize_matrix(*args), "disc": lambda: _ORI_OFFSETS,
         "brief": lambda: _BRIEF}[name]()
    return torch.from_numpy(a).to(device)


def _resize_linear(img, h_out, w_out):
    """Resize [B, H, W] frames: two batched products with the same weights
    for every frame."""
    B, H, W = img.shape
    wh = _const(img.device, "resize", h_out, H)
    ww = _const(img.device, "resize", w_out, W)
    return torch.bmm(torch.bmm(wh.expand(B, h_out, H), img),
                     ww.T.expand(B, W, w_out))


def _nms3(score):
    """3x3 non-maximum mask of [B, H, W] scores."""
    neigh = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return score >= neigh


def _gather2d(img, yy, xx):
    """img [B, H, W] at per-frame pixel indices yy, xx [B, ...]."""
    B, H, W = img.shape
    lin = torch.add(xx, yy, alpha=W).reshape(B, -1)
    return torch.gather(img.reshape(B, H * W), 1, lin).reshape(yy.shape)


def _pairwise_sum(x):
    """Sum over the last axis in a fixed pairwise order (zero-padded to a
    power of two, halves added elementwise): the same bits for a frame alone
    or in a batch, where a CUDA `torch.sum` picks its order by the number of
    rows."""
    n = x.shape[-1]
    if n & (n - 1):
        x = F.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _per_row(fn, *xs):
    """fn of [B, M] tensors, on the CPU with each row padded to a multiple of
    64 lanes: the CPU's vectorised atan2 / cos / sin round differently from
    its scalar loop over the tail of a tensor, so every element of every
    frame takes the vector loop, alone or in a batch. A CUDA elementwise
    kernel rounds every element alike, so on the card fn runs as it is."""
    if xs[0].device.type != "cpu":
        return fn(*xs)
    n = xs[0].shape[-1]
    pad = (0, -n % 64)
    return fn(*(F.pad(x, pad) for x in xs))[..., :n]


def orientation_angles(img_blur, ys, xs):
    """Intensity-centroid orientation over a radius-15 disc; img_blur
    [B, H, W], keypoint pixels ys, xs [B, M]."""
    _, H, W = img_blur.shape
    off = _const(img_blur.device, "disc")
    yy = torch.clamp(ys[..., None] + off[0], 0, H - 1)
    xx = torch.clamp(xs[..., None] + off[1], 0, W - 1)
    patch = _gather2d(img_blur, yy, xx)
    # both moments in one pass: [2, B, M, K] products, summed over K
    m01, m10 = _pairwise_sum(patch * off.to(patch.dtype)[:, None, None])
    return _per_row(torch.atan2, m01, m10)


def pack_bits(bits):
    """[..., 256] {0,1} -> [..., 8] int32 words (bit i of word w = bit
    32 w + i)."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, -1)
    words = words - ((words >> 31) & 1) * (1 << 32)  # uint32 -> int32 bits
    return words.to(torch.int32)


def brief_descriptors(img_blur, ys, xs, angles):
    """Rotation-steered BRIEF-256 of keypoints ys, xs, angles [B, M] in
    img_blur [B, H, W], packed to [B, M, 8] int32."""
    _, H, W = img_blur.shape
    pat = _const(img_blur.device, "brief")
    ca = _per_row(torch.cos, angles)[..., None]
    sa = _per_row(torch.sin, angles)[..., None]

    def rot(px, py):
        return ca * px - sa * py, sa * px + ca * py

    r1x, r1y = rot(pat[:, 0], pat[:, 1])
    r2x, r2y = rot(pat[:, 2], pat[:, 3])
    xf, yf = xs[..., None].to(torch.float32), ys[..., None].to(torch.float32)
    x1 = torch.clamp(torch.round(xf + r1x).to(torch.int64), 0, W - 1)
    y1 = torch.clamp(torch.round(yf + r1y).to(torch.int64), 0, H - 1)
    x2 = torch.clamp(torch.round(xf + r2x).to(torch.int64), 0, W - 1)
    y2 = torch.clamp(torch.round(yf + r2y).to(torch.int64), 0, H - 1)
    return pack_bits(_gather2d(img_blur, y1, x1) < _gather2d(img_blur, y2, x2))


def _top_k(flat, n):
    """Exact top-n of each row of [B, N], equal values ranked lowest index
    first."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def _detect_level(img, n_keep, cfg: FeatureConfig):
    """Detect the n_keep best keypoints of each frame of img [B, H, W]."""
    B, H, W = img.shape
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
    inb[:, b:H - b, b:W - b] = True
    score = torch.where(inb, score, ninf)

    vals, idx = _top_k(score.reshape(B, H * W), n_keep)
    ys = idx // W
    xs = idx % W
    valid = torch.isfinite(vals) & (vals > 0)

    # sub-pixel refinement: 1D quadratic fit on the raw response surface
    resp = harris if cfg.detector != "shi_tomasi" else shi
    ym = torch.clamp(ys - 1, 0, H - 1)
    yp = torch.clamp(ys + 1, 0, H - 1)
    xm = torch.clamp(xs - 1, 0, W - 1)
    xp = torch.clamp(xs + 1, 0, W - 1)
    c, r_xp, r_xm, r_yp, r_ym = _gather2d(
        resp, torch.stack([ys, ys, ys, yp, ym], 1),
        torch.stack([xs, xp, xm, xs, xs], 1)).unbind(1)
    dxn = r_xp - r_xm
    dxd = 2.0 * (2.0 * c - r_xp - r_xm)
    dyn = r_yp - r_ym
    dyd = 2.0 * (2.0 * c - r_yp - r_ym)
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


def level_shape(H, W, lvl, cfg: FeatureConfig):
    """(height, width) of pyramid level `lvl` of an H x W frame."""
    scale = cfg.scale_factor**lvl
    return (max(int(round(H / scale)), 2 * cfg.border + 8),
            max(int(round(W / scale)), 2 * cfg.border + 8))


def detect_batch(images, cfg: FeatureConfig = FeatureConfig()):
    """Full pyramid detection on a batch of grayscale frames [B, H, W] in
    [0, 1] (float32 tensor on the device to run on), in one pass over the
    batch. Returns `Features` with leading axis B and M = sum of per-level
    allocations keypoints a frame, xy in level-0 pixels."""
    B, H, W = images.shape
    allocs = level_allocations(cfg)
    outs = []
    img_l = images
    for lvl in range(cfg.n_levels):
        scale = cfg.scale_factor**lvl
        if lvl > 0:
            img_l = _resize_linear(images, *level_shape(H, W, lvl, cfg))
        ys, xs, resp, ang, desc, valid = _detect_level(img_l, allocs[lvl], cfg)
        n = allocs[lvl]
        outs.append((
            torch.stack([xs, ys], -1) * scale, resp,
            torch.full((B, n), lvl, dtype=torch.int32, device=images.device), ang,
            torch.full((B, n), scale * scale, dtype=torch.float32,
                       device=images.device),
            desc, valid))
    cat = [torch.cat([o[i] for o in outs], 1) for i in range(7)]
    xy, resp, octv, ang, sig, desc, valid = cat
    resp = torch.where(valid, resp, torch.full_like(resp, -float("inf")))
    return Features(xy=xy, response=resp, octave=octv, angle=ang, sigma2=sig,
                    desc=desc, valid=valid)


def detect_and_describe(image, cfg: FeatureConfig = FeatureConfig()):
    """Detection on one grayscale image [H, W]: `detect_batch` of a batch of
    one. Returns `Features` without the batch axis."""
    f = detect_batch(image[None], cfg)
    return Features(*(getattr(f, k)[0] for k in Features.__dataclass_fields__))
