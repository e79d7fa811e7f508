"""Reconstruction error: point-cloud vs ground-truth alignment via ICP.

Port of `bundleadjustment_tpu/metrics/reconstruction.py` (the reference's
PCL metric, `ba_project/src/metrics/ReconstructionError.cpp:49-110,134-190`):
transform the sparse map into the ground-truth frame with the first
keyframe's ground-truth pose (`:64-76`), zero-centre both clouds and
normalise their scale with a percentile bounding box (`:212-244`, on the
host), then run point-to-point ICP on the device; the fitness (mean squared
distance of the correspondences) is the reconstruction error (`:184-189`).

The nearest neighbour is a brute-force distance argmin, as in the source,
but in chunks of source rows: the source forms the whole [N, M] distance
matrix, 40 GB of float32 at N = M = 1e5. Chunk rule: a chunk holds the most
source rows whose [chunk, M] float32 block fits in 1 GiB (`chunk_rows`).
Each block is the source's expression |s|^2 - 2 s.d + |d|^2, with the
3-term dot product s.d summed elementwise in a fixed order (a matrix
product picks its summation by shape, so a row's distances would depend on
the chunk), and `torch.argmin` (first index on ties) reduces it row by row:
the nearest neighbours and their distances are those of the whole matrix,
whatever the chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from bundleadjustment_tpu_torch.device import resolve_device

# bytes of one [chunk, M] float32 distance block
BLOCK_BYTES = 1 << 30


def percentile_scale(points, lo=10.0, hi=90.0):
    """Robust bbox extent: percentile range per axis, L2 over axes
    (reference ReconstructionError.cpp:212-244)."""
    p_lo = np.percentile(points, lo, axis=0)
    p_hi = np.percentile(points, hi, axis=0)
    return float(np.linalg.norm(p_hi - p_lo))


def normalize_cloud(points, lo=10.0, hi=90.0):
    """Zero-center + percentile-scale to unit extent.  Returns (cloud, c, s)."""
    c = points.mean(axis=0)
    centered = points - c
    s = percentile_scale(centered, lo, hi)
    s = max(s, 1e-12)
    return centered / s, c, s


def chunk_rows(n_target, block_bytes=BLOCK_BYTES):
    """Source rows a chunk: the most whose [chunk, n_target] float32
    distance block fits in `block_bytes` (at least one)."""
    return max(1, block_bytes // (4 * max(n_target, 1)))


def nearest(src, dst, dst_sq, chunk):
    """Nearest dst point of every src point and its squared distance
    (clamped at 0), `chunk` src rows at a time: (idx [N], d2 [N])."""
    idx, best = [], []
    dstT = dst.T
    src_sq = torch.sum(src**2, 1)[:, None]
    for s in range(0, src.shape[0], chunk):
        blk = src[s:s + chunk]
        d2 = blk[:, :1] * dstT[:1]
        d2 += blk[:, 1:2] * dstT[1:2]
        d2 += blk[:, 2:] * dstT[2:]
        d2.mul_(-2.0).add_(src_sq[s:s + chunk]).add_(dst_sq)
        i = torch.argmin(d2, 1)
        idx.append(i)
        best.append(torch.gather(d2, 1, i[:, None])[:, 0])
    return torch.cat(idx), torch.clamp(torch.cat(best), min=0.0)


def _icp(src, dst, max_iters, max_corr_dist, chunk):
    """Point-to-point ICP of src onto dst on their device, with no host
    read inside the loop. Returns (R, t, fitness, n_corr) as tensors."""
    dst_sq = torch.sum(dst**2, 1)[None, :]
    R = torch.eye(3, dtype=src.dtype, device=src.device)
    t = torch.zeros(3, dtype=src.dtype, device=src.device)
    D = torch.eye(3, dtype=src.dtype, device=src.device)
    for _ in range(max_iters):
        cur = src @ R.T + t
        idx, d2 = nearest(cur, dst, dst_sq, chunk)
        w = (d2 <= max_corr_dist**2).to(src.dtype)
        n = torch.clamp(torch.sum(w), min=1.0)
        tgt = dst[idx]
        mu_s = torch.sum(cur * w[:, None], 0) / n
        mu_t = torch.sum(tgt * w[:, None], 0) / n
        H = ((cur - mu_s) * w[:, None]).T @ (tgt - mu_t)
        U, _, Vt = torch.linalg.svd(H)
        # Kabsch with the reflection fix: the SVD's signs drop out
        D[2, 2] = torch.sign(torch.linalg.det(Vt.T @ U.T))
        dR = Vt.T @ D @ U.T
        dt = mu_t - dR @ mu_s
        R, t = dR @ R, dR @ t + dt
    _, d2 = nearest(src @ R.T + t, dst, dst_sq, chunk)
    w = d2 <= max_corr_dist**2
    n = torch.clamp(torch.sum(w), min=1)
    fitness = torch.sum(torch.where(w, d2, torch.zeros_like(d2))) / n
    return R, t, fitness, torch.sum(w)


def icp_align(source, target, max_iters=30, max_corr_dist=0.1, chunk=None,
              device="cuda"):
    """ICP align source -> target (numpy in/out) on `device`; `chunk` source
    rows per distance block (default `chunk_rows`). Returns dict."""
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(source, np.float32), device=dev)
    dst = torch.as_tensor(np.asarray(target, np.float32), device=dev)
    R, t, fit, n = _icp(src, dst, max_iters, max_corr_dist,
                        chunk or chunk_rows(dst.shape[0]))
    return {
        "R": R.cpu().numpy(),
        "t": t.cpu().numpy(),
        "fitness": float(fit),
        "n_corr": int(n),
    }


def reconstruction_error(
    map_points,
    gt_points,
    first_kf_gt_pose=None,
    max_iters=30,
    max_corr_dist=0.1,
    out_prefix=None,
    device="cuda",
):
    """Full reference metric: transform, normalize, ICP, fitness.

    map_points: [N,3] sparse map in the estimation frame.
    gt_points: [M,3] ground-truth cloud (e.g. sampled GT mesh vertices).
    first_kf_gt_pose: optional [4,4] cam->world GT of the first keyframe
      (reference transforms the map into the GT frame with it, :64-76).
    out_prefix: when given, write the reference's comparison PLYs
      (ReconstructionError.cpp:106-107,174): `<prefix>_gt_cloud.ply`,
      `<prefix>_estimated_cloud.ply` (both normalized), and
      `<prefix>_combined_colored_cloud.ply` with the ICP-aligned estimate
      red and the ground truth green.
    Returns (fitness, the `icp_align` dict).
    """
    pts = np.asarray(map_points, np.float64)
    if first_kf_gt_pose is not None:
        M = np.asarray(first_kf_gt_pose, np.float64)
        pts = pts @ M[:3, :3].T + M[:3, 3]
    src, _, _ = normalize_cloud(pts)
    dst, _, _ = normalize_cloud(np.asarray(gt_points, np.float64))
    res = icp_align(src.astype(np.float32), dst.astype(np.float32),
                    max_iters, max_corr_dist, device=device)
    if out_prefix:
        from bundleadjustment_tpu_torch.vis.mesh import write_ply

        write_ply(out_prefix + "_gt_cloud.ply", dst)
        write_ply(out_prefix + "_estimated_cloud.ply", src)
        R, t = np.asarray(res["R"], np.float64), np.asarray(res["t"], np.float64)
        aligned = src @ R.T + t
        combined = np.concatenate([aligned, dst])
        colors = np.concatenate([
            np.tile([255, 0, 0], (len(aligned), 1)),
            np.tile([0, 255, 0], (len(dst), 1)),
        ]).astype(np.uint8)
        write_ply(out_prefix + "_combined_colored_cloud.ply", combined,
                  colors=colors)
    return res["fitness"], res
