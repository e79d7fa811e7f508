"""Poisson surface reconstruction on the device.

Port of `bundleadjustment_tpu/vis/poisson.py`, which replaces PCL's Poisson
meshing (reference `ba_project/src/visualization/SimpleMesh.cpp:414-491`)
with a spectral solver:

1. normals: chunked k-NN PCA (`estimate_normals`): each chunk's distances
   to all points by one matrix product, `torch.topk`, smallest
   eigenvector by batched `torch.linalg.eigh`; oriented toward the nearest
   camera viewpoint (the eigenvector's sign is arbitrary, the orientation
   fixes it);
2. splat the oriented normal field onto a D^3 grid with trilinear weights
   (`splat_normals`, `index_add_`);
3. solve div(grad chi) = div V with a 3-D real FFT (`solve_poisson_grid`):
   the Laplacian is diagonal in Fourier space, so the solve is two FFTs and
   one elementwise divide;
4. extract the iso-surface at the mean indicator value of the input
   samples (`sample_trilinear`) with surface nets on the host
   (`surface_nets`, a numpy copy of the source, as is `_to_unit_cube`).

Steps 1-3 and the iso value run on `device`. `index_add_` on the card sums
in another order on every run, so two runs' grids agree to float32
round-off, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from bundleadjustment_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# normals
# ---------------------------------------------------------------------------


def estimate_normals(points, k=16, viewpoints=None, chunk=2048, device="cuda"):
    """k-NN PCA normal estimation on `device`, oriented toward `viewpoints`.

    points: [N, 3]; viewpoints: [M, 3] camera centers (None: toward +z).
    Returns [N, 3] unit normals (numpy).
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    N = pts.shape[0]
    k = min(k, N - 1)
    sq = torch.sum(pts**2, 1)
    vps = None
    if viewpoints is not None and len(np.atleast_2d(viewpoints)):
        vps = torch.as_tensor(np.atleast_2d(np.asarray(viewpoints, np.float32)),
                              device=dev)
    out = []
    for s in range(0, N, chunk):
        block = pts[s:s + chunk]
        d2 = (torch.sum(block**2, 1)[:, None] - 2.0 * block @ pts.T) + sq[None, :]
        _, idx = torch.topk(-d2, k + 1, dim=1)  # includes self
        nb = pts[idx]  # [C, k+1, 3]
        c = nb - nb.mean(dim=1, keepdim=True)
        cov = torch.einsum("cki,ckj->cij", c, c)
        n = torch.linalg.eigh(cov)[1][..., 0]  # smallest-eigenvalue eigenvector
        n = n / torch.clamp(torch.linalg.norm(n, dim=1, keepdim=True), min=1e-12)
        if vps is not None:
            # toward the nearest viewpoint
            d = ((block**2).sum(1)[:, None] - 2.0 * block @ vps.T
                 + (vps**2).sum(1)[None])
            flip = (n * (vps[torch.argmin(d, 1)] - block)).sum(1) < 0
        else:
            flip = n[:, 2] < 0
        out.append(torch.where(flip[:, None], -n, n))
    return torch.cat(out).cpu().numpy()


# ---------------------------------------------------------------------------
# grid splat + spectral solve
# ---------------------------------------------------------------------------


def _to_unit_cube(points, margin=0.15):
    p = np.asarray(points, np.float64)
    lo, hi = p.min(0), p.max(0)
    scale = (1.0 - 2 * margin) / max(float((hi - lo).max()), 1e-9)
    center = (lo + hi) / 2.0
    q = (p - center) * scale + 0.5
    return q.astype(np.float32), center, scale


def _corners(points01, D, dtype=torch.float32):
    """Trilinear corners of float32 unit-cube points on a D^3 grid: yields
    (linear cell index [N], weight [N] in `dtype`) for each of the 8
    corners."""
    p = points01 * (D - 1)
    i0 = torch.clamp(torch.floor(p).to(torch.int64), 0, D - 2)
    f = p.to(dtype) - i0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                yield ((i0[:, 0] + dx) * D + (i0[:, 1] + dy)) * D + (i0[:, 2] + dz), w


def splat_normals(points01, normals, D, device="cuda"):
    """Trilinear scatter of the normal field onto a [D,D,D,3] grid (tensor
    on `device`)."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(points01, np.float32), device=dev)
    n = torch.as_tensor(np.asarray(normals, np.float32), device=dev)
    grid = torch.zeros((D * D * D, 3), dtype=torch.float32, device=dev)
    for lin, w in _corners(p, D):
        grid.index_add_(0, lin, w[:, None] * n)
    return grid.reshape(D, D, D, 3)


def solve_poisson_grid(V, sigma=1.5, screen=0.0):
    """Spectral solve of  lap(chi) = div(V)  on a periodic D^3 grid, on V's
    device.

    sigma: Gaussian smoothing of the splatted field in voxels (the analogue
    of PCL's reconstruction depth/scale).  screen: screening weight
    (chi-damping) for the screened-Poisson variant.  Returns chi [D,D,D].
    """
    D = V.shape[0]
    kx = torch.fft.fftfreq(D, device=V.device)[:, None, None]
    ky = torch.fft.fftfreq(D, device=V.device)[None, :, None]
    kz = torch.fft.rfftfreq(D, device=V.device)[None, None, :]

    Vh = [torch.fft.rfftn(V[..., a]) for a in range(3)]
    # Gaussian low-pass (unit-voxel spacing)
    g = torch.exp(-2.0 * (np.pi * sigma) ** 2 * (kx**2 + ky**2 + kz**2))
    # spectral divergence (exact ik)
    two_pi_i = 2j * np.pi
    div_h = two_pi_i * (kx * Vh[0] + ky * Vh[1] + kz * Vh[2]) * g
    # discrete Laplacian symbol (matches the central-difference stencil)
    lap = (
        2.0 * (torch.cos(2 * np.pi * kx) - 1.0)
        + 2.0 * (torch.cos(2 * np.pi * ky) - 1.0)
        + 2.0 * (torch.cos(2 * np.pi * kz) - 1.0)
    ) - screen
    lap = torch.where(torch.abs(lap) < 1e-12, torch.ones_like(lap), lap)
    chi_h = div_h / lap
    chi_h[0, 0, 0] = 0.0
    return torch.fft.irfftn(chi_h, s=(D, D, D))


def sample_trilinear(grid, points01):
    """Sample a [D,D,D] grid tensor at [N,3] unit-cube positions, on the
    grid's device, with float64 weights as the source's numpy computes
    them. Returns [N] float64."""
    g = grid.reshape(-1).double()
    p = torch.as_tensor(np.asarray(points01, np.float32), device=grid.device)
    out = torch.zeros(p.shape[0], dtype=torch.float64, device=grid.device)
    for lin, w in _corners(p, grid.shape[0], torch.float64):
        out += w * g[lin]
    return out


# ---------------------------------------------------------------------------
# surface nets (dual contouring) -- host, copied from the source
# ---------------------------------------------------------------------------


def surface_nets(chi, iso):
    """Extract the iso-surface of a [D,D,D] scalar grid as a triangle mesh.

    Dual approach: one vertex per sign-change cell (at the mean of its edge
    crossings), one quad (two triangles) per sign-change grid edge, wound by
    crossing direction.  Returns (verts [M,3] in grid coords, faces [F,3]).
    """
    chi = np.asarray(chi, np.float64)
    D = chi.shape[0]
    occ = chi > iso

    # --- edge crossings per axis, with interpolated crossing points
    cell_vsum = np.zeros((D - 1, D - 1, D - 1, 3))
    cell_cnt = np.zeros((D - 1, D - 1, D - 1))

    def denom_safe(a, b):
        d = b - a
        return np.where(np.abs(d) < 1e-30, 1e-30, d)

    crossings = []
    for axis in range(3):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[axis] = slice(0, D - 1)
        sl1[axis] = slice(1, D)
        a = chi[tuple(sl0)]
        b = chi[tuple(sl1)]
        cross = occ[tuple(sl0)] != occ[tuple(sl1)]
        idx = np.argwhere(cross)  # [E, 3] base-node coords
        if len(idx) == 0:
            crossings.append((idx, None, None))
            continue
        t = (iso - a[cross]) / denom_safe(a[cross], b[cross])
        pt = idx.astype(np.float64)
        pt[:, axis] += np.clip(t, 0.0, 1.0)
        # accumulate into the <=4 cells sharing this edge
        o1, o2 = [ax for ax in range(3) if ax != axis]
        for d1 in (0, 1):
            for d2 in (0, 1):
                c = idx.copy()
                c[:, o1] -= d1
                c[:, o2] -= d2
                ok = (
                    (c[:, 0] >= 0) & (c[:, 0] < D - 1)
                    & (c[:, 1] >= 0) & (c[:, 1] < D - 1)
                    & (c[:, 2] >= 0) & (c[:, 2] < D - 1)
                )
                np.add.at(cell_vsum, (c[ok, 0], c[ok, 1], c[ok, 2]), pt[ok])
                np.add.at(cell_cnt, (c[ok, 0], c[ok, 1], c[ok, 2]), 1.0)
        # remember which edges flip outward (low corner inside) for winding
        flips = occ[tuple(sl0)][cross]
        crossings.append((idx, flips, None))

    active = cell_cnt > 0
    if not active.any():
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    vid = -np.ones((D - 1, D - 1, D - 1), np.int64)
    vid[active] = np.arange(int(active.sum()))
    verts = cell_vsum[active] / cell_cnt[active][:, None]

    faces = []
    for axis in range(3):
        idx, flips, _ = crossings[axis]
        if len(idx) == 0:
            continue
        o1, o2 = [ax for ax in range(3) if ax != axis]
        if axis == 1:
            # keep the (axis, o1, o2) frame right-handed: e_o1 x e_o2 must
            # equal +e_axis (true for (1,2) and (0,1), but (0,2) is
            # left-handed) so all three edge orientations wind consistently
            o1, o2 = o2, o1
        # the 4 cells around the edge, in a consistent cyclic order
        quads = []
        for d1, d2 in ((0, 0), (1, 0), (1, 1), (0, 1)):
            c = idx.copy()
            c[:, o1] -= d1
            c[:, o2] -= d2
            inb = (
                (c[:, 0] >= 0) & (c[:, 0] < D - 1)
                & (c[:, 1] >= 0) & (c[:, 1] < D - 1)
                & (c[:, 2] >= 0) & (c[:, 2] < D - 1)
            )
            ids = np.full(len(idx), -1, np.int64)
            ids[inb] = vid[c[inb, 0], c[inb, 1], c[inb, 2]]
            quads.append(ids)
        q = np.stack(quads, 1)  # [E, 4]
        ok = (q >= 0).all(1)
        q = q[ok]
        fl = flips[ok]
        # two triangles per quad, wound so normals point toward the
        # occupied (chi > iso) side — outward for an interior solid
        t1 = np.where(fl[:, None], q[:, [0, 2, 1]], q[:, [0, 1, 2]])
        t2 = np.where(fl[:, None], q[:, [0, 3, 2]], q[:, [0, 2, 3]])
        faces.append(t1)
        faces.append(t2)
    faces = (
        np.concatenate(faces) if faces else np.zeros((0, 3), np.int64)
    )
    return verts, faces


# ---------------------------------------------------------------------------
# end-to-end
# ---------------------------------------------------------------------------


def poisson_reconstruct(points, normals=None, viewpoints=None, grid=96,
                        sigma=1.5, k=16, device="cuda"):
    """Full Poisson pipeline: points (+optional normals/camera viewpoints)
    -> (verts [M,3] in input coordinates, faces [F,3] int).
    """
    points = np.asarray(points, np.float64)
    if len(points) < 8:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    if normals is None:
        normals = estimate_normals(points, k=k, viewpoints=viewpoints,
                                   device=device)
    p01, center, scale = _to_unit_cube(points)
    V = splat_normals(p01, normals, grid, device=device)
    chi = solve_poisson_grid(V, sigma=sigma)
    iso = float(torch.mean(sample_trilinear(chi, p01)))
    verts_g, faces = surface_nets(chi.cpu().numpy(), iso)
    # grid coords -> unit cube -> world
    verts01 = verts_g / (grid - 1)
    verts = (verts01 - 0.5) / scale + center
    return verts, faces
