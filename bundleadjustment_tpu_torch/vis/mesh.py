"""Map -> mesh / point-cloud outputs (COFF + PLY writers, camera glyphs).

Replaces the reference's PCL-based `SimpleMesh`
(`ba_project/src/visualization/SimpleMesh.cpp`): outlier-filtered colored
vertices, bounding-box normalization (`:102-124`), per-keyframe camera
frustum glyphs (`:156-162,271-299`), COFF writer (`:206-241`), and optional
faces.  Faces come from a Delaunay triangulation of the dominant-plane
projection (scipy) — the moral equivalent of PCL greedy projection
triangulation (`:345-412`) without a native PCL dependency; "none" writes
vertices only.

Copied from `bundleadjustment_tpu/vis/mesh.py` (numpy only). One change:
`create_map_mesh` takes a `device` and passes it on to the Poisson solver
(`vis/poisson.py`), which runs there.
"""

from __future__ import annotations

import numpy as np


def normalize_points(points, target=1.0):
    """Center + scale into a bounding box of extent `target`
    (reference SimpleMesh.cpp:102-124)."""
    pts = np.asarray(points, np.float64)
    c = (pts.max(0) + pts.min(0)) / 2
    extent = np.linalg.norm(pts.max(0) - pts.min(0))
    s = target / max(extent, 1e-12)
    return (pts - c) * s, c, s


def camera_frustum_glyph(cam_to_world, scale=0.02, color=(255, 0, 0)):
    """Vertices/edges-as-thin-triangles for one camera pose glyph.

    Returns (verts [5,3], faces [4,3] int, colors [5,3] uint8): an apex plus
    4 image-plane corners (reference SimpleMesh.cpp:271-299).
    """
    M = np.asarray(cam_to_world, np.float64)
    corners = np.array(
        [
            [0.0, 0.0, 0.0],
            [-1.0, -0.75, 1.0],
            [1.0, -0.75, 1.0],
            [1.0, 0.75, 1.0],
            [-1.0, 0.75, 1.0],
        ]
    ) * scale
    verts = corners @ M[:3, :3].T + M[:3, 3]
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1]], np.int64)
    colors = np.tile(np.asarray(color, np.uint8), (5, 1))
    return verts, faces, colors


def create_map_mesh(points, colors=None, cam_poses=None, faces_type="standard",
                    normalize=True, device="cuda"):
    """Assemble the output mesh: map vertices (+faces) + camera glyphs.

    faces_type: "standard" (no faces) | "greedy" (Delaunay projection faces
    on the two dominant axes — the analogue of PCL greedy projection
    triangulation) | "poisson" (full Poisson surface reconstruction,
    `vis/poisson.py` — the mesh gets its own grid-resolution vertex set,
    like PCL Poisson in the reference `SimpleMesh.cpp:414-491`).
    Returns (verts, faces, colors).
    """
    pts = np.asarray(points, np.float64)
    if colors is None:
        colors = np.full((len(pts), 3), 200, np.uint8)
    if normalize and len(pts):
        pts, center, scale = normalize_points(pts)
    else:
        center, scale = np.zeros(3), 1.0

    faces = np.zeros((0, 3), np.int64)
    poisson_ok = False
    if faces_type == "poisson" and len(pts) >= 64:
        from bundleadjustment_tpu_torch.vis.poisson import poisson_reconstruct

        vps = None
        if cam_poses is not None and len(cam_poses):
            vps = np.stack(
                [(np.asarray(M)[:3, 3] - center) * scale for M in cam_poses]
            )
        mverts, mfaces = poisson_reconstruct(pts, viewpoints=vps, device=device)
        poisson_ok = len(mverts) > 0 and len(mfaces) > 0
        if poisson_ok:
            # color mesh vertices from the nearest map point (chunked NN)
            cols_in = np.asarray(colors, np.uint8)
            p32 = pts.astype(np.float32)
            pn = (p32 ** 2).sum(1)
            nn = np.empty(len(mverts), np.int64)
            for s in range(0, len(mverts), 1024):
                blk = mverts[s:s + 1024].astype(np.float32)
                d = (blk ** 2).sum(1)[:, None] - 2.0 * blk @ p32.T + pn[None]
                nn[s:s + len(blk)] = np.argmin(d, axis=1)
            pts = mverts
            colors = cols_in[nn]
            faces = mfaces
    if (faces_type == "greedy" or (faces_type == "poisson" and not poisson_ok)
            ) and len(pts) >= 16:
        # Delaunay projection faces; also the fallback when the point set is
        # too small/degenerate for a Poisson iso-surface
        from scipy.spatial import Delaunay

        # project onto the two principal axes, triangulate, lift
        c = pts - pts.mean(0)
        _, _, vt = np.linalg.svd(c, full_matrices=False)
        uv = c @ vt[:2].T
        try:
            tri = Delaunay(uv)
            faces = tri.simplices.astype(np.int64)
            # drop sliver/huge triangles (edge > 5x median)
            e = np.linalg.norm(
                pts[faces] - pts[np.roll(faces, 1, axis=1)], axis=2
            )
            med = np.median(e) if len(e) else 1.0
            faces = faces[(e < 5 * med).all(1)]
        except Exception:
            faces = np.zeros((0, 3), np.int64)

    verts = pts
    cols = np.asarray(colors, np.uint8)
    if cam_poses is not None:
        for M in cam_poses:
            Mn = np.asarray(M, np.float64).copy()
            Mn[:3, 3] = (Mn[:3, 3] - center) * scale
            v, f, c = camera_frustum_glyph(Mn, scale=0.02 * max(1.0, 1.0))
            faces = np.concatenate([faces, f + len(verts)])
            verts = np.concatenate([verts, v])
            cols = np.concatenate([cols, c])
    return verts, faces, cols


def write_off(path, verts, faces=None, colors=None):
    """COFF writer (reference SimpleMesh.cpp:206-241)."""
    verts = np.asarray(verts)
    faces = np.zeros((0, 3), np.int64) if faces is None else np.asarray(faces)
    with open(path, "w") as f:
        f.write("COFF\n" if colors is not None else "OFF\n")
        f.write(f"{len(verts)} {len(faces)} 0\n")
        for i, v in enumerate(verts):
            line = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
            if colors is not None:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])} 255"
            f.write(line + "\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def write_ply(path, verts, colors=None, faces=None):
    """ASCII PLY writer (reference Visualizer.cpp:45-49 dumps PLY clouds)."""
    verts = np.asarray(verts)
    faces = None if faces is None or len(faces) == 0 else np.asarray(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
            if colors is not None:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")
        if faces is not None:
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_ply_vertices(path):
    """Minimal ASCII PLY vertex reader (for tests / recon-error input)."""
    verts = []
    with open(path) as f:
        n = 0
        for line in f:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        for _ in range(n):
            parts = f.readline().split()
            verts.append([float(parts[0]), float(parts[1]), float(parts[2])])
    return np.asarray(verts)
