"""Synthetic SfM scene generation (numpy, host-side).

Generates ground-truth camera trajectories, landmarks, and observation tables
with configurable noise/outliers.  Used by the test pyramid (SURVEY.md §4: the
reference has no synthetic harness at all — its only test builds 3 points by
hand, `ba_project/tests/ReconstructionError_test.cc:24-42`) and by `bench.py`
to build BA problems of arbitrary size (BASELINE.json configs 4-5).

Copied from `bundleadjustment_tpu/data/synthetic.py` (numpy only), with its
imports pointed at this package, so that the port runs where the JAX
package is absent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def render_plane_sequence(
    n_frames=8,
    width=160,
    height=120,
    fx=150.0,
    fy=150.0,
    plane_z=4.0,
    tex_size=1024,
    motion_step=0.08,
    seed=0,
):
    """Render a camera track over a textured plane at z = plane_z (world).

    Returns (frames, K4) where each frame is a dict with 'gray' [H,W] float32,
    'depth' [H,W] float32 (meters), 'gt_cam_to_world' [4,4], 'timestamp'.
    Cheap ray-plane rendering — enough texture structure for FAST/BRIEF to
    latch onto, with exact ground-truth depth + poses for end-to-end tests.
    """
    rng = np.random.default_rng(seed)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    K4 = np.array([fx, fy, cx, cy], np.float32)

    # multi-scale random texture (sum of upsampled noise octaves)
    tex = np.zeros((tex_size, tex_size), np.float32)
    for cell in (8, 16, 32, 64):
        small = rng.random((tex_size // cell, tex_size // cell)).astype(np.float32)
        tex += np.kron(small, np.ones((cell, cell), np.float32))
    tex = (tex - tex.min()) / (tex.max() - tex.min())

    # texture maps world plane region x in [-span, span], y in [-span*0.75, ...]
    span = 6.0

    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    d_cam = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float32)], -1)

    frames = []
    for i in range(n_frames):
        rvec = np.array([0.004 * i, 0.01 * i, 0.002 * i])
        center = np.array([motion_step * i, 0.02 * np.sin(i), 0.01 * i])
        R = _aa_to_R(rvec)  # cam->world rotation
        C = np.eye(4)
        C[:3, :3] = R
        C[:3, 3] = center

        dir_w = d_cam @ R.T  # [H,W,3]
        s = (plane_z - center[2]) / np.maximum(dir_w[..., 2], 1e-9)
        pw = center[None, None, :] + s[..., None] * dir_w
        depth = s.astype(np.float32)  # z-depth in camera frame (d_cam z == 1)

        tx = (pw[..., 0] + span) / (2 * span) * (tex_size - 1)
        ty = (pw[..., 1] + span * 0.75) / (1.5 * span) * (tex_size - 1)
        x0 = np.clip(tx.astype(int), 0, tex_size - 2)
        y0 = np.clip(ty.astype(int), 0, tex_size - 2)
        fx_ = np.clip(tx - x0, 0, 1)
        fy_ = np.clip(ty - y0, 0, 1)
        img = (
            tex[y0, x0] * (1 - fx_) * (1 - fy_)
            + tex[y0, x0 + 1] * fx_ * (1 - fy_)
            + tex[y0 + 1, x0] * (1 - fx_) * fy_
            + tex[y0 + 1, x0 + 1] * fx_ * fy_
        ).astype(np.float32)

        frames.append(
            {
                "gray": img,
                "depth": depth,
                "gt_cam_to_world": C,
                "timestamp": i / 30.0,
            }
        )
    return frames, K4


def _make_texture(rng, tex_size=512, cells=(4, 8, 16, 32, 64)):
    """Multi-octave random texture in [0,1] — enough corner structure for
    FAST/Harris at several pyramid levels."""
    tex = np.zeros((tex_size, tex_size), np.float32)
    for cell in cells:
        small = rng.random((tex_size // cell, tex_size // cell)).astype(np.float32)
        tex += np.kron(small, np.ones((cell, cell), np.float32))
    return (tex - tex.min()) / (tex.max() - tex.min())


def _look_at_R(C, target, up=(0.0, -1.0, 0.0)):
    """cam-to-world rotation with +z toward `target` (y-down camera)."""
    z = np.asarray(target, np.float64) - np.asarray(C, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    n = np.linalg.norm(x)
    if n < 1e-9:
        x = np.array([1.0, 0.0, 0.0])
    else:
        x = x / n
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)  # columns = cam axes in world


def _smooth_walk(rng, n, sigma, kernel=5):
    """Smoothed random walk [n,3] — hand-held jitter."""
    steps = rng.normal(0, sigma, size=(n + kernel, 3))
    w = np.hanning(kernel + 2)[1:-1]
    w = w / w.sum()
    out = np.stack(
        [np.convolve(steps[:, i], w, mode="same")[:n] for i in range(3)], -1
    )
    return np.cumsum(out, axis=0)


def _trajectory(kind, n_frames, motion_step, rot_step, rng):
    """Per-frame (R cam->world, C center).  Kinds:

    - forward:  translating sweep with mild rotation (easy parallax)
    - orbit:    circle around the scene center, always looking at it
    - rotation: rotation-dominant pan with tiny translation (hard: weak
                parallax, exercises E/H degeneracy handling)
    - handheld: forward plus smoothed random-walk rotation+translation jitter
    - sweep:    oscillating side-to-side translation with jitter (the TUM
                fr1/xyz regime: repeated revisits of the same view — the
                long-sequence case where keyframe redundancy culling,
                SfMHelper.cpp:1005-1077, actually fires, and re-observing
                old landmarks bounds drift)
    """
    Rs, Cs = [], []
    target = np.array([0.0, 0.0, 5.0])
    if kind in ("handheld", "sweep"):
        jit_t = _smooth_walk(rng, n_frames, motion_step * 0.25)
        jit_r = _smooth_walk(rng, n_frames, rot_step * 0.6)
    for i in range(n_frames):
        if kind == "forward":
            C = np.array([motion_step * i, 0.02 * np.sin(0.7 * i), 0.015 * i])
            rvec = np.array([0.15 * rot_step * i, rot_step * i, 0.1 * rot_step * i])
            R = _aa_to_R(rvec)
        elif kind == "orbit":
            ang = 0.9 * motion_step / 4.0 * i - 0.15
            radius = 4.5
            C = target + radius * np.array([np.sin(ang), 0.05 * np.sin(2 * ang), -np.cos(ang)])
            R = _look_at_R(C, target)
        elif kind == "rotation":
            C = np.array([motion_step * 0.1 * i, 0.0, 0.002 * i])
            rvec = np.array([0.2 * rot_step * i, rot_step * i, 0.0])
            R = _aa_to_R(rvec)
        elif kind == "handheld":
            C = np.array([motion_step * i, 0.0, 0.01 * i]) + jit_t[i]
            rvec = np.array([0.0, 0.4 * rot_step * i, 0.0]) + jit_r[i]
            R = _aa_to_R(rvec)
        elif kind == "sweep":
            # period ~160 frames; amplitude keeps the per-frame step at
            # ~motion_step at the sweep's center
            P = min(160.0, max(n_frames / 2.0, 20.0))
            amp = motion_step * P / (2.0 * np.pi)
            ph = 2.0 * np.pi * i / P
            C = np.array([amp * np.sin(ph), 0.3 * amp * np.sin(2.1 * ph),
                          0.15 * amp * (1 - np.cos(ph))]) + jit_t[i]
            rvec = np.array([0.0, 0.5 * rot_step * np.sin(ph) * P / 6.0, 0.0]
                            ) + jit_r[i]
            R = _aa_to_R(rvec)
        else:
            raise ValueError(f"unknown trajectory {kind!r}")
        Rs.append(R)
        Cs.append(C)
    return Rs, Cs


def render_layered_scene(
    n_frames=30,
    width=640,
    height=480,
    fx=525.0,
    fy=525.0,
    trajectory="forward",
    motion_step=0.06,
    rot_step=0.01,
    n_layers=6,
    depth_scale=5000.0,
    depth_quantize=True,
    hole_frac=0.01,
    edge_holes=True,
    pixel_noise=0.01,
    exposure_jitter=0.05,
    vignette=0.25,
    view_dependent=0.25,
    background_texture=1.0,
    seed=0,
):
    """Render a hard multi-structure RGB-D sequence with exact ground truth.

    Deliberately exercises everything the fronto-parallel plane cannot
    (VERDICT r1: accuracy evidence must survive contact with hard data; the
    reference's datasets are real fr1/Replica sequences,
    ba_project/src/data/VirtualSensor.h:49-182):

    - a back wall + floor + `n_layers` floating panels at different depths:
      occlusion boundaries, depth discontinuities, non-planar structure (the
      E-path of two-view recovery gets a genuinely 3-D scene);
    - sensor-model depth: 16-bit quantization at the TUM 5000 scale, random
      blob dropouts, and dropouts along depth edges (structured-light style)
      -> invalid depth = -inf exactly like the TUM loader's 0->MINF;
    - photometric nuisance: per-frame exposure jitter, vignetting, Gaussian
      pixel noise, and view-dependent (angle-modulated) surface shading;
    - trajectories: forward / orbit / rotation-dominant / hand-held jitter.

    Returns (frames, K4) in the same format as `render_plane_sequence`.
    """
    rng = np.random.default_rng(seed)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    K4 = np.array([fx, fy, cx, cy], np.float32)

    # --- surfaces: axis-aligned textured rectangles ---------------------
    # kind "z": plane z=c spanning (x,y) bounds; kind "y": plane y=c (floor)
    surfaces = []

    def add_surface(kind, coord, b0, b1, texels_per_m=48.0, contrast=1.0):
        tex = _make_texture(rng)
        if contrast != 1.0:
            # texture-poor regime (fr1/teddy-style plain walls): squash the
            # texture toward its mean so the detector finds few corners there
            tex = 0.5 + contrast * (tex - 0.5)
        surfaces.append(
            {
                "kind": kind,
                "coord": float(coord),
                "b0": np.asarray(b0, np.float64),  # (min0, max0) first axis
                "b1": np.asarray(b1, np.float64),
                "tex": tex,
                "tpm": texels_per_m,
                "base": 0.55 + 0.45 * rng.random(),
            }
        )

    # size the world to the camera path: a trajectory of n_frames*motion_step
    # meters (plus pan) must never look past the edge of the scene — real
    # indoor sequences always have surrounding structure, and an image half
    # full of void (no texture, -inf depth) is a broken world model, not a
    # hard benchmark.  Panels are distributed along the whole path so every
    # part of the sequence sees non-planar structure.
    # NOTE (dataset-generation change, round 2): geometry depends on
    # n_frames*motion_step since this sizing landed, so the same seed yields
    # a different world than round-1 renders; metrics recorded before the
    # change are not directly comparable (BASELINE.md tables are labeled by
    # round for this reason).
    span = max(6.0, motion_step * n_frames + 8.0)
    add_surface("z", 8.0, (-span, span), (-5.0, 5.0),
                contrast=background_texture)             # back wall
    add_surface("y", 2.0, (-span, span), (0.5, 9.5),
                contrast=background_texture)             # floor (y down)
    for k in range(n_layers):
        z = rng.uniform(2.8, 6.5)
        w = rng.uniform(0.8, 2.6)
        h = rng.uniform(0.6, 2.0)
        if trajectory == "orbit":
            # object-centric orbit (fr1/teddy-style): cluster the panels
            # around the orbit target [0, 0, 5] so the "object" stays in
            # view for the whole revolution
            x0 = rng.uniform(-2.0, 2.0 - w)
        elif trajectory == "sweep":
            # oscillating trajectory stays near the origin: spread the
            # panels over the swept view cone, no along-track shift
            x0 = rng.uniform(-3.0, 3.0 - w) + z / 3.0
        else:
            along = (k / max(n_layers - 1, 1)) * motion_step * n_frames
            # the z/2.0 term compensates the protocols' slow rightward pan
            # (~0.5 rad over the path): a panel at depth z drifts out of a
            # panning view unless shifted ~z*tan(pan)≈z/2 along +x, keeping
            # deep panels visible mid-sequence instead of only at the start
            x0 = rng.uniform(-3.0, 3.0 - w) + along + z / 2.0
        y0 = rng.uniform(-2.2, 2.2 - h)
        add_surface("z", z, (x0, x0 + w), (y0, y0 + h), texels_per_m=64.0)

    Rs, Cs = _trajectory(trajectory, n_frames, motion_step, rng=rng, rot_step=rot_step)

    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    d_cam = np.stack(
        [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], -1
    )

    # static vignette field
    r2 = ((us - cx) / (width / 2)) ** 2 + ((vs - cy) / (height / 2)) ** 2
    vig = 1.0 - vignette * r2.astype(np.float32) / 2.0

    frames = []
    for i in range(n_frames):
        R, C = Rs[i], Cs[i]
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = C
        dir_w = d_cam @ R.T  # [H,W,3]

        depth = np.full((height, width), np.inf, np.float64)
        img = np.zeros((height, width), np.float32)
        for s in surfaces:
            axis = 2 if s["kind"] == "z" else 1
            denom = dir_w[..., axis]
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            t = (s["coord"] - C[axis]) / denom
            pw = C[None, None, :] + t[..., None] * dir_w
            if s["kind"] == "z":
                a, b = pw[..., 0], pw[..., 1]
            else:
                a, b = pw[..., 0], pw[..., 2]
            hit = (
                (t > 0.15)
                & (a >= s["b0"][0]) & (a < s["b0"][1])
                & (b >= s["b1"][0]) & (b < s["b1"][1])
                & (t < depth)
            )
            if not hit.any():
                continue
            tex = s["tex"]
            ts_ = tex.shape[0]
            txc = ((a - s["b0"][0]) * s["tpm"]) % (ts_ - 1)
            tyc = ((b - s["b1"][0]) * s["tpm"]) % (ts_ - 1)
            x0i = txc.astype(int)
            y0i = tyc.astype(int)
            fxs = (txc - x0i).astype(np.float32)
            fys = (tyc - y0i).astype(np.float32)
            val = (
                tex[y0i, x0i] * (1 - fxs) * (1 - fys)
                + tex[y0i, x0i + 1] * fxs * (1 - fys)
                + tex[y0i + 1, x0i] * (1 - fxs) * fys
                + tex[y0i + 1, x0i + 1] * fxs * fys
            )
            # view-dependent shading: surfaces dim as the ray grazes them
            if view_dependent > 0:
                nrm = np.linalg.norm(dir_w, axis=-1)
                cosang = np.abs(dir_w[..., axis]) / np.maximum(nrm, 1e-9)
                shade = (1.0 - view_dependent) + view_dependent * cosang
            else:
                shade = 1.0
            px = (s["base"] * val * shade).astype(np.float32)
            img = np.where(hit, px, img)
            depth = np.where(hit, t, depth)

        # --- photometric sensor model --------------------------------
        gain = 1.0 + (exposure_jitter * rng.normal() if exposure_jitter else 0.0)
        img = img * gain * vig
        if pixel_noise:
            img = img + rng.normal(0, pixel_noise, img.shape).astype(np.float32)
        img = np.clip(img, 0.0, 1.0).astype(np.float32)

        # --- depth sensor model ---------------------------------------
        d = depth.copy()
        d[~np.isfinite(d)] = np.nan
        if depth_quantize:
            d = np.round(d * depth_scale) / depth_scale
            d[d * depth_scale > 65535] = np.nan
        if edge_holes:
            gy, gx = np.gradient(np.nan_to_num(d, nan=0.0))
            edge = np.hypot(gx, gy) > 0.08
            drop = edge & (rng.random(d.shape) < 0.65)
            d[drop] = np.nan
        if hole_frac > 0:
            n_blobs = max(1, int(hole_frac * 40))
            yy, xx = np.mgrid[0:height, 0:width]
            for _ in range(n_blobs):
                by = rng.uniform(0, height)
                bx = rng.uniform(0, width)
                br = rng.uniform(4, 18)
                d[(yy - by) ** 2 + (xx - bx) ** 2 < br**2] = np.nan
        d = np.where(np.isfinite(d), d, -np.inf).astype(np.float32)

        frames.append(
            {
                "gray": img,
                "depth": d,
                "gt_cam_to_world": pose,
                "timestamp": i / 30.0,
            }
        )
    return frames, K4


def write_tum_format(root, frames, depth_scale=5000.0):
    """Write rendered frames as an on-disk TUM RGB-D dataset (for loader and
    CLI end-to-end tests)."""
    import os

    from PIL import Image

    from bundleadjustment_tpu_torch.data.tum import rotmat_to_quat

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines = [], [], []
    for f in frames:
        ts = f["timestamp"]
        name = f"{ts:.6f}.png"
        rgb8 = (np.clip(f["gray"], 0, 1) * 255).astype(np.uint8)
        Image.fromarray(np.stack([rgb8] * 3, -1)).save(os.path.join(root, "rgb", name))
        d = f["depth"].copy()
        d[~np.isfinite(d)] = 0
        d16 = np.clip(d * depth_scale, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(os.path.join(root, "depth", name))
        rgb_lines.append(f"{ts:.6f} rgb/{name}")
        depth_lines.append(f"{ts:.6f} depth/{name}")
        M = f["gt_cam_to_world"]
        qx, qy, qz, qw = rotmat_to_quat(M[:3, :3])
        t = M[:3, 3]
        gt_lines.append(
            f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    for fname, lines in [
        ("rgb.txt", rgb_lines),
        ("depth.txt", depth_lines),
        ("groundtruth.txt", gt_lines),
    ]:
        with open(os.path.join(root, fname), "w") as fh:
            fh.write("# synthetic\n" + "\n".join(lines) + "\n")


def _aa_to_R(r):
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


@dataclass
class SyntheticScene:
    K4: np.ndarray  # [4] fx fy cx cy
    extr_gt: np.ndarray  # [K, 6] world->camera ground truth
    points_gt: np.ndarray  # [L, 3]
    cam_idx: np.ndarray  # [N] int32
    pt_idx: np.ndarray  # [N] int32
    uv: np.ndarray  # [N, 2] noisy pixel observations
    sigma2: np.ndarray  # [N]
    valid: np.ndarray  # [N] bool
    extr_init: np.ndarray  # [K, 6] perturbed initialization
    points_init: np.ndarray  # [L, 3]
    is_outlier: np.ndarray  # [N] bool (GT corruption labels)
    width: int = 640
    height: int = 480


def make_synthetic_scene(
    n_cams=8,
    n_pts=200,
    obs_per_pt=None,
    pixel_noise=0.5,
    outlier_frac=0.0,
    init_rot_noise=0.02,
    init_trans_noise=0.05,
    init_point_noise=0.05,
    seed=0,
    width=640,
    height=480,
    fx=525.0,
    fy=525.0,
):
    """Cameras on an arc looking at a landmark cloud around the origin.

    Every (camera, point) pair whose projection lands in the image becomes an
    observation (optionally subsampled).  Returns a SyntheticScene with both
    ground truth and a perturbed initialization.
    """
    rng = np.random.default_rng(seed)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    K4 = np.array([fx, fy, cx, cy], np.float32)

    # landmarks in a box in front of the rig
    points = rng.uniform([-2.0, -1.5, 3.0], [2.0, 1.5, 7.0], size=(n_pts, 3))

    # cameras on a gentle arc at z ~ 0, looking +z with small rotations
    extr = np.zeros((n_cams, 6))
    for k in range(n_cams):
        angle = 0.04 * (k - n_cams / 2)
        rvec = np.array([0.0, angle, 0.0]) + rng.normal(0, 0.01, 3)
        # camera centers spread along x
        center = np.array([0.5 * (k - n_cams / 2), 0.05 * rng.normal(), 0.0])
        R = _aa_to_R(rvec)
        t = -R @ center
        extr[k, :3] = rvec
        extr[k, 3:] = t

    cam_all, pt_all, uv_all = [], [], []
    for k in range(n_cams):
        R = _aa_to_R(extr[k, :3])
        xc = points @ R.T + extr[k, 3:]
        z = xc[:, 2]
        u = fx * xc[:, 0] / z + cx
        v = fy * xc[:, 1] / z + cy
        vis = (z > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        idx = np.nonzero(vis)[0]
        if obs_per_pt is not None and len(idx) > 0:
            keep = rng.random(len(idx)) < min(1.0, obs_per_pt / n_cams)
            idx = idx[keep]
        cam_all.append(np.full(len(idx), k, np.int32))
        pt_all.append(idx.astype(np.int32))
        uv_all.append(np.stack([u[idx], v[idx]], -1))

    cam_idx = np.concatenate(cam_all)
    pt_idx = np.concatenate(pt_all)
    uv = np.concatenate(uv_all).astype(np.float64)
    n_obs = len(cam_idx)

    uv += rng.normal(0, pixel_noise, size=uv.shape)
    is_outlier = rng.random(n_obs) < outlier_frac
    uv[is_outlier] += rng.uniform(20, 100, size=(is_outlier.sum(), 2)) * rng.choice(
        [-1, 1], size=(is_outlier.sum(), 2)
    )

    # perturbed initialization (frame 0 kept exact: gauge anchor)
    extr_init = extr.copy()
    extr_init[1:, :3] += rng.normal(0, init_rot_noise, size=(n_cams - 1, 3))
    extr_init[1:, 3:] += rng.normal(0, init_trans_noise, size=(n_cams - 1, 3))
    points_init = points + rng.normal(0, init_point_noise, size=points.shape)

    return SyntheticScene(
        K4=K4,
        extr_gt=extr.astype(np.float32),
        points_gt=points.astype(np.float32),
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        uv=uv.astype(np.float32),
        sigma2=np.ones(n_obs, np.float32),
        valid=np.ones(n_obs, bool),
        extr_init=extr_init.astype(np.float32),
        points_init=points_init.astype(np.float32),
        is_outlier=is_outlier,
        width=width,
        height=height,
    )
