"""Sliding-window BA + pose-graph stitching: the windowed global BA.

Port of `bundleadjustment_tpu/parallel/windows.py`. The trajectory is cut
into overlapping keyframe windows (`make_windows`), each padded to the
windows' common shape, and every window gets its own flat LM solve (its own
lambda, nu, accept test and freeze, as the reference's `vmap` of
`ba_solve`), one after another. With a process group the window axis is
dealt round-robin over the ranks (window w on rank w % D; the window count
padded to a multiple of D with inert all-fixed dummy windows), and the
landmarks shared between windows are reconciled by the **halo exchange**:
each rank sums its windows' solutions per global landmark (position sum
[G, 3], count [G]) and one all-reduce of the packed [G, 4] float32 array
averages the copies, 16 bytes per global landmark whatever the observation
count. The window cameras then reach every rank with one all-gather (the
counterpart of the reference's fetch of a cross-process array).

The window solutions are gauge-free (each pins its own first camera), so a
pose graph (`posegraph.py`) stitches the relative poses of every window
into one trajectory, and a cameras-fixed point refinement seeded with the
halo averages finishes the map.
"""

from __future__ import annotations

import numpy as np
import torch

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.geometry import np_se3
from bundleadjustment_tpu_torch.parallel.multihost import (
    all_gather_rows,
    all_reduce_hook,
    group_rank_size,
)
from bundleadjustment_tpu_torch.parallel.posegraph import (
    make_pose_graph,
    solve_pose_graph,
)
from bundleadjustment_tpu_torch.solvers.lm import LMConfig, ba_solve
from bundleadjustment_tpu_torch.solvers.residuals import BAProblem


def make_windows(n, window=10, stride=5):
    """Overlapping index windows covering range(n), all of length `window`
    (the last one moved back); always >= 1 window."""
    if n <= window:
        return [list(range(n))]
    out = []
    start = 0
    while True:
        out.append(list(range(start, min(start + window, n))))
        if start + window >= n:
            break
        start += stride
    if len(out[-1]) < window:
        out[-1] = list(range(n - window, n))
    return out


def _tensor(a, device, dtype=None):
    x = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return x if dtype is None else x.to(dtype)


_PAD_FILL = {"cam_idx": 0, "pt_idx": 0, "uv": 0, "sigma2": 1, "valid": False,
             "cam_fixed": True, "extr": 0, "points": 0, "gids": -1}


def pad_windows(batch, n_windows):
    """Append inert dummy windows to a stacked window batch (numpy [W, ...]
    arrays) up to `n_windows`: every camera fixed, no valid observation, no
    landmark (gids -1)."""
    out = {}
    for k, a in batch.items():
        extra = np.full((n_windows - len(a),) + a.shape[1:], _PAD_FILL[k], a.dtype)
        out[k] = np.concatenate([a, extra])
    return out


def stack_windows(snaps, pt_index):
    """The window snapshots padded to common camera (Kp), landmark (Lp) and
    observation (Np) counts and stacked: numpy [W, ...] arrays, with gids
    [W, Lp] the compact global landmark ids (`pt_index`: map point id ->
    gid; -1 pads)."""
    Kp = max(s.extr.shape[0] for s in snaps)
    Lp = max(s.points.shape[0] for s in snaps)
    Np = max(s.cam_idx.shape[0] for s in snaps)

    def pad(a, n, fill):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return out

    batch = {
        "cam_idx": np.stack([pad(s.cam_idx, Np, 0) for s in snaps]),
        "pt_idx": np.stack([pad(s.pt_idx, Np, 0) for s in snaps]),
        "uv": np.stack([pad(s.uv, Np, 0) for s in snaps]),
        "sigma2": np.stack([pad(s.sigma2, Np, 1) for s in snaps]),
        "valid": np.stack([pad(s.valid, Np, False) for s in snaps]),
        "cam_fixed": np.stack([pad(s.cam_fixed, Kp, True) for s in snaps]),
        "extr": np.stack([pad(s.extr, Kp, 0) for s in snaps]),
        "points": np.stack([pad(s.points, Lp, 0) for s in snaps]),
    }
    gids = np.full((len(snaps), Lp), -1, np.int64)
    for w, s in enumerate(snaps):
        gids[w, :len(s.pt_ids)] = [pt_index[int(p)] for p in s.pt_ids]
    batch["gids"] = gids
    return batch


def solve_windows(K4, batch, config, n_global, group=None, device="cuda"):
    """Solve this rank's windows of a stacked batch (`stack_windows`, its
    window count a multiple of the group's size) and exchange the halo.

    Returns (cams [W, Kp, 6] numpy, the rows of every window in order;
    cost0 [W], cost [W]; halo_sum [G, 3]; halo_cnt [G]), the same on every
    rank. One all-reduce (the halo, [G, 4] float32) and, with a group, one
    all-gather of the window results."""
    device = resolve_device(device)
    rank, size = group_rank_size(group)
    W, Kp = batch["extr"].shape[:2]
    if W % size:
        raise ValueError(f"{W} windows do not divide over {size} ranks")

    t = lambda a, dtype=None: _tensor(a, device, dtype)  # noqa: E731
    K4_t = t(np.asarray(K4, np.float32))
    halo = torch.zeros((n_global, 4), dtype=torch.float32, device=device)
    rows = []
    for w in range(rank, W, size):
        prob = BAProblem(
            K4=K4_t, cam_idx=t(batch["cam_idx"][w], torch.int64),
            pt_idx=t(batch["pt_idx"][w], torch.int64), uv=t(batch["uv"][w]),
            sigma2=t(batch["sigma2"][w]), valid=t(batch["valid"][w]),
            cam_fixed=t(batch["cam_fixed"][w]),
            pt_fixed=torch.zeros(batch["points"].shape[1], dtype=torch.bool,
                                 device=device))
        cams, pts, info = ba_solve(prob, t(batch["extr"][w]),
                                   t(batch["points"][w]), config)
        g = t(batch["gids"][w])
        ok = g >= 0
        contrib = torch.cat([pts, torch.ones_like(pts[:, :1])], 1)
        halo.index_add_(0, torch.where(ok, g, torch.zeros_like(g)),
                        torch.where(ok[:, None], contrib, torch.zeros_like(contrib)))
        rows.append(torch.cat([cams.reshape(-1), info["cost0"][None],
                               info["cost"][None]]))
    halo = all_reduce_hook(group)(halo)
    mine = torch.stack(rows)  # [W / size, Kp * 6 + 2]
    every = all_gather_rows(mine, group)  # [size, W / size, ...]
    flat = every.transpose(0, 1).reshape(W, -1).cpu().numpy()
    halo = halo.cpu().numpy()
    return (flat[:, :Kp * 6].reshape(W, Kp, 6), flat[:, -2], flat[:, -1],
            halo[:, :3], halo[:, 3])


def windowed_global_ba(scene_map, window=10, stride=5, config=None, pg_iters=15,
                       group=None, device="cuda"):
    """Full-map refinement by window BA + halo exchange + pose-graph
    stitch; mutates the map (keyframe poses, landmark positions) and
    returns an info dict. `group`: a torch.distributed group over whose
    ranks the windows are dealt (None: every window here). Every rank calls
    it on the same map and leaves with the same map."""
    if config is None:
        config = LMConfig(max_iters=8, solver="dense")
    device = resolve_device(device)
    kfs = [int(k) for k in scene_map.active_keyframes()]
    K = len(kfs)
    if K < 3:
        return {"windows": 0}

    windows = make_windows(K, window, stride)
    snaps = [scene_map.snapshot_problem([kfs[i] for i in w], min_obs=2)
             for w in windows]
    all_pt_ids = np.unique(np.concatenate([s.pt_ids for s in snaps]))
    pt_index = {int(p): g for g, p in enumerate(all_pt_ids)}
    batch = stack_windows(snaps, pt_index)
    W = len(snaps)
    size = group_rank_size(group)[1]
    batch = pad_windows(batch, -(-W // size) * size)
    cams_opt, cost0, cost, halo_sum, halo_cnt = solve_windows(
        scene_map.K4, batch, config, len(all_pt_ids), group, device)
    cams_opt, cost0, cost = cams_opt[:W], cost0[:W], cost[:W]

    # halo-averaged landmark positions into the map (the consensus start of
    # the cameras-fixed refinement below)
    has = halo_cnt > 0
    scene_map.pt_pos[all_pt_ids[has]] = (
        halo_sum[has] / halo_cnt[has, None]).astype(np.float32)

    # pose graph over consecutive keyframes of every window, from the
    # window-local solutions (relative poses are gauge-invariant)
    ei, ej, rels = [], [], []
    for wi, w in enumerate(windows):
        for a in range(len(w) - 1):
            Ti = cams_opt[wi, a].astype(np.float64)
            Tj = cams_opt[wi, a + 1].astype(np.float64)
            rels.append(np_se3.rt6_compose(Ti, np_se3.rt6_inverse(Tj)))
            ei.append(w[a])
            ej.append(w[a + 1])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    graph = make_pose_graph(ei, ej, rels, np.ones(len(ei)), fixed, device)
    poses0 = torch.from_numpy(scene_map.kf_pose[kfs].astype(np.float32)).to(device)
    poses_glob, pg_info = solve_pose_graph(graph, poses0, max_iters=pg_iters)
    poses_glob = poses_glob.cpu().numpy().astype(np.float64)
    for i, kf in enumerate(kfs):
        scene_map.set_pose(kf, poses_glob[i])

    # cameras-fixed point refinement on the stitched trajectory
    snap = scene_map.snapshot_problem(kfs, min_obs=2)

    t = lambda a, dtype=None: _tensor(a, device, dtype)  # noqa: E731
    prob = BAProblem(
        K4=t(snap.K4), cam_idx=t(snap.cam_idx, torch.int64),
        pt_idx=t(snap.pt_idx, torch.int64), uv=t(snap.uv),
        sigma2=t(snap.sigma2), valid=t(snap.valid),
        cam_fixed=torch.ones(snap.extr.shape[0], dtype=torch.bool, device=device),
        pt_fixed=torch.zeros(snap.points.shape[0], dtype=torch.bool, device=device))
    _, pts_ref, _ = ba_solve(prob, t(snap.extr), t(snap.points),
                             LMConfig(max_iters=5, solver="dense"))
    scene_map.writeback(snap, snap.extr, pts_ref.cpu().numpy())
    return {
        "windows": W,
        "observations": int(sum(int(np.asarray(s.valid).sum()) for s in snaps)),
        "global_landmarks": int(len(all_pt_ids)),
        "window_cost0": cost0.tolist(),
        "window_cost": cost.tolist(),
        "pg_cost0": float(pg_info["cost0"]),
        "pg_cost": float(pg_info["cost"]),
    }
