"""Absolute Trajectory Error with Horn alignment and optimal scale.

Implements the same math as the reference's offline evaluation scripts
(`ba_project/src/metrics/evaluate_ate_scale.py:51-97,173-180` — the
Sturm/TUM tooling with Mur-Artal's scale extension): closed-form SVD (Horn)
rotation between zero-centered trajectories, the optimal uniform scale, and
RMSE/mean/median statistics of the residual translational error.

Copied from `bundleadjustment_tpu/metrics/ate.py` (numpy only; only the
argparse `prog` name and the import of the TUM reader differ), so that the
port runs where the JAX package is absent.
"""

from __future__ import annotations

import numpy as np


def align_horn_scale(model, data):
    """Align `model` (estimated, [N,3]) to `data` (ground truth, [N,3]).

    Returns (R [3,3], t [3], s float) such that  s * R @ model_i + t ~= data_i.
    """
    model = np.asarray(model, np.float64).T  # [3, N]
    data = np.asarray(data, np.float64).T
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mc = model - mu_m
    dc = data - mu_d

    W = dc @ mc.T  # covariance (data x model)
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt

    rot_mc = R @ mc
    # optimal scale (Mur-Artal): s = <dc, R mc> / <R mc, R mc>
    dots = float(np.sum(dc * rot_mc))
    norms = float(np.sum(rot_mc * rot_mc))
    s = dots / max(norms, 1e-12)

    t = mu_d - s * (R @ mu_m)
    return R, t[:, 0], s


def ate_rmse(model, data, with_scale=True):
    """Aligned RMSE (meters) between trajectories."""
    R, t, s = align_horn_scale(model, data)
    if not with_scale:
        s = 1.0
    aligned = (s * (R @ np.asarray(model, np.float64).T)).T + t
    err = np.linalg.norm(aligned - data, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def plot_trajectories(path, est_xyz, gt_xyz, aligned_xyz=None):
    """Save the reference script's trajectory comparison plot
    (evaluate_ate_scale.py's --plot)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    gt = np.asarray(gt_xyz)
    ax.plot(gt[:, 0], gt[:, 1], "k-", label="ground truth")
    est = np.asarray(est_xyz)
    ax.plot(est[:, 0], est[:, 1], "b:", label="estimated (raw)")
    if aligned_xyz is not None:
        al = np.asarray(aligned_xyz)
        ax.plot(al[:, 0], al[:, 1], "r-", label="estimated (aligned)")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def evaluate_ate(est_ts, est_xyz, gt_ts, gt_xyz, max_difference=0.02):
    """Timestamp-associated ATE summary (associate.py + evaluate_ate_scale.py).

    Returns dict with rmse / mean / median / std / min / max / n_pairs and the
    alignment (R, t, s).
    """
    est_ts = np.asarray(est_ts)
    gt_ts = np.asarray(gt_ts)
    pairs = []
    used_gt = set()
    order = np.argsort(est_ts)
    for i in order:
        j = int(np.argmin(np.abs(gt_ts - est_ts[i])))
        if abs(gt_ts[j] - est_ts[i]) < max_difference and j not in used_gt:
            used_gt.add(j)
            pairs.append((i, j))
    if len(pairs) < 2:
        raise ValueError("fewer than 2 associated trajectory pairs")
    ei = np.array([p[0] for p in pairs])
    gi = np.array([p[1] for p in pairs])
    model = np.asarray(est_xyz)[ei]
    data = np.asarray(gt_xyz)[gi]
    R, t, s = align_horn_scale(model, data)
    aligned = (s * (R @ model.T)).T + t
    err = np.linalg.norm(aligned - data, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "n_pairs": len(pairs),
        "scale": float(s),
        "R": R,
        "t": t,
    }


def main(argv=None):
    """CLI mirroring the reference's offline evaluation
    (`evaluate_ate_scale.py groundtruth.txt estimated.txt [--plot out.png]`)."""
    import argparse

    from bundleadjustment_tpu_torch.data.tum import read_tum_trajectory

    p = argparse.ArgumentParser(prog="bundleadjustment_tpu_torch.metrics.ate")
    p.add_argument("groundtruth")
    p.add_argument("estimated")
    p.add_argument("--max-difference", type=float, default=0.02)
    p.add_argument("--plot", default="")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    gt_ts, gt_mats = read_tum_trajectory(args.groundtruth)
    est_ts, est_mats = read_tum_trajectory(args.estimated)
    stats = evaluate_ate(
        est_ts, est_mats[:, :3, 3], gt_ts, gt_mats[:, :3, 3],
        max_difference=args.max_difference,
    )
    if args.plot:
        aligned = (stats["scale"] * (stats["R"] @ est_mats[:, :3, 3].T)).T + stats["t"]
        plot_trajectories(args.plot, est_mats[:, :3, 3], gt_mats[:, :3, 3], aligned)
    if args.verbose:
        for k in ("rmse", "mean", "median", "std", "min", "max", "n_pairs", "scale"):
            print(f"absolute_translational_error.{k} {stats[k]}")
    else:
        # reference prints bare RMSE (evaluate_ate_scale.py:180)
        print(stats["rmse"])
    return stats


if __name__ == "__main__":
    main()
