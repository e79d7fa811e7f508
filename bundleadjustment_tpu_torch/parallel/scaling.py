"""Scaling-efficiency harness for the landmark-sharded BA.

Port of `bundleadjustment_tpu/parallel/scaling.py`: LM iterations per
second of the sharded solve over the SAME total problem at growing world
sizes (strong scaling) or proportionally grown problems (weak scaling),
and efficiency = speedup / world size. The reference builds meshes of the
first d devices; here every rank of the default process group calls
`measure_scaling`, which forms a subgroup of the first d ranks for each
world size d (a rank outside it waits at a barrier). `psum_bytes_per_iter`
and `predicted_efficiency` are the reference's arithmetic, unchanged.
"""

from __future__ import annotations

import time

import numpy as np


def psum_bytes_per_iter(n_cams: int) -> int:
    """Bytes all-reduced per LM iteration of the landmark-sharded dense
    exact-Schur solve (`sharded_dense_ba`, `solver="dense"`), a function of
    the camera count only: S [6K, 6K], the rhs rows [K, 6], the 27 camera
    rows [K, 27] and the cost, float32."""
    K = n_cams
    return 4 * (36 * K * K + 27 * K + 6 * K + 1)


def predicted_efficiency(
    n_cams: int,
    n_landmarks: int,
    n_devices: int,
    obs_per_pt: int = 6,
    link_gbps: float = 45.0,
    mxu_tflops: float = 25.0,
) -> float:
    """The reference's analytic scaling-efficiency floor of the sharded
    exact-Schur solve on a D-device ring: comm = 2 psum bytes (D-1)/D over
    the link rate, compute = the Q Q^T flops / D over the matmul rate,
    efficiency = compute / (compute + comm). The default rates are the
    reference's (its TPU's links and matmul rate), not a GPU's: pass the
    link and matmul rates of the machine being modelled."""
    K, L, D = n_cams, n_landmarks, n_devices
    comm_s = 2 * psum_bytes_per_iter(K) * (D - 1) / D / (link_gbps * 1e9)
    qqt_flops = 2 * (6 * K) ** 2 * (3 * L)
    compute_s = qqt_flops / D / (mxu_tflops * 1e12)
    return compute_s / (compute_s + comm_s)


def measure_scaling(
    n_landmarks=8192,
    n_cams=32,
    obs_per_pt=6,
    device_counts=None,
    lm_iters=5,
    pcg_iters=30,
    repeats=2,
    weak=False,
    seed=0,
    layout="dense",
    solver="dense",
    device="cuda",
):
    """Returns {"mode", "device_counts", "results": [{"devices",
    "landmarks", "iters_per_s", "wall_s", "efficiency"}, ...]} on every rank
    of the default process group (rank 0's clock). Without a group: world
    size 1 and no collectives. layout: "dense" (`sharded_dense_ba`) or
    "flat" (`sharded_ba`, PCG)."""
    import torch
    import torch.distributed as dist

    from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu_torch.device import resolve_device
    from bundleadjustment_tpu_torch.parallel.multihost import default_group
    from bundleadjustment_tpu_torch.parallel.sharded_ba import (
        shard_problem,
        sharded_ba_solve,
    )
    from bundleadjustment_tpu_torch.parallel.sharded_dense_ba import (
        shard_dense_problem,
        sharded_dense_ba_solve,
    )
    from bundleadjustment_tpu_torch.solvers.lm import LMConfig

    device = resolve_device(device)
    world = default_group()
    rank, size = (0, 1) if world is None else (dist.get_rank(), dist.get_world_size())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= size]

    results = []
    for d in device_counts:
        group = None if world is None else dist.new_group(list(range(d)))
        row = None
        if rank < d:
            L = n_landmarks * d if weak else n_landmarks
            sc = make_synthetic_scene(n_cams=n_cams, n_pts=L,
                                      obs_per_pt=obs_per_pt, pixel_noise=0.5,
                                      seed=seed)
            cam_fixed = np.zeros(n_cams, bool)
            cam_fixed[0] = True
            cfg = LMConfig(max_iters=lm_iters, solver=solver, pcg_iters=pcg_iters)
            cams0 = torch.from_numpy(sc.extr_init).to(device)
            if layout == "dense":
                prob, pts, _, _ = shard_dense_problem(
                    sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
                    cam_fixed, sc.points_init, d, rank, device=device)

                def run():
                    return sharded_dense_ba_solve(prob, cams0, pts, cfg,
                                                  group)[0].cpu()
            else:
                prob, _, _ = shard_problem(
                    sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
                    cam_fixed, sc.points_init, d, rank, device=device)

                def run():
                    return sharded_ba_solve(prob, cams0, cfg, group)[0].cpu()

            run()  # warm-up: builds the kernels and the communicators
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                run()
                best = min(best, time.perf_counter() - t0)
            row = {"devices": d, "landmarks": L, "iters_per_s": lm_iters / best,
                   "wall_s": best}
        if world is not None:
            out = [None]
            if rank == 0:
                out = [row]
            dist.broadcast_object_list(out, src=0)
            row = out[0]
            dist.barrier()
        results.append(row)

    base = results[0]["iters_per_s"]
    for r in results:
        r["efficiency"] = (r["iters_per_s"] / base if weak
                           else r["iters_per_s"] / (base * r["devices"]))
    return {"mode": "weak" if weak else "strong",
            "device_counts": list(device_counts), "results": results}
