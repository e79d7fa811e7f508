"""LM iterations/s of the dense BA solve and sustained ms a frame of the batched
frontend, with roofline fields; one JSON line a run.

    python -m bundleadjustment_tpu_torch.bench.solve              # the card
    python -m bundleadjustment_tpu_torch.bench.solve --device cpu # plain versions

Port of the JAX package's root-level `bench.py` and `bench_large.py`: the
dense landmark-major solve (`solvers/dense_ba.dense_ba_solve`) on
`make_synthetic_scene` problems at the two records' shapes, by the exact
Schur solve (kernels B and C, `cholesky_ex`) and by PCG (kernel B, PCG in
PyTorch):

- 64 cameras / 10k landmarks / 8 observations a landmark, O <= 16, 10 LM
  iterations, 50 PCG iterations (`bench.py:25-30`);
- 128 cameras / 100k landmarks / 6 observations a landmark, O <= 8, 5 LM
  iterations, 40 PCG iterations (`bench_large.py:17-22`).

Each line gives the best-of-3 iterations/s of one solve and the marginal ms
of an iteration: a least-squares line through wall times at several
iteration counts (`utils/marginal.measure_marginal`; each time the best of
3, each timed call after an untimed one and ended by a synchronize), with
the roofline fields of `utils/flops.solve_roofline`: the port's own bound
of an iteration and the share of it reached ("port_bound_share", at most
1), and the JAX package's FLOP model under "jax_model_..." names (its ratio
to the card's float32 peak counts TPU work the port does not do and may
exceed 1: see that module). The frontend line is `ops/features.
detect_batch` at B = 32, 640x480, 1000 features, 8 levels: sustained ms a
frame (`utils/marginal.sustained_ms`, 4 back-to-back batches ended by a
synchronize, best of 3) with `utils/flops.frontend_fields`.

The JAX bench's CPU comparison is this script with `--device cpu`: the
plain PyTorch versions on the host, a run of its own (a run on the card
never falls back to it).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

SHAPES = {
    "64c_10k": dict(n_cams=64, n_pts=10_000, obs_per_pt=8, max_obs=16, lm_iters=10,
                    pcg_iters=50, counts=(16, 48, 96, 144)),
    "128c_100k": dict(n_cams=128, n_pts=100_000, obs_per_pt=6, max_obs=8,
                      lm_iters=5, pcg_iters=40, counts=(5, 15, 40)),
}


def build_problem(n_cams, n_pts, obs_per_pt, max_obs, device, seed=0):
    """(scene, DenseBAProblem, observations kept) of a synthetic problem with
    camera 0 fixed."""
    from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem

    sc = make_synthetic_scene(n_cams=n_cams, n_pts=n_pts, obs_per_pt=obs_per_pt,
                              pixel_noise=0.5, seed=seed)
    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[0] = True
    dense, dropped = densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                     sc.valid, cam_fixed, n_pts, max_obs=max_obs,
                                     device=device)
    return sc, dense, int(sc.valid.sum()) - dropped


def solve_bench(n_cams, n_pts, obs_per_pt, max_obs, lm_iters, pcg_iters, counts,
                solver="dense", device="cuda", repeats=3):
    """One JSON-ready dict: iterations/s and the marginal fit of
    `dense_ba_solve` (`solver` "dense" or "pcg") at one shape."""
    import torch

    from bundleadjustment_tpu_torch.bench import device_name, load_kernels, sync
    from bundleadjustment_tpu_torch.solvers.dense_ba import dense_ba_solve
    from bundleadjustment_tpu_torch.solvers.lm import LMConfig
    from bundleadjustment_tpu_torch.utils.flops import solve_roofline
    from bundleadjustment_tpu_torch.utils.marginal import measure_marginal

    load_kernels(device)
    sc, dense, n_obs = build_problem(n_cams, n_pts, obs_per_pt, max_obs, device)
    cams0 = torch.from_numpy(sc.extr_init).to(device)
    pts0 = torch.from_numpy(sc.points_init).to(device)
    O = int(dense.cam_idx.shape[1])  # densify trims unused slots

    def run(iters):
        """Seconds of one solve of `iters` LM iterations (after an untimed
        one) and its info."""
        cfg = LMConfig(max_iters=iters, solver=solver, pcg_iters=pcg_iters)
        dense_ba_solve(dense, cams0, pts0, cfg)
        sync(device)
        t0 = time.perf_counter()
        _, _, info = dense_ba_solve(dense, cams0, pts0, cfg)
        sync(device)
        return time.perf_counter() - t0, info

    best, info = min((run(lm_iters) for _ in range(repeats)), key=lambda r: r[0])
    iters_s = lm_iters / best
    fit = measure_marginal(lambda it: run(it)[0], iter_counts=counts, repeats=repeats)
    pcg = pcg_iters if solver == "pcg" else 0
    return {
        "metric": "ba_iterations_per_s",
        "value": round(iters_s, 3),
        "unit": "iter/s",
        "device": device_name(device),
        "n_cams": n_cams,
        "n_landmarks": n_pts,
        "n_obs": n_obs,
        "max_obs": O,
        "solver": "exact_dense_schur" if solver == "dense" else "pcg",
        "lm_iters": lm_iters,
        "pcg_iters": pcg,
        "cost_reduction": round(float(info["cost0"]) / max(float(info["cost"]), 1e-12), 1),
        "layout": "dense_landmark_major_cm",
        **solve_roofline(1e3 / iters_s, dense, device, solver, pcg),
        "marginal_iter_per_s": round(fit["iters_per_s"], 2),
        **solve_roofline(fit["slope_s"] * 1e3, dense, device, solver, pcg,
                         prefix="marginal_"),
        "marginal_ms_per_iter": round(fit["slope_s"] * 1e3, 4),
        "marginal_ms_stderr": round(fit["slope_stderr_s"] * 1e3, 4),
        "marginal_fit_intercept_ms": round(fit["intercept_s"] * 1e3, 2),
        "marginal_fit_points": [[it, round(t, 5)] for it, t in fit["points"]],
    }


def frontend_bench(device="cuda", B=32, H=480, W=640, n_features=1000, n_levels=8,
                   n_sustained=4, repeats=3):
    """Sustained ms a frame of `detect_batch` on B random frames, with the
    frontend roofline."""
    import torch

    from bundleadjustment_tpu_torch.bench import device_name, sync
    from bundleadjustment_tpu_torch.ops.features import FeatureConfig, detect_batch
    from bundleadjustment_tpu_torch.utils.flops import frontend_fields
    from bundleadjustment_tpu_torch.utils.marginal import sustained_ms

    cfg = FeatureConfig(n_features=n_features, n_levels=n_levels)
    imgs = torch.from_numpy(
        np.random.default_rng(0).random((B, H, W)).astype(np.float32)).to(device)
    ms = sustained_ms(lambda: detect_batch(imgs, cfg), lambda: sync(device),
                      n=n_sustained, reps=repeats) / B
    return {
        "metric": "frontend_batch_ms_per_frame",
        "value": round(ms, 4),
        "unit": "ms/frame",
        "device": device_name(device),
        "batch": B, "width": W, "height": H, "n_features": n_features,
        "n_levels": n_levels,
        **frontend_fields(ms, H, W, device, n_features, n_levels, prefix="frontend_"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from bundleadjustment_tpu_torch.bench import card_line
    from bundleadjustment_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    smi = card_line(device)
    if smi:
        print(smi, flush=True)
    for shape in SHAPES:
        for solver in ("dense", "pcg"):
            out = solve_bench(**SHAPES[shape], solver=solver, device=device)
            print(json.dumps({**out, "shape": shape, "nvidia_smi": smi}), flush=True)
    print(json.dumps({**frontend_bench(device), "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
