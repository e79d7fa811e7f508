"""Traffic of global bundle-adjustment solves: a closed loop with one client.

The configuration's `map` is made on the host from the seed
(`harness/scenes.make_track_scene`), handed to the program in its dense
layout through its public `densify_problem`, and kept on the card. Each
request is one exact solve, `dense_ba_solve` with the configuration's
`solve` settings and its fixed keyframes, from the map's ground truth
perturbed afresh on the card: noise drawn by a `torch.Generator` on the
card, seeded from the run's seed and the request's index, in two calls
(the cameras but the fixed ones, and every landmark), at the traffic's
`start` sizes. A request is timed from before its perturbation to the
synchronize after its solve; the next starts when it has ended.

Both kinds of run time the same window of back-to-back solves. With
`--trace 1` the run then traces `trace_solves` more solves, each in a
profiler session of its own with CUDA activity only, and one with the
host's ops too; the per-layer metrics divide by the window's untraced
time a solve, since the profiler adds to a solve's wall time and not to
its device time.

Traffic keys: `start` (rot_rad, trans_m, point_m: standard deviations of
the perturbation), `warmup_solves` (untimed, in set-up), `check_solves`
(solves of the window drawn from the seed and compared with the reference
once the window has closed), `trace_solves` (the traced sessions).
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import bounds  # noqa: E402
from harness.scenes import make_track_scene  # noqa: E402


def request_seed(seed, i):
    """The torch seed of request i (negative i: the warm-up solves)."""
    return (int(seed) * 1_000_003 + 7919 * (int(i) + 16)) % (1 << 63)


def make_map(config, seed):
    """(scene, cam_fixed) of the configuration's keyframe map."""
    m = config["map"]
    s = config["sensor"]
    if m["generator"] != "track_scene":
        raise ValueError(f"unknown map generator {m['generator']!r}")
    # the generator puts the principal point at the image's centre
    if (s["cx"], s["cy"]) != ((s["width"] - 1) / 2, (s["height"] - 1) / 2):
        raise ValueError(f"principal point {(s['cx'], s['cy'])} is not the image centre")
    scene = make_track_scene(
        n_cams=m["n_keyframes"], n_pts=m["n_landmarks"], n_obs=m["n_observations"],
        n_all=m["n_seen_by_all"], max_track=m["max_track"],
        pixel_noise=m["pixel_noise_px"], seed=seed, width=s["width"],
        height=s["height"], fx=s["fx"], fy=s["fy"])
    cam_fixed = np.zeros(m["n_keyframes"], bool)
    cam_fixed[config["solve"]["fixed_keyframes"]] = True
    return scene, cam_fixed


class Requests:
    """The program's side: the problem on the device and the solve of one
    request."""

    def __init__(self, config, traffic, scene, cam_fixed, device):
        import torch

        from bundleadjustment_tpu_torch.solvers import lm, residuals
        from bundleadjustment_tpu_torch.solvers.dense_ba import (
            dense_ba_solve,
            densify_problem,
        )

        sv = config["solve"]
        # the program computes the cost the configuration states, or the
        # run stops here
        stated = (sv["huber_delta"], sv["cheirality_penalty"])
        if stated != (residuals.HUBER_DELTA, lm.CHEIRALITY_PENALTY):
            raise ValueError(f"the configuration states Huber delta and cheirality penalty "
                             f"{stated}; the program computes "
                             f"{(residuals.HUBER_DELTA, lm.CHEIRALITY_PENALTY)}")
        prec = sv["precision"]
        self.dtype = getattr(torch, prec["dtype"])
        torch.backends.cuda.matmul.allow_tf32 = bool(prec["tf32"])
        L = scene.points_gt.shape[0]
        self.prob, dropped = densify_problem(
            scene.K4, scene.cam_idx, scene.pt_idx, scene.uv, scene.sigma2,
            scene.valid, cam_fixed, L, max_obs=sv["max_obs_per_landmark"],
            device=device)
        if dropped:
            raise ValueError(f"densify dropped {dropped} observations")
        self.lm = lm.LMConfig(max_iters=sv["max_iters"], lam0=sv["lam0"], rtol=sv["rtol"],
                              solver=sv["solver"], robust=sv["robust"] == "huber")
        self.solver = dense_ba_solve
        self.device = device
        self.gt_c = torch.from_numpy(scene.extr_gt).to(device)
        self.gt_p = torch.from_numpy(scene.points_gt).to(device)
        self.fixed = torch.from_numpy(cam_fixed).to(device)
        st = traffic["start"]
        self.cam_sd = torch.tensor([st["rot_rad"]] * 3 + [st["trans_m"]] * 3,
                                   dtype=torch.float32, device=device)
        self.point_sd = st["point_m"]

    def start(self, seed, i):
        """(cams0 [K, 6], points0 [L, 3]) of request i, on the device."""
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed(request_seed(seed, i))
        dc = torch.randn(self.gt_c.shape, generator=g, device=self.device) * self.cam_sd
        dc = torch.where(self.fixed[:, None], torch.zeros_like(dc), dc)
        dp = torch.randn(self.gt_p.shape, generator=g, device=self.device) * self.point_sd
        return self.gt_c + dc, self.gt_p + dp

    def solve(self, seed, i):
        cams0, pts0 = self.start(seed, i)
        cams, pts, info = self.solver(self.prob, cams0, pts0, self.lm)
        if cams.dtype != self.dtype or pts.dtype != self.dtype:
            raise ValueError(f"the program solved in {cams.dtype}, not {self.dtype}")
        return cams, pts, info["cost"]


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx):
    import torch

    from harness.trace import pick, traced
    from reference import global_ba as ref

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    scene, cam_fixed = make_map(cfg, ctx.seed)
    req = Requests(cfg, tr, scene, cam_fixed, ctx.device)
    for j in range(tr["warmup_solves"]):
        req.solve(ctx.seed, -1 - j)
    _sync(ctx.device)
    setup_s = ctx.age()
    ctx.log(f"set-up {setup_s:.3f} s")

    outs, times = [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        outs.append(req.solve(ctx.seed, len(outs)))
        _sync(ctx.device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - t_start >= ctx.seconds:
            break
    window_s = t1 - t_start
    solve_s = window_s / len(times)
    q = statistics.quantiles(times, n=20, method="inclusive") if len(times) > 1 else times
    ctx.log(f"window {window_s:.3f} s, {len(outs)} solves; ms a solve: mean "
            f"{solve_s * 1e3:.2f}, min {min(times) * 1e3:.2f}, median "
            f"{statistics.median(times) * 1e3:.2f}, p95 {q[-1] * 1e3:.2f}, max "
            f"{max(times) * 1e3:.2f}")

    traces, n = [], len(outs)
    if ctx.trace:
        traced(lambda: req.solve(ctx.seed, n))  # the profiler's own warm-up
        for i in range(tr["trace_solves"]):
            traces.append(traced(lambda i=i: req.solve(ctx.seed, n + 1 + i))[0])
        # one more session with the host's ops, to put the idle gaps and
        # the kernels to the ops that launched them
        host_trace, _ = traced(lambda: req.solve(ctx.seed, n + 1 + len(traces)),
                               host_ops=True)

    finite = [bool(torch.isfinite(c).all() & torch.isfinite(p).all() & torch.isfinite(cost))
              for c, p, cost in outs]
    mem = (torch.cuda.max_memory_allocated() if torch.device(ctx.device).type == "cuda"
           else 0)

    # the outputs check, once the window has closed and the program's state
    # is freed: a sample of the window's solves drawn from the seed
    rng = np.random.default_rng([ctx.seed, 1])
    sample = sorted(int(i) for i in rng.choice(len(outs), min(tr["check_solves"], len(outs)),
                                               replace=False))
    kept = {i: (outs[i][0].cpu(), outs[i][1].cpu()) for i in sample}
    starts = {i: tuple(x.cpu() for x in req.start(ctx.seed, i)) for i in sample}
    del req, outs
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    L = scene.points_gt.shape[0]
    p64 = ref.Problem(scene.K4, scene.cam_idx, scene.pt_idx, scene.uv, scene.sigma2,
                      cam_fixed, L, ctx.device, ref.Arith("float64"),
                      **ref.cost_settings(cfg))
    checks = {}
    for i in sample:
        R, t, X, info = ref.solve(p64, *starts[i])
        got = ref.compare(p64, (R, t, X), *kept[i])
        ctx.log(f"solve {i}: reference {info}, {got}")
        for k, v in got.items():
            checks[k] = max(checks.get(k, -np.inf), v)
    ctx.log(f"reference {time.perf_counter() - t0:.3f} s for {len(sample)} solves")

    out = {"attempted": len(finite), "failed": finite.count(False),
           "memory_peak_bytes": int(mem), "checks": checks}
    st = bounds.problem_stats(scene.cam_idx, scene.pt_idx, cam_fixed, L)
    if ctx.trace:
        chosen = pick(traces)
        out["layer"] = {"kind": "ba", "trace": chosen, "host_trace": host_trace, "stats": st,
                        "iters": cfg["solve"]["max_iters"], "solve_s": solve_s,
                        "device_name": (torch.cuda.get_device_name(0)
                                        if torch.device(ctx.device).type == "cuda" else ""),
                        "sessions": [t.summary() for t in traces + [host_trace]]}
    else:
        out["e2e"] = {"ba_solve_ms": solve_s * 1e3, "setup_s": setup_s}
    return out
