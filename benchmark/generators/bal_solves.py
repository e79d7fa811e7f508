"""Traffic of global bundle-adjustment solves with BAL's camera: a closed
loop with one client.

The configuration's `map` is made on the host from the map's own seed
(`harness/bal_scene.make_bal_scene`; one problem, as Dubrovnik is one, the
same in every run), handed to the program in its dense layout through its
public `densify_problem(..., camera_model="bal")`, and kept on the card.
Each request is one exact solve, `dense_ba_solve` with the configuration's
`solve` settings and its fixed cameras, from the map's ground truth
perturbed afresh on the card: noise drawn by a `torch.Generator` on the
card, seeded from the run's seed and the request's index
(`ba_solves.request_seed`), in two calls (the cameras but the fixed ones,
and every landmark), at the traffic's `start` sizes: the axis-angle and the
translation moved by normal noise, the focal length scaled by 1 + normal
noise (`focal_rel`), k1 and k2 set to 0, as Bundler starts them. A request
is timed from before its perturbation to the synchronize after its solve;
the next starts when it has ended.

Everything else is `ba_solves.py`'s: the window, the traced solves, the
outputs check (against `reference/bal_ba.py`) and the result's fields, with
`layer["camera_width"]` 9 for the readers of the cells with BAL's camera.

Traffic keys: `start` (rot_rad, trans, point, focal_rel: standard
deviations of the perturbation), `warmup_solves`, `check_solves`,
`trace_solves` (as `ba_solves.py`'s).
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from generators.ba_solves import _sync, request_seed  # noqa: E402
from harness import bounds, spans  # noqa: E402
from harness.bal_scene import make_bal_scene  # noqa: E402

WIDTH = 9  # parameters a camera


def make_map(config):
    """(observed BALData, ground truth BALData, cam_fixed) of the
    configuration's map, drawn from its own `seed`, whose counts take the
    harness's names: `n_keyframes` cameras (photos), `n_landmarks` points,
    `n_observations`, and `max_track` (None: as long as there are cameras,
    at most 64)."""
    m, s = config["map"], config["sensor"]
    if m["generator"] != "bal_ring":
        raise ValueError(f"unknown map generator {m['generator']!r}")
    K = m["n_keyframes"]
    obs, gt = make_bal_scene(
        K, m["n_landmarks"], m["n_observations"], max_track=m["max_track"] or min(K, 64),
        width=s["width"], height=s["height"], f_range=tuple(s["f_range"]),
        k1_abs=tuple(s["k1_abs"]), k2_abs=tuple(s["k2_abs"]), radius=m["radius"],
        half_height=m["half_height"], fill=m["fill"], pixel_noise=m["pixel_noise_px"],
        track_arc=m["track_arc"], seed=m["seed"])
    cam_fixed = np.zeros(K, bool)
    cam_fixed[config["solve"]["fixed_cameras"]] = True
    return obs, gt, cam_fixed


class Requests:
    """The program's side: the problem on the device and the solve of one
    request."""

    def __init__(self, config, traffic, obs, gt, cam_fixed, device):
        import torch

        from bundleadjustment_tpu_torch.solvers import lm, residuals
        from bundleadjustment_tpu_torch.solvers.dense_ba import (
            dense_ba_solve,
            densify_problem,
        )

        sv = config["solve"]
        stated = (sv["huber_delta"], sv["cheirality_penalty"])
        if stated != (residuals.HUBER_DELTA, lm.CHEIRALITY_PENALTY):
            raise ValueError(f"the configuration states Huber delta and cheirality penalty "
                             f"{stated}; the program computes "
                             f"{(residuals.HUBER_DELTA, lm.CHEIRALITY_PENALTY)}")
        prec = sv["precision"]
        self.dtype = getattr(torch, prec["dtype"])
        torch.backends.cuda.matmul.allow_tf32 = bool(prec["tf32"])
        n = len(obs.cam_idx)
        L = len(gt.points)
        self.prob, dropped = densify_problem(
            None, obs.cam_idx, obs.pt_idx, np.asarray(obs.uv, np.float32),
            np.ones(n, np.float32), np.ones(n, bool), cam_fixed, L,
            max_obs=sv["max_obs_per_landmark"], device=device,
            camera_model=sv["camera_model"])
        if dropped:
            raise ValueError(f"densify dropped {dropped} observations")
        self.lm = lm.LMConfig(max_iters=sv["max_iters"], lam0=sv["lam0"], rtol=sv["rtol"],
                              solver=sv["solver"], robust=sv["robust"] == "huber")
        self.solver = dense_ba_solve
        self.device = device
        self.gt_c = torch.from_numpy(gt.cameras.astype(np.float32)).to(device)
        self.gt_p = torch.from_numpy(gt.points.astype(np.float32)).to(device)
        self.fixed = torch.from_numpy(cam_fixed).to(device)
        st = traffic["start"]
        self.cam_sd = torch.tensor([st["rot_rad"]] * 3 + [st["trans"]] * 3
                                   + [st["focal_rel"]], dtype=torch.float32, device=device)
        self.point_sd = st["point"]

    def start(self, seed, i):
        """(cams0 [K, 9], points0 [L, 3]) of request i, on the device."""
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed(request_seed(seed, i))
        noise = torch.randn(self.gt_c[:, :7].shape, generator=g,
                            device=self.device) * self.cam_sd
        c = torch.cat([self.gt_c[:, :6] + noise[:, :6],
                       self.gt_c[:, 6:7] * (1.0 + noise[:, 6:]),
                       torch.zeros_like(self.gt_c[:, 7:])], 1)
        c = torch.where(self.fixed[:, None], self.gt_c, c)
        dp = torch.randn(self.gt_p.shape, generator=g, device=self.device) * self.point_sd
        return c, self.gt_p + dp

    def solve(self, seed, i):
        cams0, pts0 = self.start(seed, i)
        cams, pts, info = self.solver(self.prob, cams0, pts0, self.lm)
        if cams.dtype != self.dtype or pts.dtype != self.dtype:
            raise ValueError(f"the program solved in {cams.dtype}, not {self.dtype}")
        return cams, pts, info["cost"]


def run(ctx):
    import torch

    from harness.trace import pick, traced
    from reference import bal_ba as ref

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    obs, gt, cam_fixed = make_map(cfg)
    req = Requests(cfg, tr, obs, gt, cam_fixed, ctx.device)
    for j in range(tr["warmup_solves"]):
        req.solve(ctx.seed, -1 - j)
    _sync(ctx.device)
    # the program's span records from here on are the window's (the readers
    # of host time read the last untraced ones): a window of a few dozen
    # solves would otherwise keep the warm-up's eager first solve among them
    clear = getattr(getattr(sys.modules.get(spans.SOLVER), "TIMER", None), "clear_records",
                    None)
    if clear is not None:
        clear()
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
    L = len(gt.points)
    p64 = ref.Problem(obs.cam_idx, obs.pt_idx, obs.uv, np.ones(len(obs.cam_idx)), cam_fixed,
                      L, ctx.device, ref.Arith("float64"), **ref.cost_settings(cfg))
    checks = {}
    for i in sample:
        c, X, info = ref.solve(p64, *starts[i])
        got = ref.compare(p64, (c, X), *kept[i])
        ctx.log(f"solve {i}: reference {info}, {got}")
        for k, v in got.items():
            checks[k] = max(checks.get(k, -np.inf), v)
    ctx.log(f"reference {time.perf_counter() - t0:.3f} s for {len(sample)} solves")

    out = {"attempted": len(finite), "failed": finite.count(False),
           "memory_peak_bytes": int(mem), "checks": checks}
    st = bounds.problem_stats(obs.cam_idx, obs.pt_idx, cam_fixed, L)
    if ctx.trace:
        chosen = pick(traces)
        out["layer"] = {"kind": "ba", "camera_width": WIDTH, "trace": chosen,
                        "host_trace": host_trace, "stats": st,
                        "iters": cfg["solve"]["max_iters"], "solve_s": solve_s,
                        "device_name": (torch.cuda.get_device_name(0)
                                        if torch.device(ctx.device).type == "cuda" else ""),
                        "sessions": [t.summary() for t in traces + [host_trace]]}
    else:
        out["e2e"] = {"ba_solve_ms": solve_s * 1e3, "setup_s": setup_s}
    return out
