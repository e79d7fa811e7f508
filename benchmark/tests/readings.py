"""The readings the limits of a global-BA cell's outputs check are set from:
per seed, the numbers of `reference/global_ba.compare` for the program's
solve (the lower readings) and for the control, the reference in TF32 put
in the program's place (the upper readings), at the cell's own size.

    python3 benchmark/tests/readings.py --workload tum_fr1_xyz.global_ba \
        --seeds 1,2,3 [--device cuda] [--control 1] [--max-iters N]

One JSON line a seed. The program's solve is the timed path's own
(`generators/ba_solves.Requests`, request 0 of the seed); the reference
and the control start from the same perturbed map.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def readings(workload, seeds, device="cuda", control=True, max_iters=None, requests=1):
    """Yield one dict of readings a seed: the program's on requests
    0..requests-1 of the seed ("program" request 0's, "program_all" every
    request's), the control's on request 0."""
    import copy

    import torch

    from generators.ba_solves import Requests, make_map
    from harness.cell import Cell
    from reference import global_ba as ref

    cell = Cell(workload)
    config = copy.deepcopy(cell.config)
    if max_iters is not None:
        config["solve"]["max_iters"] = max_iters
    for seed in seeds:
        scene, fixed = make_map(config, seed)
        req = Requests(config, cell.traffic, scene, fixed, device)
        req.solve(seed, -1)  # warm
        _sync(device)
        t0 = time.perf_counter()
        sols = []
        for i in range(requests):
            cams, pts, _ = req.solve(seed, i)
            sols.append((cams.cpu(), pts.cpu(), [x.cpu() for x in req.start(seed, i)]))
        _sync(device)
        row = {"workload": workload, "seed": seed, "device": str(device),
               "max_iters": config["solve"]["max_iters"],
               "program_s": (time.perf_counter() - t0) / requests}
        cams, pts, start = sols[0]
        del req
        L = scene.points_gt.shape[0]
        args = (scene.K4, scene.cam_idx, scene.pt_idx, scene.uv, scene.sigma2, fixed, L,
                device)
        p64 = ref.Problem(*args, ref.Arith("float64"), **ref.cost_settings(config))
        t0 = time.perf_counter()
        R, t, X, info = ref.solve(p64, *start)
        _sync(device)
        row["reference_s"], row["reference"] = time.perf_counter() - t0, info
        row["program"] = ref.compare(p64, (R, t, X), cams, pts)
        row["program_all"] = [row["program"]]
        for c_i, p_i, start_i in sols[1:]:
            R_i, t_i, X_i, _ = ref.solve(p64, *start_i)
            row["program_all"].append(ref.compare(p64, (R_i, t_i, X_i), c_i, p_i))
        if control:
            pc = ref.Problem(*args, ref.Arith("tf32"), **ref.cost_settings(config))
            Rc, tc, Xc, info_c = ref.solve(pc, *start)
            row["control_info"] = info_c
            row["control"] = ref.compare(
                p64, (R, t, X), torch.cat([ref.R_to_aa(Rc.double()), tc.double()], -1), Xc)
            del pc
        del p64
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        yield row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--requests", type=int, default=1, help="program solves a seed")
    a = ap.parse_args(argv)
    for row in readings(a.workload, [int(s) for s in a.seeds.split(",")], a.device,
                        bool(a.control), a.max_iters, a.requests):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
