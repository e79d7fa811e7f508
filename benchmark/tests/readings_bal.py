"""The readings the limits of a BAL cell's outputs check are set from: per
seed, the numbers of `reference/bal_ba.compare` for the program's solve (the
lower readings), for the control, the reference in TF32 put in the
program's place (the upper readings), and for a solve that holds k2 at 0
(the reference in float64 from the same start with k2 set to 0 and held
there: a solve that drops a distortion term), at the cell's own size.

    python3 benchmark/tests/readings_bal.py --workload bal_dubrovnik356.global_ba \
        --seeds 1,2,3 [--device cuda] [--control 1] [--k2-held 1] [--requests N]

One JSON line a seed. The program's solve is the timed path's own
(`generators/bal_solves.Requests`, requests 0.. of the seed); the reference,
the control and the k2-held solve start from request 0's start.
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


def readings(workload, seeds, device="cuda", control=True, k2_held=True, requests=1,
             config=None):
    """Yield one dict of readings a seed ("program": request 0's,
    "program_all": every request's, "control", "k2_held")."""
    import numpy as np
    import torch

    from generators.bal_solves import Requests, make_map
    from harness.cell import Cell
    from reference import bal_ba as ref

    cell = Cell(workload)
    config = config or cell.config
    obs, gt, fixed = make_map(config)
    for seed in seeds:
        req = Requests(config, cell.traffic, obs, gt, fixed, device)
        req.solve(seed, -1)  # warm
        _sync(device)
        t0 = time.perf_counter()
        sols = []
        for i in range(requests):
            cams, pts, _ = req.solve(seed, i)
            sols.append((cams.cpu(), pts.cpu(), [x.cpu() for x in req.start(seed, i)]))
        _sync(device)
        row = {"workload": workload, "seed": seed, "device": str(device),
               "program_s": (time.perf_counter() - t0) / requests}
        del req
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        L = len(gt.points)
        args = (obs.cam_idx, obs.pt_idx, obs.uv, np.ones(len(obs.cam_idx)), fixed, L, device)
        p64 = ref.Problem(*args, ref.Arith("float64"), **ref.cost_settings(config))
        row["program_all"] = []
        for k, (c_i, p_i, start_i) in enumerate(sols):
            t0 = time.perf_counter()
            c, X, info = ref.solve(p64, *start_i)
            _sync(device)
            if k == 0:
                row["reference_s"], row["reference"], ref0 = time.perf_counter() - t0, info, (c, X)
            row["program_all"].append(ref.compare(p64, (c, X), c_i, p_i))
        row["program"] = row["program_all"][0]
        start = sols[0][2]
        if k2_held:
            c0 = start[0].clone()
            c0[:, 8] = 0.0
            ch, Xh, info_h = ref.solve(p64, c0, start[1], hold=[8])
            row["k2_held_info"] = info_h
            row["k2_held"] = ref.compare(p64, ref0, ch, Xh)
        if control:
            pc = ref.Problem(*args, ref.Arith("tf32"), **ref.cost_settings(config))
            cc, Xc, info_c = ref.solve(pc, *start)
            row["control_info"] = info_c
            row["control"] = ref.compare(p64, ref0, cc, Xc)
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
    ap.add_argument("--k2-held", type=int, default=1)
    ap.add_argument("--requests", type=int, default=1, help="program solves a seed")
    a = ap.parse_args(argv)
    for row in readings(a.workload, [int(s) for s in a.seeds.split(",")], a.device,
                        bool(a.control), bool(a.k2_held), a.requests):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
