#!/usr/bin/env python3
"""Trace `--estimation essential_or_homography` on the card against the CPU.

    python3 tools/trace_two_view.py [--out trace.json]
                                         # from the repository root, on a
                                         # machine with an NVIDIA GPU

Renders the 20-frame 640x480 sequence of `chip_smoke.py` (`write_sequence`)
and runs the port's CLI on it twice, `--device cuda` then `--device cpu`,
with `--local-ba`. Every two-view estimate of the card run is also made on
the CPU from the same pixel pairs and the same RANSAC samples. Per estimate
it logs the chosen model (H or E), the score ratio, the E and H scores and
inlier counts, the cheirality counts and poses of both decompositions, and
the chosen pose; per run the ATE and the camera centres. Prints, per
estimate, what differs between card and CPU on the same inputs, and between
the two runs; `--out` also writes the whole log as JSON.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from bundleadjustment_tpu_torch import cli  # noqa: E402
from bundleadjustment_tpu_torch.geometry import epipolar as ep  # noqa: E402
from bundleadjustment_tpu_torch.pipeline import driver as D  # noqa: E402

LOG = []
RUN = {}


def record(dev, uv1, uv2, ie, ih, K4):
    """recover_pose_two_view on `dev`, logging what its four stages return."""
    d = {}
    o = (ep.estimate_essential, ep.estimate_homography, ep.decompose_essential,
         ep.decompose_homography)

    def we(*a, **k):
        r = o[0](*a, **k)
        d["score_e"], d["inl_e"] = float(r[1]), int(r[2].sum())
        return r

    def wh(*a, **k):
        r = o[1](*a, **k)
        d["score_h"], d["inl_h"] = float(r[1]), int(r[2].sum())
        return r

    def wde(*a, **k):
        r = o[2](*a, **k)
        d["rt_e"], d["n_e"] = r[0].cpu().tolist(), int(r[1])
        return r

    def wdh(*a, **k):
        r = o[3](*a, **k)
        d["rt_h"], d["n_h"] = r[0].cpu().tolist(), int(r[1])
        return r

    (ep.estimate_essential, ep.estimate_homography, ep.decompose_essential,
     ep.decompose_homography) = we, wh, wde, wdh
    try:
        r = ep.recover_pose_two_view(
            None, uv1.to(dev), uv2.to(dev),
            torch.ones(len(uv1), dtype=torch.bool, device=dev), K4.to(dev),
            idx_e=ie.to(dev), idx_h=ih.to(dev))
    finally:
        (ep.estimate_essential, ep.estimate_homography, ep.decompose_essential,
         ep.decompose_homography) = o
    d.update(H=bool(r.used_homography), ratio=float(r.score_ratio),
             n=int(r.n_inliers), ok=bool(r.ok), rt=r.rt6.cpu().tolist())
    return d, r


def two_view(self, uv1, uv2, n_hyp=256):
    """The pipeline's `_two_view`, logged, with the CPU twin on the card."""
    ie, ih = self._two_view_samples(len(uv1), n_hyp)
    u1 = torch.from_numpy(np.asarray(uv1, np.float32))
    u2 = torch.from_numpy(np.asarray(uv2, np.float32))
    K4 = self.K4_dev.float().cpu()
    ent = {"run": RUN["name"],
           "call": sum(1 for e in LOG if e["run"] == RUN["name"]),
           "frame": len(self.trajectory), "n": len(uv1),
           "uv_sum": float(u1.double().sum() + u2.double().sum())}
    ent["dev"], r = record(self.device, u1, u2, ie, ih, K4)
    if self.device.type == "cuda":
        ent["cpu_same_inputs"], _ = record(torch.device("cpu"), u1, u2, ie, ih, K4)
    LOG.append(ent)
    return type(r)(**{k: v.cpu().numpy() for k, v in vars(r).items()})


def diff(a, b):
    """The logged fields in which two estimates differ."""
    return ([k for k in ("H", "n", "ok", "inl_e", "inl_h", "n_e", "n_h") if a.get(k) != b.get(k)]
            + [k for k in ("rt", "rt_e", "rt_h")
               if np.max(np.abs(np.subtract(a[k], b[k]))) > 1e-4]
            + [k for k in ("score_e", "score_h")
               if abs(a[k] - b[k]) > 1e-3 * max(1.0, abs(b[k]))])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the whole log here as JSON")
    args = parser.parse_args()
    D.BundleAdjustmentPipeline._two_view = two_view
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "seq")
        cs.write_sequence(data, 20)
        for dev in ("cuda", "cpu"):
            RUN["name"] = dev
            pipe, res = cli.run_cli([
                "--dataset-name", "synthetic", "--dataset-path", data,
                "--output-path", os.path.join(tmp, "o" + dev), "--frames", "20",
                "--local-ba", "--trajectory", "--device", dev,
                "--estimation", "essential_or_homography"])
            _, m = pipe.trajectory_cam_to_world()
            out[dev] = {"ate": res["ate_rmse"], "poses": np.asarray(m)[:, :3, 3].tolist()}
            print(dev, "ATE", res["ate_rmse"], flush=True)
    out["calls"] = LOG
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    cu = [e for e in LOG if e["run"] == "cuda"]
    cp = [e for e in LOG if e["run"] == "cpu"]
    for e in cu:
        a, b = e["dev"], e["cpu_same_inputs"]
        print("same-inputs call", e["call"], "frame", e["frame"], "n", e["n"],
              *[f"{k} {a[k]} {b[k]}" for k in ("H", "inl_e", "inl_h", "n_e", "n_h")],
              "diff", diff(a, b))
    for a, b in zip(cu, cp):
        print("runs call", a["call"], "frame", a["frame"], b["frame"], "n", a["n"], b["n"],
              "uv_sum", a["uv_sum"], b["uv_sum"], "H", a["dev"]["H"], b["dev"]["H"],
              "inl", a["dev"]["n"], b["dev"]["n"], "diff", diff(a["dev"], b["dev"]))
    P, Q = np.asarray(out["cuda"]["poses"]), np.asarray(out["cpu"]["poses"])
    print("pose diff per frame", np.round(np.linalg.norm(P - Q, axis=1), 5).tolist())


if __name__ == "__main__":
    main()
