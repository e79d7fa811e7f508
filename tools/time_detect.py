#!/usr/bin/env python3
"""Per-frame feature detection (`ops/features.py:detect_and_describe`) of a
parent commit against the tree's, on one NVIDIA GPU.

    python3 tools/time_detect.py extract --rev REV [--out _chip/parent_detect]
        # in a git checkout: writes the parent's ops/features.py into --out
    python3 tools/time_detect.py time [--parent _chip/parent_detect]
        [--other NAME=PATH ...] [--calls 40] [--out FILE]
        # on the card's machine: times the parent's, the tree's and each
        # other features.py's detect_and_describe in turns

The frames are 8 frames of the 640x480 forward sequence that chip_smoke.py
tracks (render_layered_scene, fx 525, motion_step 0.03, seed 11), detected
with the default FeatureConfig (1,000 features, 8 levels). The variants are
"parent" (the parent's module, loaded from its file), each `--other` module
and "tree" (the tree's). They run in turns, forward then backward (parent,
others, tree, tree, others reversed, parent); each turn is `--calls` calls,
one frame each, after 3 warm-up calls, timed with CUDA events around the
back-to-back calls: per-frame detection is host-bound, so this is the
host's per-call cost. Then each variant's kernel launches a call
(torch.profiler, one session of 3 calls), and how many keypoints of the 8
frames differ from the parent's in `valid`, in `desc` (where both are
valid) and the largest |xy| difference.

Prints the card's name and power limit, then one JSON object: "turns" (each
turn's ms a call), "ms" (each variant's median over its turns), "launches"
and "vs_parent".
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = "bundleadjustment_tpu_torch/ops/features.py"


def extract(rev, out):
    os.makedirs(out, exist_ok=True)
    src = subprocess.run(["git", "show", f"{rev}:{SOURCE}"], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    with open(os.path.join(out, "features.py"), "w") as f:
        f.write(src)
    print(json.dumps({"rev": rev, "out": out, "source": SOURCE}))


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def frames(n=8):
    import numpy as np

    from bundleadjustment_tpu_torch.data.synthetic import render_layered_scene

    fr, _ = render_layered_scene(n_frames=n, width=640, height=480, fx=525.0,
                                 fy=525.0, trajectory="forward",
                                 motion_step=0.03, seed=11)
    return np.stack([f["gray"] for f in fr]).astype(np.float32)


def per_call_ms(fn, calls, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def launches(fn, reps=3):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA"))
    return n / reps


def time_all(args):
    import torch

    from bundleadjustment_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    mods = {"parent": load(os.path.join(args.parent, "features.py"), "features_parent")}
    for spec in args.other:
        name, path = spec.split("=", 1)
        mods[name] = load(path, f"features_{name}")
    mods["tree"] = load(os.path.join(ROOT, SOURCE), "features_tree")
    imgs = torch.from_numpy(frames()).to(dev)
    cfgs = {k: m.FeatureConfig() for k, m in mods.items()}
    call = {k: (lambda k=k: mods[k].detect_and_describe(imgs[0], cfgs[k]))
            for k in mods}
    order = (*mods, *reversed(mods))
    turns = [(k, per_call_ms(call[k], args.calls)) for k in order]
    ms = {k: statistics.median(t for kk, t in turns if kk == k) for k in mods}
    out = {"shape": [640, 480], "n_features": cfgs["tree"].n_features,
           "n_levels": cfgs["tree"].n_levels, "calls_per_turn": args.calls,
           "turns": [{"variant": k, "ms": t} for k, t in turns], "ms": ms,
           "launches": {k: launches(call[k]) for k in mods}}
    vs = {}
    for k in list(mods)[1:]:
        valid = desc = 0
        xy = 0.0
        for i in range(imgs.shape[0]):
            a = mods["parent"].detect_and_describe(imgs[i], cfgs["parent"])
            b = mods[k].detect_and_describe(imgs[i], cfgs[k])
            both = a.valid & b.valid
            valid += int((a.valid != b.valid).sum())
            desc += int((a.desc != b.desc).any(1)[both].sum())
            if bool(both.any()):
                xy = max(xy, float((a.xy - b.xy).abs()[both].max()))
        vs[k] = {"valid_differ": valid, "desc_differ": desc, "max_abs_xy_diff_px": xy}
    out["vs_parent"] = vs
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("extract")
    ex.add_argument("--rev", required=True)
    ex.add_argument("--out", default=os.path.join(ROOT, "_chip", "parent_detect"))
    tm = sub.add_parser("time")
    tm.add_argument("--parent", default=os.path.join(ROOT, "_chip", "parent_detect"))
    tm.add_argument("--other", action="append", default=[])
    tm.add_argument("--calls", type=int, default=40)
    tm.add_argument("--out")
    args = ap.parse_args()
    if args.cmd == "extract":
        extract(args.rev, args.out)
    else:
        time_all(args)


if __name__ == "__main__":
    main()
