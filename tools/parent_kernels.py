#!/usr/bin/env python3
"""Kernel D (Schur prepare) of a parent commit against the tree's, and kernel
B's bits beside it, on one NVIDIA GPU.

    python3 tools/parent_kernels.py extract --rev REV [--out _chip/parent]
        # in a git checkout: writes the parent's csrc sources of B and D
        # (git show REV:...) into --out
    python3 tools/parent_kernels.py time [--parent _chip/parent] [--pipeline]
        [--launches 60] [--shapes config7 64c 128c ...] [--out FILE]
        # on the card's machine: builds those sources with the package's
        # nvcc flags into <parent>/_build, loads them with ctypes, and times
        # parent and tree in turns

The parent is the commit before kernel D's launch plan: its D takes no plan
(one thread a landmark, red6 zeroed by a memset and summed with float
atomics), and its B has the tree's C interface, so the tree's wrapper
launches it with the parent's library swapped in.

`time` prints the card's name and power limit, then one JSON object per
shape: kernel D's G, zv and vinv6 held bit for bit to the parent's, and red6
to it by the per-block checks (chip_smoke.check_blocks); the tree's D called
twice with the same bits in every output; the parent's D and the tree's in
turns (parent, tree, tree, parent); and kernel B's seed eval bit for bit
against the parent's (B's per-camera group sums moved into a header shared
with D). Each turn is `--launches` calls after a warm-up of about 0.3 s
(clocks up), profiled with torch.profiler (chip_smoke.device_times: each
kernel's min / median / max / mean over its records, and their sums over the
kernels a call launches, the parent's memset of red6 included), and the
CUDA-event ms of each call, min / median / max (for a call shorter than the
host's issue time, the host's). Beside each shape the SM clock, top SM
clock, power draw and temperature before and after, from nvidia-smi.

Shapes: "pipeline" (with --pipeline: the final global BA of the 40-frame
640x480 pipeline that chip_smoke.py runs, every active keyframe and the
landmarks with two or more observations), "64c" (make_synthetic_scene at 64
cameras / 10k landmarks / O = 16), "128c" (100k / O = 8), "600c" (12
cameras x 50 copies, 3k / O = 16), "2100c" (12 x 175) and "config7"
(chip_smoke.track_dense: 71 cameras / 10,842 landmarks / O = 72, n_all 500).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = "bundleadjustment_tpu_torch/csrc"
SOURCES = ("dense_eval.cu", "schur_prepare.cu", "point_prepare.cuh")
P, I32 = ctypes.c_void_p, ctypes.c_int
# the parent's C entry points: B as the tree's, D before its launch plan
PARENT_SIGNATURES = {
    "dense_eval": {"dense_eval_assemble": [P] * 14 + [I32] * 10 + [P] * 8},
    "schur_prepare": {"schur_prepare": [P] * 6 + [I32] * 3 + [P] * 5},
}
DENSE_SHAPES = {  # tag: (cameras, landmarks, obs per landmark, O, copies)
    "64c": (64, 10_000, 8, 16, 1), "128c": (128, 100_000, 6, 8, 1),
    "600c": (12, 3_000, None, 16, 50), "2100c": (12, 3_000, None, 16, 175)}
SHAPES = (*DENSE_SHAPES, "config7")


def extract(rev, out):
    os.makedirs(out, exist_ok=True)
    for name in SOURCES:
        src = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], cwd=ROOT,
                             capture_output=True, text=True, check=True).stdout
        with open(os.path.join(out, name), "w") as f:
            f.write(src)
    print(json.dumps({"rev": rev, "out": out, "sources": list(SOURCES)}))


def build_parent(parent):
    """The parent's B and D built into <parent>/_build; {name: CDLL}."""
    from concurrent.futures import ThreadPoolExecutor

    from bundleadjustment_tpu_torch import kernels

    out_dir = os.path.join(parent, "_build")
    os.makedirs(out_dir, exist_ok=True)

    def one(name):
        so = os.path.join(out_dir, f"lib{name}_parent.so")
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", parent, "-o", so,
                        os.path.join(parent, f"{name}.cu")], check=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in PARENT_SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        return lib

    with ThreadPoolExecutor(len(PARENT_SIGNATURES)) as pool:
        futs = {n: pool.submit(one, n) for n in PARENT_SIGNATURES}
        return {n: f.result() for n, f in futs.items()}


def parent_prepare(lib, args):
    """The parent's wrapper of kernel D: one call, which zeroes red6 with a
    memset and then launches the kernel."""
    import torch

    from bundleadjustment_tpu_torch import kernels

    lam, Vu, g_p, pt_valid, W18, cam_t, K = args
    O, L = cam_t.shape
    dev, f32 = cam_t.device, torch.float32
    G = torch.empty((18, O, L), dtype=f32, device=dev)
    zv = torch.empty((3, L), dtype=f32, device=dev)
    vinv6 = torch.empty((6, L), dtype=f32, device=dev)
    red6 = torch.empty((6, K), dtype=f32, device=dev)
    code = lib.schur_prepare(lam.data_ptr(), Vu.data_ptr(), g_p.data_ptr(),
                             pt_valid.data_ptr(), W18.data_ptr(), cam_t.data_ptr(),
                             O, L, K, G.data_ptr(), zv.data_ptr(), vinv6.data_ptr(),
                             red6.data_ptr(), kernels.stream_of(cam_t))
    kernels.check(code, "parent schur_prepare")
    return G, zv, vinv6, red6


def parent_eval(lib, seed):
    """Kernel B's seed eval through the tree's wrapper, with the parent's
    library in place of the tree's."""
    from bundleadjustment_tpu_torch import kernels
    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk

    tree = kernels.lib("dense_eval")
    kernels._libs["dense_eval"] = lib
    try:
        return dk.eval_assemble(*seed)
    finally:
        kernels._libs["dense_eval"] = tree


def smi():
    q = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return dict(zip(q.split(","), (x.strip() for x in out.splitlines()[0].split(","))))


def spread(xs):
    return {"min": min(xs), "median": statistics.median(xs), "max": max(xs),
            "n": len(xs)} if xs else None


def per_launch(fn, n, warm_s=0.3):
    """chip_smoke.device_times over n calls of fn (device ms per call and per
    kernel, min / median / max over each kernel's records) and the CUDA-event
    ms of each of n calls, after warm_s seconds of calls."""
    import torch

    import chip_smoke as cs

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        fn()
    torch.cuda.synchronize()
    out = cs.device_times(fn, reps=n)
    ends = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(n)]
    for a, b in ends:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    out["event_ms"] = spread([a.elapsed_time(b) for a, b in ends])
    return out


def turns(label, shape, fns, n, emit):
    """fns: [(who, fn)] timed in that order; one JSON object."""
    row = {"shape": shape, "kernel": label, "smi_before": smi(), "turns": []}
    for who, fn in fns:
        row["turns"].append({"who": who, **per_launch(fn, n)})
    row["smi_after"] = smi()
    emit(row)


def problem(tag, device):
    import chip_smoke as cs

    if tag == "config7":
        return cs.track_dense(device)
    nc, npt, opp, mo, copies = DENSE_SHAPES[tag]
    return cs.synthetic_dense(nc, npt, opp, mo, device, copies)


def pipeline_problem(device):
    import chip_smoke as cs
    from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem_auto

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "seq")
        cs.write_sequence(data, 40)
        pipe, _, _ = cs.phase_pipeline(device, data, 40)
    m = pipe.map
    snap = m.snapshot_problem(m.active_keyframes().tolist(), min_obs=2)
    prob, _, _ = densify_problem_auto(
        snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2, snap.valid,
        snap.cam_fixed, snap.points.shape[0], device=pipe.device)
    return prob, pipe._t(snap.extr), pipe._t(snap.points)


def time_shape(libs, tag, prob, cams, pts, n, emit):
    import torch

    import chip_smoke as cs
    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk

    x = cs.dense_inputs(prob, cams, pts, bs=False)
    p, lib = x["p"], libs["schur_prepare"]
    shape = {"tag": tag, "K": x["K"], "L": x["L"], "O": x["O"], "n_obs": x["n_valid"]}
    old, new = parent_prepare(lib, p), dk.schur_prepare(*p)
    torch.cuda.synchronize()
    O, L = x["O"], x["L"]
    cs.check_twice(tag, "D", lambda: dk.schur_prepare(*p), new, n=4)
    for g, r, name in zip(new[:3], old[:3], ("G", "zv", "vinv6")):
        if not torch.equal(g, r):
            raise AssertionError(f"{tag} D: {name} differs from the parent's")
    red6_err = cs.check_blocks(f"{tag} D vs parent", "red6", new[3], old[3])
    b_new, b_old = dk.eval_assemble(*x["seed"]), parent_eval(libs["dense_eval"], x["seed"])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(b_new, b_old)):
        raise AssertionError(f"{tag} B: the seed eval differs from the parent's")
    emit({"shape": shape, "D_G_zv_vinv6_bit_identical_to_parent": True,
          "D_red6_max_abs_diff_to_parent": red6_err, "D_bit_identical_twice": True,
          "B_seed_bit_identical_to_parent": True,
          "plan": cs.prepare_plan_fields(tag, x["K"], L, O)["plan"]})
    turns("D", shape, [("parent", lambda: parent_prepare(lib, p)),
                       ("tree", lambda: dk.schur_prepare(*p)),
                       ("tree", lambda: dk.schur_prepare(*p)),
                       ("parent", lambda: parent_prepare(lib, p))], n, emit)


def time_all(args):
    import torch

    from bundleadjustment_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("parent_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    t0 = time.perf_counter()
    libs = build_parent(args.parent)
    kernels.build_all()
    emit({"built_s": time.perf_counter() - t0})
    if args.pipeline:
        time_shape(libs, "pipeline", *pipeline_problem(torch.device("cuda")),
                   args.launches, emit)
    for tag in SHAPES:
        if tag in args.shapes:
            time_shape(libs, tag, *problem(tag, torch.device("cuda")),
                       args.launches, emit)
    emit({"total_s": time.perf_counter() - t0})
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("extract")
    ex.add_argument("--rev", required=True)
    ex.add_argument("--out", default=os.path.join(ROOT, "_chip", "parent"))
    tm = sub.add_parser("time")
    tm.add_argument("--parent", default=os.path.join(ROOT, "_chip", "parent"))
    tm.add_argument("--pipeline", action="store_true")
    tm.add_argument("--launches", type=int, default=60)
    tm.add_argument("--shapes", nargs="*", default=list(SHAPES))
    tm.add_argument("--out")
    args = ap.parse_args()
    if args.cmd == "extract":
        extract(args.rev, args.out)
        return 0
    return time_all(args)


if __name__ == "__main__":
    sys.exit(main())
