#!/usr/bin/env python3
"""Kernels A (Hamming top-2) and B (dense eval + assembly) of a parent
commit against the tree's, and kernel C beside them, on one NVIDIA GPU.

    python3 tools/parent_kernels.py extract --rev REV [--out _chip/parent]
        # in a git checkout: writes the parent's csrc sources of A, B and C
        # (git show REV:...) into --out
    python3 tools/parent_kernels.py time [--parent _chip/parent] [--pipeline]
        [--launches 60] [--shapes 64c 128c ...] [--out FILE]
        # on the card's machine: builds those sources with the package's
        # nvcc flags into <parent>/_build, loads them with ctypes, and times
        # parent and tree in turns

`time` prints the card's name and power limit, then one JSON object per
shape and kernel: for B (seed eval, and with back-substitution) and A the
parent's kernel and the tree's in turns (parent, tree, tree, parent); for C
(not changed) the tree's twice. Each turn is `--launches` calls after a
warm-up of about 0.3 s (clocks up), profiled with torch.profiler
(chip_smoke.device_times: each kernel's min / median / max / mean over its
records, and their sums over the kernels a call launches, the parent's two
zero fills of red and cost included), and the CUDA-event ms of each call,
min / median / max (for a call shorter than the host's issue time, the
host's).
Beside each shape the SM clock, top SM clock, power draw and temperature
before and after, from nvidia-smi.

Shapes: "pipeline" (with --pipeline: the final global BA of the 40-frame
640x480 pipeline that chip_smoke.py runs, every active keyframe and the
landmarks with two or more observations), "8c" (make_synthetic_scene at 8
cameras / 1,024 landmarks / O = 8), "64c" (10k / O = 16), "128c" (100k /
O = 8), "600c" (12 cameras x 50 copies, 3k / O = 16), "2100c" (12 x 175),
and "hamming" (1000 x 1000 at B = 1 and 25, chip_smoke's inputs).
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
SOURCES = ("hamming.cu", "dense_eval.cu", "schur_s.cu", "point_prepare.cuh")
P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the parent's C entry points: kernels A and B before their launch plans
PARENT_SIGNATURES = {
    "hamming": {"hamming_top2": [P, I64, P, P, I32, I32, I32, P, P, P, P]},
    "dense_eval": {"dense_eval_assemble": [P] * 14 + [I32] * 5 + [P] * 7},
}
DENSE_SHAPES = {  # tag: (cameras, landmarks, obs per landmark, O, copies)
    "8c": (8, 1_024, 8, 8, 1), "64c": (64, 10_000, 8, 16, 1),
    "128c": (128, 100_000, 6, 8, 1), "600c": (12, 3_000, None, 16, 50),
    "2100c": (12, 3_000, None, 16, 175)}


def extract(rev, out):
    os.makedirs(out, exist_ok=True)
    for name in SOURCES:
        src = subprocess.run(["git", "show", f"{rev}:{CSRC}/{name}"], cwd=ROOT,
                             capture_output=True, text=True, check=True).stdout
        with open(os.path.join(out, name), "w") as f:
            f.write(src)
    print(json.dumps({"rev": rev, "out": out, "sources": list(SOURCES)}))


def build_parent(parent):
    """The parent's A and B built into <parent>/_build; {name: CDLL}."""
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


def parent_eval(lib, seed, bs=None, robust=True):
    """The parent's wrapper of kernel B: red and cost zeroed by two fills,
    then one launch."""
    import torch

    from bundleadjustment_tpu_torch import kernels

    K4, cam_t, uv_t, isig, valid_t, fixed_t, R, t, Xt = seed
    O, L = cam_t.shape
    K = R.shape[0]
    dev, f32 = cam_t.device, torch.float32
    red = torch.zeros((K, 27), dtype=f32, device=dev)
    cost = torch.zeros((), dtype=f32, device=dev)
    Vu = torch.empty((6, L), dtype=f32, device=dev)
    g_p = torch.empty((3, L), dtype=f32, device=dev)
    W = torch.empty((18, O, L), dtype=f32, device=dev)
    Xt_new = torch.empty((3, L), dtype=f32, device=dev) if bs is not None else None
    ptrs = [x.data_ptr() for x in bs] if bs is not None else [None] * 5
    code = lib.dense_eval_assemble(
        K4.data_ptr(), R.data_ptr(), t.data_ptr(), ptrs[0], cam_t.data_ptr(),
        uv_t.data_ptr(), isig.data_ptr(), valid_t.data_ptr(), fixed_t.data_ptr(),
        Xt.data_ptr(), *ptrs[1:], O, L, K, int(robust), int(bs is not None),
        red.data_ptr(), cost.data_ptr(), Vu.data_ptr(), g_p.data_ptr(), W.data_ptr(),
        None if Xt_new is None else Xt_new.data_ptr(), kernels.stream_of(cam_t))
    kernels.check(code, "parent dense_eval_assemble")
    return cost, red, Vu, g_p, W.reshape(6, 3, O, L), Xt_new


def parent_hamming(lib, q, t, v):
    import torch

    from bundleadjustment_tpu_torch import kernels

    B, M1, M2 = t.shape[0], q.shape[1], t.shape[1]
    best = torch.empty((B, M1), dtype=torch.float32, device=q.device)
    second = torch.empty_like(best)
    idx = torch.empty((B, M1), dtype=torch.int32, device=q.device)
    code = lib.hamming_top2(q.data_ptr(), 0 if q.shape[0] == 1 else M1 * 8,
                            t.data_ptr(), v.data_ptr(), B, M1, M2, best.data_ptr(),
                            second.data_ptr(), idx.data_ptr(), kernels.stream_of(q))
    kernels.check(code, "parent hamming_top2")
    return best, second, idx


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


def dense_problem(tag, device):
    import chip_smoke as cs

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


def time_dense(libs, tag, prob, cams, pts, n, emit):
    import torch

    import chip_smoke as cs
    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk

    x = cs.dense_inputs(prob, cams, pts)
    lib = libs["dense_eval"]
    seed, bs = x["seed"], x["bs"]
    # the parent against the tree once, to the smoke's checks
    for who, got in (("parent", parent_eval(lib, seed)), ("tree", dk.eval_assemble(*seed))):
        torch.cuda.synchronize()
        for g, r, name in zip(got[1:5], x["seed_p"][1:5], ("red", "Vu", "g_p", "W")):
            cs.check_blocks(f"{tag} {who}", name, g, r)
    shape = {"tag": tag, "K": x["K"], "L": x["L"], "O": x["O"], "n_obs": x["n_valid"]}
    turns("B seed", shape, [("parent", lambda: parent_eval(lib, seed)),
                            ("tree", lambda: dk.eval_assemble(*seed)),
                            ("tree", lambda: dk.eval_assemble(*seed)),
                            ("parent", lambda: parent_eval(lib, seed))], n, emit)
    # eval_assemble_bs's arguments as the parent's launch takes them: the
    # eval's (at R_new, t_new, Xt) and the back-substitution's
    bs_seed = (*bs[:8], bs[9])
    bs_extra = (bs[8], *bs[10:])  # dc, W18_prev, vinv6, gp_prev, pt_valid
    turns("B bs", shape,
          [("parent", lambda: parent_eval(lib, bs_seed, bs_extra)),
           ("tree", lambda: dk.eval_assemble_bs(*bs)),
           ("tree", lambda: dk.eval_assemble_bs(*bs)),
           ("parent", lambda: parent_eval(lib, bs_seed, bs_extra))], n, emit)
    if x["K"] <= 600:
        c = x["c"]
        turns("C", shape, [("tree", lambda: dk.schur_prepare_s(*c)),
                           ("tree", lambda: dk.schur_prepare_s(*c))], n, emit)


def time_hamming(libs, n, emit):
    import numpy as np
    import torch

    import chip_smoke as cs
    from bundleadjustment_tpu_torch.ops.hamming import hamming_top2

    rng = np.random.default_rng(0)
    lib = libs["hamming"]
    for B in (1, 25):
        q, t, v = cs._hamming_inputs(rng, B, 1000, "cuda")
        for g, r in zip(parent_hamming(lib, q, t, v), hamming_top2(q, t, v)):
            if not torch.equal(g, r):
                raise AssertionError(f"hamming B={B}: parent and tree differ")
        turns("A", {"tag": f"1000x1000_B{B}", "B": B},
              [("parent", lambda: parent_hamming(lib, q, t, v)),
               ("tree", lambda: hamming_top2(q, t, v)),
               ("tree", lambda: hamming_top2(q, t, v)),
               ("parent", lambda: parent_hamming(lib, q, t, v))], n, emit)


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
    if "hamming" in args.shapes:
        time_hamming(libs, args.launches, emit)
    if args.pipeline:
        time_dense(libs, "pipeline", *pipeline_problem(torch.device("cuda")),
                   args.launches, emit)
    for tag in DENSE_SHAPES:
        if tag in args.shapes:
            time_dense(libs, tag, *dense_problem(tag, torch.device("cuda")),
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
    tm.add_argument("--shapes", nargs="*", default=["hamming", *DENSE_SHAPES])
    tm.add_argument("--out")
    args = ap.parse_args()
    if args.cmd == "extract":
        extract(args.rev, args.out)
        return 0
    return time_all(args)


if __name__ == "__main__":
    sys.exit(main())
