#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON object per line, in order; any failure raises and the
script exits non-zero without printing the final line:

1. environment: torch / CUDA versions and `nvidia-smi` name + power limit
   (also printed raw on a line of its own);
2. build: compiles the kernels in bundleadjustment_tpu_torch/csrc/ with nvcc
   for sm_90a, one nvcc process per source, all started together, and
   prints the build seconds;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main paths give it (kernel A bit-identical,
   also at the tracking microbatch's pairwise shape, 8 query sets of 1,000
   descriptors against 8 train sets;
   B, C, K5 and D to the stated tolerances; E, the blocked Cholesky solve,
   on the S and b that the Schur step produces at each shape, against its
   plain version with the kernel's panels and with the reference's, and
   float64 numpy, beside the library call `cholesky_ex` + `cholesky_solve`,
   with its panel, grid and grid barriers), each timed as device time per
   call ("ms", torch.profiler kernel durations, or CUDA events where the
   profiler delivers no kernel records: "ms_source" says which; for A, B,
   C and D over 50 calls, with "ms_min", "ms_median", "ms_max" and each
   kernel's figures in "per_kernel"; B, D and A also give their launch
   plan, B two calls with the same bits in red and cost, D in every output,
   and D its device ms before its plan ("old_ms", a fixed figure)) and as
   CUDA-event time per back-to-back call ("call_ms", which includes the
   host's per-call cost), beside its bound ("bound_ms": the larger of the
   bytes it must move over 3.35 TB/s and its operations over 67 TFLOP/s,
   counted from this run's inputs; for A also its popcounts at 16 a clock
   an SM, "bound_of" naming the largest). At the config-7 shape (71 cameras,
   10,842 landmarks, 156,774 observations, O = 72) it also times the two
   Schur-step routes on the same inputs: kernel C alone, and kernel D + Pf
   (index_add_) + Q Q^T (matmul), each part alone too. The records give
   only those counts and the longest track (71 observations); how many
   landmarks every camera sees (n_all) and the law of the other track
   lengths are assumptions, so the routes are timed at n_all = 1, 50 and
   500, and at n_all = 500 with every track cut to O = 16 and 32 (the
   evidence for the O gate of route (s)); kernel C and K5 lines also give
   their launch plan (tile, tiles, chunks, blocks, scratch_mb) and their
   device ms before the tiled design ("old_ms", a fixed figure);
4. dense solve: 128 cams / 100k landmarks (the two best-observed cameras
   fixed, so the solution has no free gauge), 10 LM iterations through the
   kernels and through the plain versions; costs and cameras must agree and
   the cost must decrease;
5. large-O solve: the config-7-shaped problem through `dense_ba_solve`
   (O = 72: route (c), kernel D + Pf + Q Q^T), 10 LM iterations, kernels
   against plain versions with the criteria of phase 4;
6. Cholesky-solve path: the 64 cams / 10k landmarks / O = 16 problem, 10 LM
   iterations with the camera system solved by kernel E (KERNEL_OPS_CHOL)
   against the plain versions (PLAIN_OPS_CHOL) with the criteria of phase
   4, and against the same solve through the library call (KERNEL_OPS);
   milliseconds per LM iteration of the E and of the library variant, each
   with the roofline fields of `utils/flops.solve_roofline` (the port's
   own bound and the share of it reached, which must not exceed 1, beside
   the JAX package's FLOP model);
7. two-view estimators: the batched SVDs of `geometry/epipolar.py` (256
   8-point and 4-point systems, the [C, N, 4, 4] triangulations of 4 and 8
   candidate motions) and one whole `recover_pose_two_view`, timed on the
   card and on the CPU at 800 pairs, and the two held against each other;
8. pipeline: writes a TUM-format rendered sequence (640x480, the first 40
   frames of a 48-frame render, the other 8 kept for the microbatch step) and
   runs the port's CLI on it with default flags (gtdepth, ba, local BA,
   3x100 final BA, 1000 features, 8 levels, tracking in microbatches of 8);
   checks ATE and the output files; then times the kernels at the
   pipeline's own final-BA shape (after phase 21). Then the same run with
   `--track-batch 1` (one frame at a time): ATE < 0.05 m, the batched
   run's within 0.01 m of it, both frames/s; then "track_batch_step": one
   microbatch of the sequence's next 8 frames on the default run's map
   through `track_batch_step`, under `torch.cuda.set_sync_debug_mode(
   "error")` (no host sync between upload and fetch), kernel A launched
   1 + 8 times, its outputs bit-identical to the same step with kernel A's
   plain version, with its ms a batch and a frame and a profiled step's
   device ms, kernel launches and busy share;
9. sharded pipeline: the same sequence through the CLI with `--global-ba
   sharded`, inside an NCCL process group of world size 1 (file rendezvous
   in the temporary directory); ATE < 0.05 m and within 0.001 m of phase 6,
   and the solve's all-reduces and point gather ran as NCCL collectives;
10. monocular pipelines through the CLI at the same width: `--estimation
   pnp` and `--estimation essential_or_homography` on 20 frames of that
   sequence, and `--init-type standard` (two-view E/H bootstrap, no depth)
   on a 20-frame sequence rendered with a baseline that initialises; the
   standard run once as a user would start it (the BA engine follows the
   observation count and is reported) and once with `--ba-layout
   dense_landmark`, so that kernels B and C solve a monocular map;
11. dense PCG solve (after phase 6): the phase-4 problem with
   `LMConfig(solver="pcg", pcg_iters=60)`, kernels against plain versions
   (cameras within 5e-3, the JAX package's PCG bound), B launched at least
   once an LM iteration and C, K5, D, E and B with back-substitution never;
   ms per LM iteration of PCG and of the exact solve, in turns, with their
   roofline fields (as phase 6), and one PCG iteration's device time by kernel (one
   profiler session);
12. flat sharded PCG (`parallel/sharded_ba.py`) at 64c/10k in an NCCL
   group of one against the single-device flat PCG solve on the card:
   cost0, cameras within 5e-3, and the all-reduces and their bytes equal
   to the count the algorithm implies (1 + 10 x (4 + 60)); then
   `measure_scaling` at world size 1;
13. the 40-frame sequence through the CLI with `--ba-solver pcg` and with
   `--global-ba windowed` (ATE < 0.05 m each; the window counts printed);
14. the config-7 protocol's depth-seeded run (protocols.py:500-530, 100
   frames 640x480 sweep, 2,500 features, `depth_landmarks`, no guided
   local-map tracking): ATE < 0.05 m; the map finalize solved (keyframes,
   landmarks, observations, longest track O, its Schur route) beside the
   JAX package's TPU record's counts, the launches of A, B, C and D, the
   seconds spent seeding, and kernel C against route (c) on its final
   system; then config 7's measurement on that map: the marginal ms of a
   dense LM iteration (`bench/protocols.ba_marginal`), its stderr and its
   roofline fields (the share of the port's bound in (0, 1]);
15. predetect pipeline: the 40-frame sequence through the CLI with
   `--predetect` (detection of 32 frames a pass, then matching and
   estimation a frame): ATE < 0.05 m, frames/s beside phase 8's; then
   detection ms a frame batched (B = 32) against per-frame
   `detect_and_describe` (CUDA events), the batched figure's
   `utils/flops.frontend_fields`, and over the 40 frames how many
   keypoints differ between batched and per-frame detection on the card
   (validity, descriptor, largest |xy| difference);
16. output pipeline: the same sequence through the CLI with
   `--reconstruction-error GT --faces-type poisson --display-pointcloud`,
   the ground-truth cloud being the port's `backproject_depth` of every 4th
   rendered frame at stride 2 in world coordinates: reconstruction error <
   0.05, the three comparison PLYs, `<prefix>_cloud.ply` and
   `map_final.ply` written, Poisson faces in the mesh;
17. checkpoint / resume: the default configuration on that sequence for
   20 frames, `save_checkpoint`, `load_checkpoint` onto the card, the other
   20 frames and `finalize`: every frame tracked, ATE < 0.05 m and within
   max(0.6 ATE, 0.01 m) of phase 8's; then a depth-seeded run (the
   config-7 settings, 6 frames) keeps its pending seeds across a
   save / load;
18. outputs at scale: `icp_align` of a 10k-point map onto a 100k-point
   cloud (30 iterations) and `poisson_reconstruct` of 100k back-projected
   points at grid 96 and 128: ms (host clock around synchronised calls),
   peak `torch.cuda.max_memory_allocated`, the least time of their
   nearest-neighbour search (a fused distance-argmin: the larger of the
   points' bytes over 3.35 TB/s and 9 operations a pair over 67 TFLOP/s)
   and, beside it, one write of their materialised distance blocks over
   3.35 TB/s;
19. protocol runner: `bench/protocols.config1` at full size (50 frames
   640x480, 1000 features, 8 levels, `track_batch=8`) on the card, its JSON
   line, ATE < 0.05 m;
20. fresh-process resume: the smoke's 40-frame sequence cut at frame 20 by
   a checkpoint, resumed by the protocol runner's `--resume-worker` in a
   child process on the card against the uninterrupted run here: |ATE
   difference| <= max(0.6 ATE, 0.01 m), every frame tracked, no jax module
   in the child;
21. per-path launch check: every kernel was launched by the run of the path
   that carries it (A, B, B with back-substitution and C: phase 8; K5:
   phase 9, whose local BAs also launch B and C; D: phase 5; E: phase 6, at
   least 10 times; A in every monocular run, B and C in the dense standard
   run; B in the dense PCG solve; A and B in the PCG pipeline and the
   depth-seeded run; A in the windowed run; A, B and C in the predetect and
   output runs; A, B and C in the config-1 protocol run, in the resume
   phase's run here and in the `--track-batch 1` run; A in the microbatch
   step). Each count is reset just before that run and read just after it;
22. frontend stages: `bench/frontend.py` (the root-level
   `profile_frontend.py`'s counterpart) at 640x480, 1,000 features, 8
   levels, 12 frames: detection's ms a frame sustained and with a
   synchronize a call, then its eight stages, each with its kernel ms and
   launches a call (one "frontend_stages" line a measurement); then each
   stage on the card against the CPU on one frame, with the tolerances of
   tests/test_torch_frontend_stages.py ("frontend_stages_card_vs_cpu").
   It launches no hand-written kernel (detection has none) and runs after
   phase 20; phase 21's check comes last.

Then a `{"kernels": [...]}` line and, last, `{"ok": true, "device": ...}`.
Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

from bundleadjustment_tpu_torch.utils.timing import (
    cuda_time,
    device_events,
    device_times,
    kernel_name,
)


# kernel name -> (route, source, TPU kernel it replaces, the run that must
# launch it)
KERNELS = {
    "hamming_top2": ("cuda", "bundleadjustment_tpu_torch/csrc/hamming.cu",
                     "bundleadjustment_tpu/ops/pallas_matching.py:125",
                     "pipeline"),
    "dense_eval_assemble": (
        "cuda", "bundleadjustment_tpu_torch/csrc/dense_eval.cu",
        "bundleadjustment_tpu/solvers/pallas_dense_eval.py:255", "pipeline"),
    "dense_eval_assemble_bs": (
        "cuda", "bundleadjustment_tpu_torch/csrc/dense_eval.cu",
        "bundleadjustment_tpu/solvers/pallas_dense_eval.py:338", "pipeline"),
    "schur_prepare_s": ("cuda", "bundleadjustment_tpu_torch/csrc/schur_s.cu",
                        "bundleadjustment_tpu/solvers/pallas_dense_eval.py:849",
                        "pipeline"),
    "schur_qqt_partial": ("cuda", "bundleadjustment_tpu_torch/csrc/schur_s.cu",
                          "bundleadjustment_tpu/solvers/pallas_dense_eval.py:849",
                          "pipeline_sharded"),
    "schur_prepare": ("cuda", "bundleadjustment_tpu_torch/csrc/schur_prepare.cu",
                      "bundleadjustment_tpu/solvers/pallas_dense_eval.py:533",
                      "large_o_solve"),
    "chol_solve": ("cuda", "bundleadjustment_tpu_torch/csrc/chol_solve.cu",
                   "bundleadjustment_tpu/solvers/pallas_chol.py:204",
                   "chol_solve_path"),
}
# what else each path's run must launch (the sharded pipeline's local BAs
# and evals still go through B and C)
_DENSE = ("dense_eval_assemble", "dense_eval_assemble_bs", "schur_prepare_s")
ALSO_LAUNCHED = {"pipeline_sharded": _DENSE,
                 "dense_pcg_solve": ("dense_eval_assemble",),
                 "pipeline_pcg": ("hamming_top2", "dense_eval_assemble"),
                 "pipeline_windowed": ("hamming_top2",),
                 "pipeline_depth_seeded": ("hamming_top2", "dense_eval_assemble"),
                 "pipeline_essential_or_homography": ("hamming_top2",),
                 "pipeline_standard": ("hamming_top2",),
                 "pipeline_standard_dense": ("hamming_top2", *_DENSE),
                 "pipeline_predetect": ("hamming_top2", *_DENSE),
                 "pipeline_outputs": ("hamming_top2", *_DENSE),
                 "protocol_config1": ("hamming_top2", *_DENSE),
                 "protocol_resume_worker": ("hamming_top2", *_DENSE),
                 "pipeline_track_batch_1": ("hamming_top2", *_DENSE),
                 "track_batch_step": ("hamming_top2",)}
# the least number of launches a path's run must show (default 1)
MIN_LAUNCHES = {"chol_solve": 10}
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# float32 operations of one (point, point) pair of a nearest-neighbour
# search: the 3-term dot product (3 products, 2 sums), the two squared norms
# added, the -2 scale and one compare
NN_PAIR_OPS = 9
RTOL, ATOL = 2e-4, 2e-3  # block outputs (the kernels sum in other orders)
# frames a tracking microbatch of the default configuration takes
TRACK_BATCH = 8
COST_RTOL = 1e-5


_T0 = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase line also says when ("t_s": seconds
    since the script started)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def device_breakdown(fn, top=8):
    """One torch.profiler session over fn() (after a warm-up call): the wall
    ms (host clock, ended by a synchronise), the device ms summed over every
    kernel record, the kernel launches, and the `top` kernels by device
    time with their launches and ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per = {}
    for e in device_events(prof):
        d = per.setdefault(kernel_name(e.name), [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(d[1] for d in per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall, "device_ms": busy,
            "launches": sum(d[0] for d in per.values()),
            "top": [{"kernel": k, "launches": d[0], "ms": d[1]} for k, d in ranked]}


def device_time(fn, reps=10, tries=3, kernel=None):
    """(ms, source): the mean of device_times."""
    d = device_times(fn, reps, tries, kernel)
    return d["ms"], d["ms_source"]


# calls a profile of kernels A, B and C takes, for the spread of their
# device times per call
KERNEL_REPS = 50


def time_pair(kernel_fn, plain_fn, reps=10):
    """Kernel and plain version timed in turns: device ms per call ("ms",
    "plain_ms", with the source of each in "ms_source", "plain_ms_source";
    the kernel's over `reps` calls with device_times' "ms_min",
    "ms_median", "ms_max" and "per_kernel") and CUDA-event ms per
    back-to-back call ("call_ms", "plain_call_ms")."""
    plain_ms, plain_src = device_time(plain_fn)
    k = device_times(kernel_fn, reps=reps)
    return {"plain_ms": plain_ms, **k, "plain_ms_source": plain_src,
            "call_ms": cuda_time(kernel_fn), "plain_call_ms": cuda_time(plain_fn)}


def max_abs(a, b):
    import torch

    return float(torch.max(torch.abs(a.double() - b.double())).item()) if a.numel() else 0.0


def check_close(name, got, ref, rtol=RTOL, atol=ATOL, scale=1.0):
    """Elementwise |got - ref| <= atol + rtol |ref| after dividing both by
    `scale` (a number or a tensor that broadcasts). Returns max |got - ref|."""
    import torch

    ok = torch.allclose(got.double() / scale, ref.double() / scale, rtol=rtol,
                        atol=atol)
    if not ok:
        raise AssertionError(f"{name}: max abs err {max_abs(got, ref)} "
                             f"(rtol {rtol}, atol {atol})")
    return max_abs(got, ref)


def block_scale(name, ref):
    """Magnitude of each block of a kernel B / C output, broadcastable against
    it. The kernels sum in another order than the plain versions (per-warp
    tables and per-block slabs for the per-camera rows, atomics for S and b;
    a loop over the O slots for Vu and g_p), and these sums cancel, so near-zero entries differ by float32
    round-off of their block's magnitude, not of their own. Each block is
    held to rtol 2e-4 / atol 2e-3 relative to its own max: red's 21 upper-U
    columns and its 6 g_c columns apart, each row of Vu, g_p and W, and S and
    b each as a whole. So a small block (g_c near convergence, b) is not
    excused by a large one (U, S)."""
    import torch

    a = ref.detach().double().abs()
    if name == "red":
        s = torch.cat([a[:, :21].max().expand(21), a[:, 21:].max().expand(6)])[None]
    elif name in ("Vu", "g_p"):
        s = a.amax(dim=1, keepdim=True)
    elif name == "W":
        s = a.reshape(18, -1).amax(dim=1).reshape(6, 3, 1, 1)
    else:
        s = a.max()
    return torch.where(s > 0, s, torch.ones_like(s))


def check_blocks(tag, name, got, ref):
    return check_close(f"{tag} {name}", got, ref, scale=block_scale(name, ref))


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------
# Bytes: each input read once and each output written once. Operations:
# what this run's data needs, counted from the kernels' arithmetic (valid
# observation slots, all-zero W slots skipped, a landmark's slot pairs once
# each), against the float32 rate outside the tensor cores. Kernel A's
# operations are integer (XOR, popcount, add, compare): its bound is the
# largest of its bytes, its 25 operations a pair at the float32 rate, and
# its 8 popcounts a pair at POPC_PER_CLOCK_SM an SM and clock (sm_90's
# issue rate for POPC, the CUDA programming guide's throughput table) at the
# card's top SM clock (`nvidia-smi --query-gpu=clocks.max.sm`). The
# operation counts of kernels B, C, K5 and D (EVAL_OPS, BS_OPS, PREP_OPS,
# G_OPS, WZ_OPS, PAIR_OPS) are `utils/flops`'s, which bounds a whole LM
# iteration with them.


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """{"bound_ms", "bound_by", "bytes", "ops"}: the larger of bytes over the
    HBM rate and operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / F32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(n_ops)}


POPC_PER_CLOCK_SM = 16


def sm_clock_max_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True).stdout.split()
    return float(out[0]) * 1e6


def hamming_bound(q, t, v, outs):
    """bound() of kernel A, and the larger of it and the popcounts' time:
    "bound_of" says which of bytes, float32 operations (25 a pair: 8 XOR, 8
    popcounts, 7 adds, 2 compares) and popcounts (8 a pair) it is."""
    import torch

    pairs = q.shape[1] * int(v.sum())
    b = bound(nbytes(q, t, v, *outs), 25 * pairs)
    b["bound_of"] = "bytes" if b["bound_by"] == "bytes" else "float32 operations"
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    clock = sm_clock_max_hz()
    popc_ms = 8 * pairs / (POPC_PER_CLOCK_SM * n_sm * clock) * 1e3
    b.update({"popcounts": 8 * pairs, "sm_clock_max_mhz": clock / 1e6,
              "popcount_ms": popc_ms})
    if popc_ms > b["bound_ms"]:
        b.update({"bound_ms": popc_ms, "bound_by": "operations",
                  "bound_of": "popcounts"})
    return b


def slot_counts(W18):
    """(non-zero W slots per landmark [L], their sum, the slot pairs)."""
    n = (W18 != 0).any(0).sum(0).double()
    return n, float(n.sum()), float((n * (n + 1) / 2).sum())


def schur_bound(ins, outs, W18, L):
    from bundleadjustment_tpu_torch.utils.flops import G_OPS, PAIR_OPS, PREP_OPS, WZ_OPS

    _, slots, pairs = slot_counts(W18)
    return bound(nbytes(*ins, *outs),
                 PREP_OPS * L + (G_OPS + WZ_OPS) * slots + PAIR_OPS * pairs)


def prepare_bound(ins, outs, W18, L):
    from bundleadjustment_tpu_torch.utils.flops import G_OPS, PREP_OPS, WZ_OPS

    _, slots, _ = slot_counts(W18)
    return bound(nbytes(*ins, *outs), PREP_OPS * L + (G_OPS + WZ_OPS) * slots)


# kernel E's device ms per call before this design (one block of 1,024
# threads, 8-row panels): PERF.md's K7 rows, from chip_smoke.py on an H100
# 80GB HBM3 at 700 W; a fixed reference figure, not measured here
ONE_BLOCK_E_MS = {48: 0.0209, 384: 0.6709, 426: 0.8693, 768: 3.173, 3600: 271.2}


# kernels C and K5 before this design (one thread per landmark, float
# atomics into S), device ms per call by shape: PERF.md's K3 / K5 rows, from
# chip_smoke.py on an H100 80GB HBM3 at 700 W; fixed reference figures, not
# measured here
OLD_SCHUR_MS = {
    "schur_prepare_s": {"64c_10k_O16": 0.4255, "128c_100k_O8": 1.194,
                        "config7": 12.54, "pipeline_final_ba": 0.03342},
    "schur_qqt_partial": {"128c_100k_O8": 1.183, "config7": 12.55,
                          "pipeline_final_ba": 0.03741}}


# kernel D before this design (one thread per landmark, float atomics into
# red6), device ms per call by shape: PERF.md's K6 rows, from chip_smoke.py
# on an H100 80GB HBM3 at 700 W; fixed reference figures, not measured here
OLD_PREPARE_MS = {"128c_100k_O8": 0.05785, "2100c_3k_O16": 0.01888,
                  "config7": 0.2507, "pipeline_final_ba": 0.04623}


def prepare_plan_fields(tag, K, L, O):
    """Kernel D's launch plan at this shape (dense_kernels.
    schur_prepare_plan on this card) and its time before this design."""
    import torch

    from bundleadjustment_tpu_torch.solvers.dense_kernels import schur_prepare_plan

    plan = schur_prepare_plan(K, L, O, torch.cuda.get_device_properties(0)
                              .multi_processor_count)
    return {"plan": {"slots": plan.slots, "chunks": plan.chunks,
                     "warps": plan.warps, "blocks": plan.blocks,
                     "rounds": plan.rounds, "tile": plan.tile,
                     "tiles": plan.n_tiles, "smem_kb": plan.smem_bytes / 1024,
                     "scratch_kb": plan.scratch_bytes / 1024},
            "old_ms": OLD_PREPARE_MS.get(tag)}


def schur_plan_fields(name, tag, K, L, O):
    """Kernel C / K5's launch plan at this shape (dense_kernels.
    schur_s_plan on this card) and its time before this design."""
    import torch

    from bundleadjustment_tpu_torch.solvers.dense_kernels import schur_s_plan

    plan = schur_s_plan(K, L, O, torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    return {"tile": plan.tile, "tiles": plan.n_tiles, "chunks": plan.chunks,
            "blocks": len(plan.pairs) * plan.chunks,
            "scratch_mb": plan.scratch_bytes / 2**20,
            "old_ms": OLD_SCHUR_MS[name].get(tag)}


def compare_chol(tag, S, b):
    """Kernel E on one camera system S x = b: against its plain version with
    the kernel's panels (`chol_solve_plain(panel=PANEL_E)`) and with the
    reference's (panel 8), and against float64 `numpy.linalg.solve`, beside
    the library call (`schur.cholesky_solve_nan`: `cholesky_ex` +
    `cholesky_solve`).

    Errors are relative max errors against float64. On S = A A^T + N I the
    bound is 1e-5; the LM systems are ill-conditioned ("eig_min", "eig_max":
    S's extreme eigenvalues in float64; cameras without observations leave
    eig_min at the 1e-8 jitter or, after float32 rounding, below zero), and
    any float32 factorisation loses about eps * eig_max / eig_min there. So
    the stated bound is max(1e-5, 20 x the library call's own error on the
    same system), for kernel against float64 and against either plain
    version alike.

    The bound_ms counts N^2 * 4 bytes (+ b and x) and N^3 / 3 + 2 N^2
    operations; "grid_barriers" is the length of the dependency chain (3
    per panel less one), which no byte or operation rate shortens; "blocks"
    is the cooperative grid, "panel" P. "one_block_ms" is ONE_BLOCK_E_MS."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch.solvers import chol
    from bundleadjustment_tpu_torch.solvers.schur import cholesky_solve_nan

    N = S.shape[0]
    x_k = chol.chol_solve(S, b)
    torch.cuda.synchronize()
    x_p = chol.chol_solve_plain(S, b, panel=chol.PANEL_E)
    x_p8 = chol.chol_solve_plain(S, b)
    x_l = cholesky_solve_nan(S, b)
    x64 = np.linalg.solve(S.double().cpu().numpy(), b.double().cpu().numpy())
    eig = torch.linalg.eigvalsh(S.double())
    rel = lambda x, ref: float(np.abs(x.double().cpu().numpy() - ref).max()
                               / np.abs(ref).max())
    err_k, err_p, err_l = rel(x_k, x64), rel(x_p, x64), rel(x_l, x64)
    k_vs_p = rel(x_k, x_p.double().cpu().numpy())
    k_vs_p8 = rel(x_k, x_p8.double().cpu().numpy())
    limit = max(1e-5, 20.0 * err_l)
    plan = chol.card_plan(N, S.device)
    out = {"N": N, "eig_min": float(eig[0]), "eig_max": float(eig[-1]),
           "rel_err_vs_float64": err_k,
           "plain_rel_err_vs_float64": err_p, "library_rel_err_vs_float64": err_l,
           "rel_err_vs_plain": k_vs_p, "rel_err_vs_plain_panel_8": k_vs_p8,
           "rel_err_bound": limit, "max_abs_err": max_abs(x_k, x_p),
           "panel": plan["panel"], "blocks": plan["grid"],
           "grid_barriers": plan["grid_barriers"],
           "one_block_ms": ONE_BLOCK_E_MS.get(N)}
    if not (err_k < limit and k_vs_p < limit and k_vs_p8 < limit
            and bool(torch.isfinite(x_k).all())):
        raise AssertionError(f"{tag} E: kernel {err_k}, plain {err_p}, library "
                             f"{err_l} against float64, kernel against plain "
                             f"{k_vs_p} (panel 8: {k_vs_p8}); bound {limit}")
    lib_ms, lib_src = device_time(lambda: cholesky_solve_nan(S, b))
    ms, src = device_time(lambda: chol.chol_solve(S, b), kernel="chol_solve_kernel")
    # the plain version is a Python loop of ~270 small launches per panel
    # (30k launches a call at N = 3600): a torch.profiler profile of it takes
    # minutes, so it is timed with CUDA events alone, over few calls; its
    # time is the host's, not the card's
    plain_ms = cuda_time(lambda: chol.chol_solve_plain(S, b, panel=chol.PANEL_E),
                         reps=1 if N > 1000 else 3, warmup=1)
    out.update({"ms": ms, "ms_source": src,
                "call_ms": cuda_time(lambda: chol.chol_solve(S, b)),
                "plain_ms": plain_ms, "plain_ms_source": "cuda_events",
                "plain_call_ms": plain_ms})
    out.update(bound(nbytes(S, b, x_k), N ** 3 / 3 + 2 * N ** 2))
    out.update({"library_ms": lib_ms, "library_ms_source": lib_src,
                "library_call_ms": cuda_time(lambda: cholesky_solve_nan(S, b))})
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "nvidia_smi": smi[0],
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})
    return smi[0]


def phase_build():
    from bundleadjustment_tpu_torch import kernels

    t0 = time.perf_counter()
    secs = kernels.build_all(force=True)
    for name in kernels.SIGNATURES:
        kernels.lib(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_library_s": secs, "flags": kernels.NVCC_FLAGS})


def _hamming_inputs(rng, B, M, device):
    import numpy as np
    import torch

    t = rng.integers(0, 2**32, (B, M, 8), dtype=np.uint32)
    q = t[0, rng.integers(0, M, M)].copy()
    # flip a few bits so distances spread from 0 up; duplicate rows make ties
    q ^= rng.integers(0, 2**32, q.shape, dtype=np.uint32) & np.uint32(0x00010001)
    t[:, 10] = t[:, 11]
    valid = rng.random((B, M)) > 0.05
    as_t = lambda a: torch.from_numpy(a.view(np.int32).copy()).to(device)
    return as_t(q)[None], as_t(t), torch.from_numpy(valid).to(device)


def phase_hamming(rng, device, results):
    import torch

    from bundleadjustment_tpu_torch.ops.features import FeatureConfig, level_allocations
    from bundleadjustment_tpu_torch.ops.hamming import (
        hamming_plan,
        hamming_top2,
        hamming_top2_plain,
    )

    rows = []
    # (B, M, pairwise): one query set against B train sets, and the tracking
    # microbatch's B query sets against B train sets at its main-path shape
    # (track_batch 8, the keypoints a frame of the default detector)
    n_kp = sum(level_allocations(FeatureConfig()))
    for B, M, pairwise in ((1, 1000, False), (25, 1000, False),
                           (TRACK_BATCH, n_kp, True)):
        q, t, v = _hamming_inputs(rng, B, M, device)
        if pairwise:
            q = torch.cat([q, t[:-1]]).contiguous()
        got = hamming_top2(q, t, v)
        ref = hamming_top2_plain(q, t, v)
        torch.cuda.synchronize()
        for g, r, n in zip(got, ref, ("best", "second", "idx")):
            if not torch.equal(g, r):
                raise AssertionError(f"hamming_top2 B={B} pairwise={pairwise}: {n} "
                                     "not bit-identical")
        plan = hamming_plan(B, M, M, torch.cuda.get_device_properties(0)
                            .multi_processor_count)
        rows.append({"batch": B, "m1": M, "m2": M, "pairwise": pairwise,
                     "bit_identical": True,
                     **time_pair(lambda: hamming_top2(q, t, v),
                                 lambda: hamming_top2_plain(q, t, v), reps=KERNEL_REPS),
                     **hamming_bound(q, t, v, got), "library_ms": None,
                     "plan": {"chunk": plan.chunk, "chunks": plan.n_chunks,
                              "blocks": plan.blocks}})
    results["hamming_top2"] = {"max_abs_err": 0.0, "shapes": rows, **rows[-1]}
    emit({"phase": "kernel", "name": "hamming_top2", "shapes": rows})


def synthetic_dense(n_cams, n_pts, obs_per_pt, max_obs, device, copies=1,
                    fix_gauge=False):
    """A dense problem from make_synthetic_scene with camera 0 fixed. With
    copies > 1 every camera is repeated `copies` times and each observation
    goes to one of its camera's copies at random, so n_cams * copies cameras
    all hold observations of the same geometry. fix_gauge also fixes the two
    cameras with the most observations at their true poses, so the solved
    cameras are unique (as in the JAX package's solve parity test,
    tests/test_pallas_dense_eval.py, which fixes cameras 0 and 1 of 8). On
    the 128-camera arc, cameras 0-7 observe nothing: fixing them leaves the
    similarity gauge of the observed cameras free, and the LM steps then
    drift along it by float32 noise (on an H100, kernel and plain runs of
    the 10-iteration solve ended 1.5e-4 to 4.2e-4 apart, and over 5e-4 once;
    with the gauge fixed here, within 4e-6)."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem

    sc = make_synthetic_scene(n_cams=n_cams, n_pts=n_pts, obs_per_pt=obs_per_pt,
                              pixel_noise=0.5, seed=0)
    rng = np.random.default_rng(1)
    cam_idx = (sc.cam_idx + n_cams * rng.integers(0, copies, sc.cam_idx.shape)
               ).astype(np.int32)
    cam_fixed = np.zeros(n_cams * copies, bool)
    cam_fixed[0] = True
    if fix_gauge:
        n_obs = np.bincount(sc.cam_idx[sc.valid], minlength=n_cams)
        gauge = np.argsort(-n_obs, kind="stable")[:2]
        cam_fixed[gauge] = True
        sc.extr_init[gauge] = sc.extr_gt[gauge]
    extr = np.tile(sc.extr_init, (copies, 1))
    prob, _ = densify_problem(sc.K4, cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                              sc.valid, cam_fixed, n_pts, max_obs=max_obs,
                              device=device)
    cams = torch.from_numpy(extr).to(device)
    pts = torch.from_numpy(sc.points_init).to(device)
    return prob, cams, pts


def dense_inputs(prob, cams, pts, bs=True):
    """The inputs of kernels B, C, K5 and D at one shape, from the plain
    versions: "seed" (eval_assemble's), "c" (schur_prepare_s's), "p" (K5's
    and D's), and with `bs` "bs" (eval_assemble_bs's, at the camera step
    that the plain C and the library Cholesky give), beside the plain seed
    outputs "seed_p", the plain C outputs "s_p" (with `bs`) and the shape."""
    import torch

    from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat
    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
    from bundleadjustment_tpu_torch.solvers.dense_ba import _to_cm
    from bundleadjustment_tpu_torch.solvers.schur import cholesky_solve_nan

    cm = _to_cm(prob)
    O, L = cm.cam_t.shape
    K = cm.cam_fixed.shape[0]
    R = aa_to_rotmat(cams[:, :3]).contiguous()
    t = cams[:, 3:].contiguous()
    Xt = pts.T.contiguous()
    args = (cm.K4, cm.cam_t, cm.uv_t, cm.inv_sigma_t, cm.valid_t, cm.fixed_t)
    seed_p = dk.eval_assemble_plain(*args, R, t, Xt)
    _, red, Vu, g_p, W = seed_p
    W18 = W.reshape(18, O, L)
    lam = torch.tensor(1e-4, device=cams.device)
    c_args = (lam, Vu, g_p, cm.pt_valid, W18, cm.cam_t, K, red, cm.cam_fixed)
    out = {"cm": cm, "O": O, "L": L, "K": K, "W18": W18, "red": red, "lam": lam,
           "seed": (*args, R, t, Xt), "seed_p": seed_p, "c": c_args,
           "p": c_args[:7], "n_valid": int(cm.valid_t.sum())}
    if bs:
        s_p = dk.schur_prepare_s_plain(*c_args)
        S, _zv, vinv6, b = s_p
        dc = cholesky_solve_nan(S, b).reshape(6, K).T
        dc = torch.where(cm.cam_fixed[:, None], torch.zeros_like(dc), dc).contiguous()
        R_new = (aa_to_rotmat(dc[:, :3]) @ R).contiguous()
        t_new = (t + dc[:, 3:]).contiguous()
        out.update(s_p=s_p, bs=(*args, R_new, t_new, dc, Xt, W18, vinv6, g_p,
                                cm.pt_valid))
    return out


def b_plan_fields(K, L, O):
    """Kernel B's launch plan at this shape (dense_kernels.dense_eval_plan
    on this card)."""
    import torch

    from bundleadjustment_tpu_torch.solvers.dense_kernels import dense_eval_plan

    plan = dense_eval_plan(K, L, O, torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    return {"plan": {"lanes": plan.lanes, "warps": plan.warps,
                     "blocks": plan.blocks, "tile": plan.tile,
                     "tiles": plan.n_tiles, "rounds": plan.rounds,
                     "smem_kb": plan.smem_bytes / 1024,
                     "scratch_kb": plan.scratch_bytes / 1024}}


def check_twice(tag, label, fn, got, n=2):
    """Two calls of a kernel on the same inputs give bit-identical outputs
    (the first `n` of them)."""
    import torch

    again = fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got[:n], again[:n])):
        raise AssertionError(f"{tag} {label}: two calls gave different bits")


def check_own_kernels(tag, label, timing, part):
    """A call of a kernel launches its own kernels only (no zeroing
    launches), as the profile of its timing shows: each kernel's name holds
    `part`."""
    names = list(timing.get("per_kernel") or ())
    if any(part not in n for n in names):
        raise AssertionError(f"{tag} {label}: a call launched other kernels: {names}")


def compare_dense_kernels(prob, cams, pts, tag, names=None):
    """Kernels B (seed, bs), C, K5, D and E against their plain versions at
    one shape (`names`: the kernels to check, default all). Returns {kernel:
    {"max_abs_err", "ms", "ms_min", "ms_median", "ms_max", "plain_ms", ...,
    "bound_ms", "bound_by", "library_ms"}}; no single PyTorch call computes
    B, C, K5 or D, so their "library_ms" is None; E's is `compare_chol`'s.
    Kernels B and D are also called twice (B's red and cost, and every
    output of D, bit-identical) and their calls must launch their own
    kernels only."""
    import torch

    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
    from bundleadjustment_tpu_torch.solvers.dense_ba import schur_route
    from bundleadjustment_tpu_torch.utils.flops import BS_OPS, EVAL_OPS

    names = set(names or ("dense_eval_assemble", "dense_eval_assemble_bs",
                          "schur_prepare_s", "schur_qqt_partial", "schur_prepare",
                          "chol_solve"))
    x = dense_inputs(prob, cams, pts,
                     bs=bool(names & {"dense_eval_assemble_bs", "chol_solve"}))
    cm, O, L, K, W18 = x["cm"], x["O"], x["L"], x["K"], x["W18"]
    lam, red = x["lam"], x["red"]
    seed, c_args, p_args = x["seed"], x["c"], x["p"]
    out = {}

    if "dense_eval_assemble" in names:
        seed_p = x["seed_p"]
        seed_k = dk.eval_assemble(*seed)
        torch.cuda.synchronize()
        errs = [check_close(f"{tag} B cost", seed_k[0], seed_p[0],
                            rtol=COST_RTOL, atol=0.0)]
        errs += [check_blocks(f"{tag} B", n, g, r) for g, r, n in
                 zip(seed_k[1:], seed_p[1:], ("red", "Vu", "g_p", "W"))]
        check_twice(tag, "B", lambda: dk.eval_assemble(*seed), seed_k)
        timing = time_pair(lambda: dk.eval_assemble(*seed),
                           lambda: dk.eval_assemble_plain(*seed), reps=KERNEL_REPS)
        check_own_kernels(tag, "B", timing, "dense_eval")
        out["dense_eval_assemble"] = {
            "max_abs_err": max(errs), "bit_identical_twice": True, **timing,
            **bound(nbytes(*seed, *seed_k), EVAL_OPS * x["n_valid"]),
            "library_ms": None, **b_plan_fields(K, L, O)}

    c_ins = (lam, *c_args[1:6], red, cm.cam_fixed)
    if "schur_prepare_s" in names:
        s_p = x.get("s_p") or dk.schur_prepare_s_plain(*c_args)
        s_k = dk.schur_prepare_s(*c_args)
        torch.cuda.synchronize()
        errs = [check_blocks(f"{tag} C", "S", s_k[0], s_p[0]),
                check_blocks(f"{tag} C", "b", s_k[3], s_p[3]),
                check_close(f"{tag} C zv", s_k[1], s_p[1]),
                check_close(f"{tag} C vinv6", s_k[2], s_p[2])]
        out["schur_prepare_s"] = {
            "max_abs_err": max(errs),
            **time_pair(lambda: dk.schur_prepare_s(*c_args),
                        lambda: dk.schur_prepare_s_plain(*c_args), reps=KERNEL_REPS),
            **schur_bound(c_ins, s_k, W18, L), "library_ms": None,
            **schur_plan_fields("schur_prepare_s", tag, K, L, O)}

    if "schur_qqt_partial" in names:
        q_k = dk.schur_qqt_partial(*p_args)
        q_p = dk.schur_qqt_partial_plain(*p_args)
        torch.cuda.synchronize()
        errs = [check_blocks(f"{tag} K5", "S", q_k[0], q_p[0]),
                check_blocks(f"{tag} K5", "red6", q_k[3], q_p[3]),
                check_close(f"{tag} K5 zv", q_k[1], q_p[1]),
                check_close(f"{tag} K5 vinv6", q_k[2], q_p[2])]
        out["schur_qqt_partial"] = {
            "max_abs_err": max(errs),
            **time_pair(lambda: dk.schur_qqt_partial(*p_args),
                        lambda: dk.schur_qqt_partial_plain(*p_args)),
            **schur_bound(p_args[:6], q_k, W18, L), "library_ms": None,
            **schur_plan_fields("schur_qqt_partial", tag, K, L, O)}

    if "schur_prepare" in names:
        d_k = dk.schur_prepare(*p_args)
        d_p = dk.schur_prepare_plain(*p_args)
        torch.cuda.synchronize()
        errs = [check_blocks(f"{tag} D", "W", d_k[0].reshape(6, 3, O, L),
                             d_p[0].reshape(6, 3, O, L)),
                check_blocks(f"{tag} D", "red6", d_k[3], d_p[3]),
                check_close(f"{tag} D zv", d_k[1], d_p[1]),
                check_close(f"{tag} D vinv6", d_k[2], d_p[2])]
        check_twice(tag, "D", lambda: dk.schur_prepare(*p_args), d_k, n=4)
        timing = time_pair(lambda: dk.schur_prepare(*p_args),
                           lambda: dk.schur_prepare_plain(*p_args), reps=KERNEL_REPS)
        check_own_kernels(tag, "D", timing, "schur_prepare")
        out["schur_prepare"] = {
            "max_abs_err": max(errs), "bit_identical_twice": True, **timing,
            **prepare_bound(p_args[:6], d_k, W18, L), "library_ms": None,
            **prepare_plan_fields(tag, K, L, O)}

    if "chol_solve" in names:
        # the system the solve of this shape hands to the Cholesky: kernel
        # C's, or for O > 64 route (c)'s damped_system of D + Pf + Q Q^T
        if schur_route(O) == "s":
            S_e, _, _, b_e = dk.schur_prepare_s(*c_args)
        else:
            G, _, _, red6 = dk.schur_prepare(*p_args)
            S_e, b_e = dk.damped_system(lam, red, cm.cam_fixed,
                                        dk.qqt(dk.pf_index_add(G, cm.cam_t, K), K),
                                        red6)
        out["chol_solve"] = compare_chol(tag, S_e.contiguous(), b_e.contiguous())

    if "dense_eval_assemble_bs" in names:
        bs_args = x["bs"]
        bs_k = dk.eval_assemble_bs(*bs_args)
        bs_p = dk.eval_assemble_bs_plain(*bs_args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(bs_p[0])):
            raise AssertionError(f"{tag}: non-finite trial cost")
        errs = [check_close(f"{tag} Bbs cost", bs_k[0], bs_p[0], rtol=COST_RTOL,
                            atol=0.0)]
        errs += [check_blocks(f"{tag} Bbs", n, g, r) for g, r, n in
                 zip(bs_k[1:5], bs_p[1:5], ("red", "Vu", "g_p", "W"))]
        errs += [check_close(f"{tag} Bbs Xt_new", bs_k[5], bs_p[5])]
        check_twice(tag, "B", lambda: dk.eval_assemble_bs(*bs_args), bs_k)
        timing = time_pair(lambda: dk.eval_assemble_bs(*bs_args),
                           lambda: dk.eval_assemble_bs_plain(*bs_args),
                           reps=KERNEL_REPS)
        check_own_kernels(tag, "B", timing, "dense_eval")
        out["dense_eval_assemble_bs"] = {
            "max_abs_err": max(errs), "bit_identical_twice": True, **timing,
            **bound(nbytes(*bs_args, *bs_k), (EVAL_OPS + BS_OPS) * x["n_valid"]),
            "library_ms": None, **b_plan_fields(K, L, O)}
    return out


def phase_dense_kernels(device, results):
    """B, C, K5, D and E at the two solve shapes of the records, and at 600
    cameras (12 cameras x 50 copies, 3k landmarks), where kernel B cuts the
    cameras into 5 tiles and C into 18; B and D alone at 2,100 cameras (12 x
    175: B in 17 camera tiles, D in 5). Each kernel's reported time is at
    128c/100k/O=8, D's at the config-7 shape (phase_large_o_kernels), E's at
    64c/10k/O=16 (N = 384, the shape of its path)."""
    shapes = {}
    for tag, (nc, npt, opp, mo, copies, names) in {
            "64c_10k_O16": (64, 10_000, 8, 16, 1, None),
            "128c_100k_O8": (128, 100_000, 6, 8, 1, None),
            "600c_3k_O16": (12, 3_000, None, 16, 50, None),
            "2100c_3k_O16": (12, 3_000, None, 16, 175,
                             ("schur_prepare", "dense_eval_assemble",
                              "dense_eval_assemble_bs"))}.items():
        prob, cams, pts = synthetic_dense(nc, npt, opp, mo, device, copies)
        res = compare_dense_kernels(prob, cams, pts, tag, names)
        O = int(prob.cam_idx.shape[1])
        shapes[tag] = res
        emit({"phase": "kernel", "shape": tag, "K": nc * copies, "L": npt,
              "O": O, **{k: v for k, v in res.items()}})
    for name in shapes["128c_100k_O8"]:
        mine = {k: v[name] for k, v in shapes.items() if name in v}
        results[name] = {
            **shapes["128c_100k_O8"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
            "shapes": mine}
    results["chol_solve"].update({k: v for k, v in
                                  shapes["64c_10k_O16"]["chol_solve"].items()
                                  if k != "max_abs_err"})


def track_dense(device, n_cams=71, n_pts=10_842, n_obs=156_774, n_all=500,
                max_obs=128):
    """The config-7-shaped dense problem (make_track_scene: every camera sees
    the n_all tail landmarks, so O = 72), with the two most-observed cameras
    fixed at their true poses. The counts are the records'; n_all = 500 and
    the track-length law are assumptions (the records keep no map). With
    max_obs < 72 every track keeps its first max_obs observations (O =
    max_obs); the rest are dropped."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch.data.track_scene import make_track_scene
    from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem

    sc = make_track_scene(n_cams=n_cams, n_pts=n_pts, n_obs=n_obs, n_all=n_all)
    cam_fixed = np.zeros(n_cams, bool)
    gauge = np.argsort(-np.bincount(sc.cam_idx, minlength=n_cams), kind="stable")[:2]
    cam_fixed[gauge] = True
    sc.extr_init[gauge] = sc.extr_gt[gauge]
    prob, dropped = densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv,
                                    sc.sigma2, sc.valid, cam_fixed, n_pts,
                                    max_obs=max_obs, device=device)
    if dropped and max_obs >= 72:
        raise AssertionError(f"config-7 shape: {dropped} observations dropped")
    return (prob, torch.from_numpy(sc.extr_init).to(device),
            torch.from_numpy(sc.points_init).to(device))


# landmarks seen by all 71 cameras at which the Schur-step routes are timed:
# the records imply at least one (the longest track has 71 observations)
N_ALL_SWEEP = (1, 50, 500)
SCHUR_GATE_SWEEP = (16, 32)  # O below config-7's 72 at which C meets route (c)


def schur_step_routes(device, n_all, max_obs=128, parts=True):
    """The two Schur-step routes on the config-7-shaped problem with n_all
    landmarks seen by every camera (tracks cut to max_obs), on the same
    inputs: C alone ("route_s"), and D + Pf + Q Q^T ("route_prepare"), with
    (parts) Pf (one index_add_) and Q Q^T (one matmul) also timed alone."""
    prob, cams, pts = track_dense(device, n_all=n_all, max_obs=max_obs)
    return {"n_all": n_all, **routes_on(prob, cams, pts, parts)}


def routes_on(prob, cams, pts, parts=True):
    """The two Schur-step routes on one dense problem's seed blocks (see
    schur_step_routes), each timed as device ms a call."""
    import torch

    from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat
    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
    from bundleadjustment_tpu_torch.solvers.dense_ba import _to_cm

    device = cams.device
    cm = _to_cm(prob)
    O, L = cm.cam_t.shape
    K = cm.cam_fixed.shape[0]
    R = aa_to_rotmat(cams[:, :3]).contiguous()
    _, red, Vu, g_p, W = dk.eval_assemble(cm.K4, cm.cam_t, cm.uv_t,
                                          cm.inv_sigma_t, cm.valid_t, cm.fixed_t,
                                          R, cams[:, 3:].contiguous(),
                                          pts.T.contiguous())
    W18 = W.reshape(18, O, L)
    lam = torch.tensor(1e-4, device=device)
    p_args = (lam, Vu, g_p, cm.pt_valid, W18, cm.cam_t, K)
    G = dk.schur_prepare(*p_args)[0]
    Pf = dk.pf_index_add(G, cm.cam_t, K)
    _, _, pairs = slot_counts(W18)

    def route_prepare():
        G_ = dk.schur_prepare(*p_args)[0]
        return dk.qqt(dk.pf_index_add(G_, cm.cam_t, K), K)

    routes = {"O": O, "n_obs": int(cm.valid_t.sum()), "slot_pairs": int(pairs)}
    # (label, call, a kernel it launches once per call: one full profile
    # is then enough)
    timed = [("route_s", lambda: dk.schur_prepare_s(*p_args, red, cm.cam_fixed),
              "schur_tiles"),
             ("route_prepare", route_prepare, "schur_prepare")]
    if parts:
        timed += [("pf_index_add", lambda: dk.pf_index_add(G, cm.cam_t, K), None),
                  ("qqt_matmul", lambda: dk.qqt(Pf, K), None)]
    for label, fn, kernel in timed:
        ms, src = device_time(fn, kernel=kernel)
        routes[label] = {"ms": ms, "ms_source": src, "call_ms": cuda_time(fn)}
    return routes


def phase_large_o_kernels(device, results):
    """C, K5 and D at the config-7 shape (n_all = 500), and the Schur-step
    routes at every n_all of N_ALL_SWEEP and, at n_all = 500, with the
    tracks cut to each O of SCHUR_GATE_SWEEP. D's reported time is this
    shape's."""
    prob, cams, pts = track_dense(device)
    res = compare_dense_kernels(prob, cams, pts, "config7",
                                ("schur_prepare_s", "schur_qqt_partial",
                                 "schur_prepare", "chol_solve"))
    routes = {f"n_all_{n}": schur_step_routes(device, n) for n in N_ALL_SWEEP}
    # the evidence for the O gate of route (s) (S_KERNEL_MAX_O): the tracks
    # of the n_all = 500 map cut to O = 16 and 32
    routes.update({f"O_{o}": schur_step_routes(device, 500, o, parts=False)
                   for o in SCHUR_GATE_SWEEP})
    emit({"phase": "kernel", "shape": "config7", "K": int(cams.shape[0]),
          "L": int(pts.shape[0]), "O": int(prob.cam_idx.shape[1]),
          "n_obs": int(prob.valid.sum()), **res, "schur_step_routes": routes})
    d_shapes = {**results["schur_prepare"]["shapes"], "config7": res["schur_prepare"]}
    results["schur_prepare"] = {
        **res["schur_prepare"], "shapes": d_shapes,
        "max_abs_err": max(v["max_abs_err"] for v in d_shapes.values())}
    for name in ("schur_prepare_s", "schur_qqt_partial", "chol_solve"):
        results[name]["shapes"]["config7"] = res[name]
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           res[name]["max_abs_err"])


def solve_both_ways(phase, prob, cams, pts, extra, tables=("KERNEL_OPS", "PLAIN_OPS"),
                    cfg=None, cam_atol=5e-4):
    """10 LM iterations of `dense_ba_solve` (`cfg`, default the exact solve)
    through the kernels and through the plain versions (`tables`: the names
    of the two DenseOps tables); cameras within `cam_atol`, final costs
    within rel 1e-3 and a cost that decreases. Returns the launch counts of
    the kernel run."""
    import torch

    from bundleadjustment_tpu_torch import kernels
    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
    from bundleadjustment_tpu_torch.solvers.dense_ba import dense_ba_solve
    from bundleadjustment_tpu_torch.solvers.lm import LMConfig

    cfg = cfg or LMConfig(max_iters=10)
    out = {}
    for label, ops in zip(("kernel", "plain"), (getattr(dk, t) for t in tables)):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        c, p, info = dense_ba_solve(prob, cams, pts, cfg, ops=ops)
        torch.cuda.synchronize()
        out[label] = (c, float(info["cost0"]), float(info["cost"]),
                      time.perf_counter() - t0, kernels.launch_counts())
    ck, c0, cost_k, sk, counts = out["kernel"]
    cp, _, cost_p, sp, _ = out["plain"]
    cam_err = max_abs(ck, cp)
    rel = abs(cost_k - cost_p) / abs(cost_p)
    emit({"phase": phase, **extra, "ops": list(tables), "iters": cfg.max_iters,
          "solver": cfg.solver, "cost0": c0, "cost_kernel": cost_k,
          "cost_plain": cost_p, "cost_rel_diff": rel, "cams_max_abs_diff": cam_err,
          "cams_atol": cam_atol, "wall_s_kernel": sk, "wall_s_plain": sp,
          "launches": counts})
    if not (rel < 1e-3 and cam_err < cam_atol and cost_k < c0):
        raise AssertionError(f"{phase}: kernel and plain runs disagree or the "
                             "cost did not decrease")
    return counts


def phase_dense_solve(device):
    prob, cams, pts = synthetic_dense(128, 100_000, 6, 8, device, fix_gauge=True)
    solve_both_ways("dense_solve", prob, cams, pts, {"K": 128, "L": 100_000})


def phase_large_o_solve(device):
    """The config-7-shaped problem through route (c): kernel D + Pf + Q Q^T.
    Returns the kernel run's launch counts."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import schur_route

    prob, cams, pts = track_dense(device)
    O = int(prob.cam_idx.shape[1])
    if schur_route(O) != "prepare":
        raise AssertionError(f"config-7 shape: O = {O} does not take route (c)")
    return solve_both_ways("large_o_solve", prob, cams, pts,
                           {"K": int(cams.shape[0]), "L": int(pts.shape[0]),
                            "O": O, "n_obs": int(prob.valid.sum())})


def lm_iteration_ms(prob, cams, pts, ops, short=10, long=30, tries=3, **lm):
    """Milliseconds per LM iteration of `dense_ba_solve` with `ops` (and the
    LMConfig fields `lm`): the host-clock time of a `long`-iteration solve
    less that of a `short` one (each the best of `tries`, ended by a
    synchronise), over the difference in iterations, so the seed eval and
    the set-up cancel."""
    import torch

    from bundleadjustment_tpu_torch.solvers.dense_ba import dense_ba_solve
    from bundleadjustment_tpu_torch.solvers.lm import LMConfig

    def best(iters):
        times = []
        for _ in range(tries + 1):  # the first is the warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dense_ba_solve(prob, cams, pts, LMConfig(max_iters=iters, **lm), ops=ops)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return min(times[1:])

    return (best(long) - best(short)) / (long - short) * 1e3


def solve_roofline(ms, prob, solver="dense", pcg_iters=0):
    """`utils/flops.solve_roofline` of a measured ms an LM iteration on the
    card: the port's own bound and its share (which must not exceed 1), and
    the JAX package's FLOP model (whose ratio counts TPU mechanics too, see
    that module)."""
    from bundleadjustment_tpu_torch.utils import flops

    roof = flops.solve_roofline(ms, prob, "cuda", solver, pcg_iters)
    if not 0 < roof["port_bound_share"] <= 1:
        raise AssertionError(f"an LM iteration of {ms} ms against its bound: {roof}")
    return {"ms_per_iter": ms, **roof}


def phase_chol_solve_path(device):
    """Kernel E's path: the 64c/10k/O=16 dense solve with the camera system
    (N = 384) solved by kernel E, against the plain versions and against
    the same solve through the library call, and the time of one LM
    iteration of each variant, in turns (library, E, E, library). Returns
    the launch counts of the 10-iteration kernel-E run."""
    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
    from bundleadjustment_tpu_torch.solvers.dense_ba import dense_ba_solve
    from bundleadjustment_tpu_torch.solvers.lm import LMConfig

    prob, cams, pts = synthetic_dense(64, 10_000, 8, 16, device, fix_gauge=True)
    counts = solve_both_ways("chol_solve_path", prob, cams, pts,
                             {"K": 64, "L": 10_000, "N": 384},
                             ("KERNEL_OPS_CHOL", "PLAIN_OPS_CHOL"))
    cfg = LMConfig(max_iters=10)
    c_e, _, i_e = dense_ba_solve(prob, cams, pts, cfg, ops=dk.KERNEL_OPS_CHOL)
    c_l, _, i_l = dense_ba_solve(prob, cams, pts, cfg, ops=dk.KERNEL_OPS)
    cam_err = max_abs(c_e, c_l)
    rel = abs(float(i_e["cost"]) - float(i_l["cost"])) / abs(float(i_l["cost"]))
    ms = [lm_iteration_ms(prob, cams, pts, getattr(dk, t)) for t in
          ("KERNEL_OPS", "KERNEL_OPS_CHOL", "KERNEL_OPS_CHOL", "KERNEL_OPS")]
    O = int(prob.cam_idx.shape[1])
    emit({"phase": "chol_solve_vs_library", "K": 64, "L": 10_000, "N": 384, "O": O,
          "cams_max_abs_diff": cam_err, "cost_rel_diff": rel,
          "lm_iteration_ms_library": [ms[0], ms[3]],
          "lm_iteration_ms_kernel_e": [ms[1], ms[2]],
          "roofline_library": solve_roofline(min(ms[0], ms[3]), prob),
          "roofline_kernel_e": solve_roofline(min(ms[1], ms[2]), prob)})
    if not (cam_err < 5e-4 and rel < 1e-3):
        raise AssertionError("the solve through kernel E and the solve through "
                             "the library Cholesky disagree")
    return counts


# the slice's PCG budget: the pipeline's default (PipelineConfig.pcg_iters)
PCG_ITERS = 60
# kernels the PCG step must not launch: the exact routes' Schur kernels,
# B with back-substitution and the blocked Cholesky
NOT_ON_PCG = ("dense_eval_assemble_bs", "schur_prepare_s", "schur_qqt_partial",
              "schur_prepare", "chol_solve")


def phase_dense_pcg_solve(device):
    """The phase-4 problem (128c/100k/O=8, gauge fixed) with PCG: 10 LM
    iterations through the kernels (B without back-substitution only) and
    through the plain versions; cameras within the JAX package's PCG bound
    (tests/test_dense_ba.py: 5e-3), costs within rel 1e-3, the cost falling;
    B launched at least once an iteration and none of NOT_ON_PCG. Then ms
    per LM iteration of PCG and of the exact solve, in turns. Returns the
    kernel run's launch counts."""
    from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
    from bundleadjustment_tpu_torch.solvers.dense_ba import dense_ba_solve
    from bundleadjustment_tpu_torch.solvers.lm import LMConfig

    prob, cams, pts = synthetic_dense(128, 100_000, 6, 8, device, fix_gauge=True)
    cfg = LMConfig(max_iters=10, solver="pcg", pcg_iters=PCG_ITERS)
    counts = solve_both_ways("dense_pcg_solve", prob, cams, pts,
                             {"K": 128, "L": 100_000, "pcg_iters": PCG_ITERS},
                             cfg=cfg, cam_atol=5e-3)
    pcg = dict(solver="pcg", pcg_iters=PCG_ITERS)
    ms = [lm_iteration_ms(prob, cams, pts, dk.KERNEL_OPS, **lm)
          for lm in ({}, pcg, pcg, {})]
    # where one PCG LM iteration's time goes (with the seed eval)
    one = lambda: dense_ba_solve(prob, cams, pts, LMConfig(max_iters=1, **pcg))  # noqa: E731
    O = int(prob.cam_idx.shape[1])
    emit({"phase": "dense_pcg_vs_exact", "K": 128, "L": 100_000, "O": O,
          "pcg_iters": PCG_ITERS, "lm_iteration_ms_exact": [ms[0], ms[3]],
          "lm_iteration_ms_pcg": [ms[1], ms[2]],
          "roofline_exact": solve_roofline(min(ms[0], ms[3]), prob),
          "roofline_pcg": solve_roofline(min(ms[1], ms[2]), prob, "pcg", PCG_ITERS),
          "pcg_one_iteration_profile": device_breakdown(one)})
    wrong = {n: counts[n] for n in NOT_ON_PCG if counts[n]}
    if counts["dense_eval_assemble"] < cfg.max_iters or wrong:
        raise AssertionError(f"the PCG solve launched B {counts['dense_eval_assemble']}"
                             f" times (< {cfg.max_iters}) or other kernels: {wrong}")
    return counts


def phase_flat_sharded_pcg(device, n_cams=64, n_pts=10_000):
    """The flat landmark-sharded engine (`parallel/sharded_ba.py`, PCG) in an
    NCCL group of one against the single-device flat `ba_solve(solver=
    "pcg")` on the card (make_synthetic_scene, camera 0 and the two most
    observed cameras fixed): cost0 within rel 1e-4, cameras within 5e-3
    (tests/test_sharded_ba.py's bounds), and exactly 1 + 10 x
    all_reduces_per_iter(PCG_ITERS) all-reduces of the predicted bytes.
    Then `measure_scaling` at world size 1 on the same group."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch.data.synthetic import make_synthetic_scene
    from bundleadjustment_tpu_torch.parallel import multihost
    from bundleadjustment_tpu_torch.parallel import sharded_ba as sb
    from bundleadjustment_tpu_torch.parallel.scaling import measure_scaling
    from bundleadjustment_tpu_torch.solvers.lm import LMConfig, ba_solve
    from bundleadjustment_tpu_torch.solvers.residuals import BAProblem

    sc = make_synthetic_scene(n_cams=n_cams, n_pts=n_pts, obs_per_pt=6,
                              pixel_noise=0.5, seed=0)
    cf = np.zeros(n_cams, bool)
    cf[0] = True
    gauge = np.argsort(-np.bincount(sc.cam_idx[sc.valid], minlength=n_cams),
                       kind="stable")[:2]
    cf[gauge] = True
    sc.extr_init[gauge] = sc.extr_gt[gauge]
    cfg = LMConfig(max_iters=10, solver="pcg", pcg_iters=PCG_ITERS)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    flat = BAProblem(K4=t(sc.K4), cam_idx=t(sc.cam_idx).long(),
                     pt_idx=t(sc.pt_idx).long(), uv=t(sc.uv), sigma2=t(sc.sigma2),
                     valid=t(sc.valid), cam_fixed=t(cf),
                     pt_fixed=torch.zeros(n_pts, dtype=torch.bool, device=device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cams_1, _, info_1 = ba_solve(flat, t(sc.extr_init), t(sc.points_init), cfg)
    torch.cuda.synchronize()
    wall_1 = time.perf_counter() - t0
    prob, _, _ = sb.shard_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                  sc.valid, cf, sc.points_init, 1, 0, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        backend = multihost.init_process_group(0, 1, os.path.join(tmp, "rdv"),
                                               "cuda")
        try:
            group = multihost.default_group()
            sb.sharded_ba_solve(prob, t(sc.extr_init), LMConfig(max_iters=1),
                                group)  # NCCL builds its communicator here
            before = dict(multihost.COLLECTIVES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cams_s, _, info_s = sb.sharded_ba_solve(prob, t(sc.extr_init), cfg, group)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            n_red = multihost.COLLECTIVES["all_reduce"] - before["all_reduce"]
            n_bytes = (multihost.COLLECTIVES["all_reduce_bytes"]
                       - before["all_reduce_bytes"])
            scaling = measure_scaling(n_landmarks=n_pts, n_cams=n_cams,
                                      obs_per_pt=6, device_counts=[1],
                                      lm_iters=5, pcg_iters=PCG_ITERS,
                                      repeats=2, layout="flat", solver="pcg",
                                      device=device)
        finally:
            multihost.destroy_process_group()
    want_red = 1 + cfg.max_iters * sb.all_reduces_per_iter(PCG_ITERS)
    want_bytes = 4 + cfg.max_iters * sb.all_reduce_bytes_per_iter(n_cams, PCG_ITERS)
    cost0 = (float(info_s["cost0"]), float(info_1["cost0"]))
    cam_err = max_abs(cams_s, cams_1)
    emit({"phase": "flat_sharded_pcg", "backend": backend, "world_size": 1,
          "K": n_cams, "L": n_pts, "n_obs": int(sc.valid.sum()),
          "pcg_iters": PCG_ITERS, "iters": cfg.max_iters, "cost0": cost0,
          "cost": (float(info_s["cost"]), float(info_1["cost"])),
          "cams_max_abs_diff": cam_err, "all_reduces": n_red,
          "all_reduces_expected": want_red, "all_reduce_bytes": n_bytes,
          "all_reduce_bytes_expected": want_bytes, "wall_s_sharded": wall_s,
          "wall_s_single": wall_1, "measure_scaling": scaling})
    if backend != "nccl" or n_red != want_red or n_bytes != want_bytes:
        raise AssertionError(f"flat sharded PCG: {backend}, {n_red} all-reduces "
                             f"({want_red} expected), {n_bytes} bytes "
                             f"({want_bytes} expected)")
    if not (abs(cost0[0] - cost0[1]) <= 1e-4 * abs(cost0[1]) and cam_err < 5e-3
            and float(info_s["cost"]) < cost0[0]):
        raise AssertionError("the flat sharded PCG solve and the single-device "
                             "solve disagree, or the cost did not fall")


def phase_two_view(device):
    """The two-view estimators' batched SVDs on the card and on the CPU (800
    pairs of a two-view scene, 256 hypotheses), and one whole
    `recover_pose_two_view` on each, fed the same samples: the verdict
    flags must be equal and rt6 within 1e-3 (the bound the CPU parity test
    holds the port to against the JAX package)."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch.geometry import epipolar as ep
    from bundleadjustment_tpu_torch.geometry.np_se3 import aa_to_R

    rng = np.random.default_rng(5)
    n = 800
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], size=(n, 3))
    rt = np.array([0.01, -0.08, 0.02, 0.4, 0.05, -0.1])
    K4 = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
    X2 = X @ aa_to_R(rt[:3]).T + rt[3:]
    proj = lambda P: np.stack([525 * P[:, 0] / P[:, 2] + 319.5,
                               525 * P[:, 1] / P[:, 2] + 239.5], -1)
    uv1 = (proj(X) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    uv2 = (proj(X2) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    uv2[:40] += rng.uniform(30, 120, (40, 2)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    valid = torch.ones(n, dtype=torch.bool)
    idx_e = ep.sample_indices(gen, valid, 256, 8)
    idx_h = ep.sample_indices(gen, valid, 256, 4)

    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    out, results = {}, {}
    for label, dev in (("cuda", device), ("cpu", torch.device("cpu"))):
        a1, a2 = torch.from_numpy(uv1).to(dev), torch.from_numpy(uv2).to(dev)
        k4, v = torch.from_numpy(K4).to(dev), valid.to(dev)
        ie, ih = idx_e.to(dev), idx_h.to(dev)
        x1, x2 = ep._pixels_to_normalized(a1, k4), ep._pixels_to_normalized(a2, k4)
        R4 = torch.eye(3, device=dev).expand(4, 3, 3).contiguous()
        t4 = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], device=dev)
        out[label] = {
            "eight_point_256x8x9_ms": host_ms(lambda: ep._eight_point(x1[ie], x2[ie])),
            "four_point_256x8x9_ms": host_ms(lambda: ep._four_point_h(x1[ih], x2[ih])),
            "triangulate_4x800x4x4_ms": host_ms(
                lambda: ep._triangulate_cheirality(R4, t4, x1, x2, v)),
            "triangulate_8x800x4x4_ms": host_ms(
                lambda: ep._triangulate_cheirality(torch.cat([R4, R4]),
                                                   torch.cat([t4, -t4]), x1, x2, v)),
            "recover_pose_two_view_ms": host_ms(
                lambda: ep.recover_pose_two_view(None, a1, a2, v, k4, idx_e=ie,
                                                 idx_h=ih))}
        results[label] = ep.recover_pose_two_view(None, a1, a2, v, k4, idx_e=ie,
                                                  idx_h=ih)
    g, c = results["cuda"], results["cpu"]
    rt_err = max_abs(g.rt6.cpu(), c.rt6)
    emit({"phase": "two_view", "pairs": n, "n_hyp": 256, **out,
          "used_homography": bool(g.used_homography), "ok": bool(g.ok),
          "n_inliers_cuda": int(g.n_inliers), "n_inliers_cpu": int(c.n_inliers),
          "rt6_cuda_vs_cpu_max_abs": rt_err,
          "rt6_vs_truth_max_abs_rot": float(np.abs(g.rt6.cpu().numpy()[:3] - rt[:3]).max())})
    if not (bool(g.ok) and bool(c.ok) and not bool(g.used_homography)
            and not bool(c.used_homography) and rt_err < 1e-3
            and abs(int(g.n_inliers) - int(c.n_inliers)) <= 8):
        raise AssertionError("recover_pose_two_view: the card and the CPU disagree")


# The monocular sequence: the forward trajectory and hole-free depth of the
# JAX package's standard-init golden (tests/test_layered_scene.py, there
# 320x240 at fx = 260), at this smoke's width. fx / width is the same (0.82),
# so the golden's step of 0.22 per frame gives the same parallax in relative
# terms, twice as many pixels. A failed bootstrap makes the current frame
# the new reference, so the baseline never grows past one step: the step
# itself has to carry the parallax, and 0.22 initialises at the first pair.
STANDARD_SEQUENCE = dict(motion_step=0.22, seed=4, hole_frac=0.0)
# ATE bound (Horn with scale) of the standard-init run: the JAX package's
# own CLI on the CPU on this very sequence (20 frames, same flags,
# --track-batch 1) gave ATE_JAX_CPU_M (scale 0.2226, keyframes at frames 16
# and 19, 445 landmarks; the port on the CPU: 0.03741 with the same
# keyframes and landmarks); the port on the card is held to twice that. The
# golden's own bound (0.018 at 320x240, 8 frames) is another sequence's.
ATE_JAX_CPU_M = 0.0374
ATE_STANDARD_BOUND_M = 0.075


def write_sequence(root, n_frames, extra=0, **render):
    """Render a sequence of n_frames + extra frames (default: the
    config-1-shaped one; the scene's extent follows the frame count) and
    write its first n_frames in TUM format with an intrinsics.json sidecar.
    Returns (frames, K4), frames holding the `extra` frames too."""
    from bundleadjustment_tpu_torch.data.synthetic import (
        render_layered_scene,
        write_tum_format,
    )

    render = render or dict(motion_step=0.03, seed=11)
    frames, K4 = render_layered_scene(
        n_frames=n_frames + extra, width=640, height=480, fx=525.0, fy=525.0,
        trajectory="forward", **render)
    write_tum_format(root, frames[:n_frames])
    with open(os.path.join(root, "intrinsics.json"), "w") as f:
        json.dump({"fx": float(K4[0]), "fy": float(K4[1]), "cx": float(K4[2]),
                   "cy": float(K4[3]), "width": 640, "height": 480}, f)
    return frames, K4


def pipeline_argv(data, out, n_frames, device, flags=()):
    """The smoke's CLI arguments: the default configuration with local BA."""
    return ["--dataset-name", "synthetic", "--dataset-path", data,
            "--output-path", out, "--frames", str(n_frames), "--local-ba",
            "--trajectory", "--device", str(device), *flags]


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_pipeline(device, data, n_frames, phase="pipeline", flags=(),
                   name="gtdepth_ba", ate_bound=0.05, outputs=None):
    """Run the port's CLI end to end on the sequence in `data`; returns
    (pipeline, results with "wall_s", launch counts of this run). `name` is
    the init type and estimation in the output prefix; every frame must be
    tracked and the ATE (Horn with scale) stay under `ate_bound`.
    `outputs(out_dir, prefix, results)`, if given, checks the run's further
    output files before they are deleted and returns what to print."""
    from bundleadjustment_tpu_torch import cli, kernels

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        argv = pipeline_argv(data, out, n_frames, device, flags)
        sync(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        pipe, res = cli.run_cli(argv)
        sync(device)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        prefix = os.path.join(out, f"synthetic_{name}_localba_f{n_frames}")
        outputs_exist = [os.path.exists(prefix + s) for s in
                         ("_estimatedPoses.txt", "_mesh.off", "_results.json")]
        extra = {} if outputs is None else outputs(out, prefix, res)
    res = dict(res, wall_s=wall)
    emit({"phase": phase, "flags": list(flags), "frames": res["frames"],
          "ate_rmse_m": res.get("ate_rmse"), "keyframes": res["keyframes"],
          "keyframes_final": res["n_keyframes_final"],
          "landmarks": res["n_map_points"], "wall_s": wall,
          "frames_per_s": res["frames"] / wall, "launches": counts,
          "tracking_failures": res["tracking_failures"],
          "ate_scale": res.get("ate_scale"), "ate_bound_m": ate_bound,
          "ba_engines": sorted(set(e for _, e in pipe.ba_solves)),
          "ba_first_two": pipe.ba_solves[:2], "ba_last": pipe.ba_solves[-1:],
          "phase_times": res["phase_times"], "outputs_exist": outputs_exist,
          **extra})
    if not (res.get("ate_rmse") is not None and res["ate_rmse"] < ate_bound):
        raise AssertionError(f"{phase} ATE {res.get('ate_rmse')} >= {ate_bound} m")
    if res["frames"] != n_frames or res["tracking_failures"] or not pipe.initialized:
        raise AssertionError(f"{phase}: not every frame was tracked: {res}")
    if not all(outputs_exist):
        raise AssertionError(f"{phase} output files missing")
    return pipe, res, counts


def phase_pipeline_per_frame(device, data, n_frames, res_default, runs):
    """The default CLI run again with `--track-batch 1` (one frame at a
    time): ATE < 0.05 m, and the default microbatched run's ATE within
    0.01 m of it; both runs' frames/s."""
    _, res, runs["pipeline_track_batch_1"] = phase_pipeline(
        device, data, n_frames, "pipeline_track_batch_1", ("--track-batch", "1"))
    diff = abs(res_default["ate_rmse"] - res["ate_rmse"])
    emit({"phase": "track_batch_vs_per_frame", "track_batch": 8,
          "frames_per_s_batched": res_default["frames"] / res_default["wall_s"],
          "frames_per_s_per_frame": res["frames"] / res["wall_s"],
          "ate_batched_m": res_default["ate_rmse"], "ate_per_frame_m": res["ate_rmse"],
          "ate_abs_diff_m": diff, "bound_m": 0.01,
          "keyframes_batched": res_default["keyframes"],
          "keyframes_per_frame": res["keyframes"],
          "frontend_ms_batched": res_default["phase_times"].get("frontend"),
          "frontend_ms_per_frame": res["phase_times"].get("frontend")})
    if not diff < 0.01:
        raise AssertionError(f"batched ATE {res_default['ate_rmse']} m against "
                             f"{res['ate_rmse']} m one frame at a time")


def phase_track_batch_step(pipe, device, next_frames, runs):
    """One microbatch of TRACK_BATCH frames at the config-1 width (640x480,
    1000 features, 8 levels) on the default run's map: the next frames of
    its sequence (`next_frames`) through `track_batch_step` from
    `_batch_inputs`. The step
    runs under `torch.cuda.set_sync_debug_mode("error")` (no host sync
    between the upload and the fetch), launches kernel A 1 + B times (the B
    frame-to-frame matches in one launch, then the local-map match of each
    frame), and its 15 outputs equal those of the same step with kernel A's
    plain version on the card, bit for bit. Prints the snapshot's size,
    the step's ms a batch and a frame (CUDA events), and a profiled step's
    wall and device ms, kernel launches and busy share
    (`device_breakdown`)."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch import kernels
    from bundleadjustment_tpu_torch.ops import hamming, matching
    from bundleadjustment_tpu_torch.pipeline.driver import track_batch_step

    grays = [f["gray"] for f in next_frames]
    if len(grays) != TRACK_BATCH or not pipe._can_batch_track():
        raise AssertionError("the default run's pipeline cannot take a microbatch")
    snap_ids, args, kw = pipe._batch_inputs(grays)
    step = lambda: track_batch_step(*args, **kw)  # noqa: E731
    step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    runs["track_batch_step"] = kernels.launch_counts()
    launches = runs["track_batch_step"]["hamming_top2"]
    matching.hamming_top2 = hamming.hamming_top2_plain
    try:
        ref = step()
        plain_ms = cuda_time(step, reps=1, warmup=0)
    finally:
        matching.hamming_top2 = hamming.hamming_top2
    names = ("xy", "octave", "sigma2", "desc", "valid", "idx", "dist", "ok", "inl",
             "rt", "hit", "idx2", "inl2", "rt2", "use2")
    differ = [n for n, g, r in zip(names, got, ref) if not torch.equal(g, r)]
    ms = cuda_time(step, reps=2, warmup=0)
    prof = device_breakdown(step, top=5)
    B, M, N = len(grays), int(args[1].shape[0]), len(snap_ids)
    emit({"phase": "track_batch_step", "batch": B, "keypoints": M,
          "snapshot_landmarks": N, "first_pass_shape": [B, M, B, M],
          "local_map_shape": [N, M], "sync_debug": "error",
          "kernel_a_launches": launches, "kernel_a_launches_expected": 1 + B,
          "outputs_differ_from_plain": differ,
          "hits": got[10].sum(1).tolist(), "use2": got[14].tolist(),
          "tracked_ok": got[7].sum(1).tolist(), "ms": ms, "plain_ms": plain_ms,
          "ms_per_frame": ms / B,
          # one profiled step: every kernel the card ran, and its busy share
          "profile": {**prof, "launches_per_frame": prof["launches"] / B,
                      "busy_share": prof["device_ms"] / prof["wall_ms"]}})
    if launches != 1 + B or differ or not np.isfinite(got[9].cpu().numpy()).all():
        raise AssertionError(f"track_batch_step: {launches} kernel A launches "
                             f"(want {1 + B}), outputs that differ: {differ}")


def phase_pipeline_sharded(device, data, n_frames, ate_default):
    """The CLI with --global-ba sharded inside an NCCL process group of
    world size 1; ATE within 0.001 m of the default run, and the solve's
    all-reduces and gathers counted. NCCL makes its communicator at the
    first collective: that one (a 1-float all-reduce) is timed on its own
    before the run. Returns the run's launch counts."""
    import torch
    import torch.distributed as dist

    from bundleadjustment_tpu_torch.parallel import multihost
    from bundleadjustment_tpu_torch.parallel.sharded_dense_ba import COLLECTIVES

    with tempfile.TemporaryDirectory() as tmp:
        backend = multihost.init_process_group(
            0, 1, os.path.join(tmp, "rendezvous"), "cuda")
        try:
            t0 = time.perf_counter()
            dist.all_reduce(torch.ones(1, device=device))
            torch.cuda.synchronize()
            first_collective_s = time.perf_counter() - t0
            for k in COLLECTIVES:
                COLLECTIVES[k] = 0
            _, res, counts = phase_pipeline(device, data, n_frames,
                                            "pipeline_sharded",
                                            ("--global-ba", "sharded"))
            collectives = dict(COLLECTIVES)
        finally:
            multihost.destroy_process_group()
    diff = abs(res["ate_rmse"] - ate_default)
    emit({"phase": "pipeline_sharded_vs_default", "backend": backend,
          "world_size": 1, "first_collective_s": first_collective_s,
          "collectives": collectives, "ate_default_m": ate_default,
          "ate_sharded_m": res["ate_rmse"], "ate_abs_diff_m": diff})
    if backend != "nccl" or not all(collectives.values()):
        raise AssertionError(f"the sharded run issued no NCCL collectives: "
                             f"{backend} {collectives}")
    if not diff < 1e-3:
        raise AssertionError(f"sharded pipeline ATE differs from the default run "
                             f"by {diff} m")
    return counts


def phase_pipeline_monocular(device, data, tmp, runs):
    """The monocular configurations through the CLI: pnp and E/H tracking on
    20 frames of the gtdepth sequence in `data`, and the standard two-view
    bootstrap on its own sequence (STANDARD_SEQUENCE), with the default BA
    layout (the engine follows the observation count: reported, not forced)
    and again with --ba-layout dense_landmark (kernels B and C on a
    monocular map). The launch counts of each run go into `runs`."""
    n = 20
    # E/H tracking chains two-view poses with a constant-velocity scale: the
    # JAX package's own test of it holds its ATE to 0.12 m, not to 0.05
    for est, bound_m in (("pnp", 0.05), ("essential_or_homography", 0.12)):
        _, _, runs[f"pipeline_{est}"] = phase_pipeline(
            device, data, n, f"pipeline_{est}", ("--estimation", est),
            name=f"gtdepth_{est}", ate_bound=bound_m)
    seq = os.path.join(tmp, "seq_standard")
    write_sequence(seq, n, **STANDARD_SEQUENCE)
    ates = {}
    for phase, flags in (("pipeline_standard", ()),
                         ("pipeline_standard_dense", ("--ba-layout", "dense_landmark"))):
        pipe, res, runs[phase] = phase_pipeline(
            device, seq, n, phase, ("--init-type", "standard", *flags),
            name="standard_ba", ate_bound=ATE_STANDARD_BOUND_M)
        ates[phase] = res["ate_rmse"]
    emit({"phase": "pipeline_standard_bound", "ate_jax_cpu_m": ATE_JAX_CPU_M,
          "ate_bound_m": ATE_STANDARD_BOUND_M, **ates})


def phase_pipeline_solvers(device, data, n_frames, runs):
    """The slice's pipeline modes through the CLI on the 40-frame sequence:
    `--ba-solver pcg` (every BA by PCG: A and B) and `--global-ba windowed`
    (the final global BAs by windows + halo + pose graph); ATE < 0.05 m
    each, and the windowed run's window counts printed."""
    _, _, runs["pipeline_pcg"] = phase_pipeline(
        device, data, n_frames, "pipeline_pcg", ("--ba-solver", "pcg"))
    pipe, _, runs["pipeline_windowed"] = phase_pipeline(
        device, data, n_frames, "pipeline_windowed", ("--global-ba", "windowed"))
    emit({"phase": "pipeline_windowed_runs", "windowed_global_bas": [
        {k: r[k] for k in ("windows", "observations", "global_landmarks",
                           "pg_cost0", "pg_cost")} for r in pipe.windowed_runs]})
    if not pipe.windowed_runs or not all(r["windows"] >= 1 for r in pipe.windowed_runs):
        raise AssertionError("the windowed global BA did not run")


# config 7 of the JAX package's protocols (protocols.py:500-530, which
# imports jax, so its settings are repeated here): 640x480, 2,500 features,
# depth seeding at every keyframe, no guided local-map tracking
CONFIG7_FRAMES = 100
CONFIG7_RENDER = dict(width=640, height=480, fx=525.0, fy=525.0, trajectory="sweep",
                      motion_step=0.04, rot_step=0.01, seed=17)
CONFIG7_PIPELINE = dict(init_type="gtdepth", estimation="ba", local_ba=True,
                        n_features=2500, n_levels=8, keyframe_ratio=0.25,
                        depth_landmarks=True, depth_landmarks_max=2000,
                        track_local_map=False)
# the JAX package's TPU record of that map (BASELINE.md:679-686): counts of
# a 140-frame, 3,500-feature run, not timings
CONFIG7_TPU_MAP = {"keyframes": 71, "landmarks_in_solve": 10_842,
                   "observations": 156_774, "O": 72}


def phase_pipeline_depth_seeded(device, n_frames=CONFIG7_FRAMES):
    """The config-7 protocol's run: render, process every frame, finalize;
    ATE < 0.05 m. Prints the map finalize solved (keyframes, active
    landmarks, landmarks and observations in the solve, the longest track
    O and the Schur route it takes) beside the TPU record's counts, the
    launches of A, B, C and D, and the seconds spent seeding. Then times
    kernel C against route (c) on the final system (evidence for the
    S_KERNEL_MAX_O gate only). Returns the run's launch counts."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch import kernels
    from bundleadjustment_tpu_torch.data.synthetic import render_layered_scene
    from bundleadjustment_tpu_torch.data.tum import FrameData
    from bundleadjustment_tpu_torch.metrics.ate import evaluate_ate
    from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
    from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline
    from bundleadjustment_tpu_torch.solvers.dense_ba import (
        densify_problem_auto,
        schur_route,
    )

    frames, _ = render_layered_scene(n_frames=n_frames, **CONFIG7_RENDER)
    K4 = np.array([525.0, 525.0, (640 - 1) / 2.0, (480 - 1) / 2.0], np.float32)
    pipe = BundleAdjustmentPipeline(PipelineConfig(**CONFIG7_PIPELINE), K4, 640,
                                    480, device=device)
    seed_s = [0.0]
    for name in ("_seed_depth_landmarks", "_densify_pending_seeds"):
        fn = getattr(pipe, name)

        def timed(*a, _fn=fn):
            t0 = time.perf_counter()
            out = _fn(*a)
            seed_s[0] += time.perf_counter() - t0
            return out

        setattr(pipe, name, timed)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    statuses = [pipe.process_frame(FrameData(
        index=i, timestamp=f["timestamp"], gray=f["gray"], depth=f["depth"],
        rgb=None, gt_cam_to_world=f["gt_cam_to_world"]))
        for i, f in enumerate(frames)]
    torch.cuda.synchronize()
    frames_s = time.perf_counter() - t0
    m = pipe.map
    kfs = m.active_keyframes().tolist()
    snap = m.snapshot_problem(kfs, min_obs=2)
    prob, _, O = densify_problem_auto(
        snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2, snap.valid,
        snap.cam_fixed, snap.points.shape[0], max_obs=pipe.cfg.ba_max_obs_per_pt,
        device=device)
    solved = {"keyframes": len(kfs), "landmarks_active": int(len(m.active_points())),
              "landmarks_in_solve": int(snap.n_pts),
              "observations": int(np.asarray(snap.valid).sum()), "O": O,
              "route": schur_route(O)}
    t1 = time.perf_counter()
    pipe.finalize()
    torch.cuda.synchronize()
    finalize_s = time.perf_counter() - t1
    counts = kernels.launch_counts()
    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    ate = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)["rmse"]
    # C against route (c) on the final map's system
    snap = m.snapshot_problem(m.active_keyframes().tolist(), min_obs=2)
    prob, _, O_final = densify_problem_auto(
        snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2, snap.valid,
        snap.cam_fixed, snap.points.shape[0], max_obs=pipe.cfg.ba_max_obs_per_pt,
        device=device)
    routes = routes_on(prob, pipe._t(snap.extr), pipe._t(snap.points))
    lost = [s for s in statuses[2:] if s not in ("tracked", "keyframe")]
    emit({"phase": "pipeline_depth_seeded", "frames": n_frames,
          "render": CONFIG7_RENDER, "pipeline": CONFIG7_PIPELINE,
          "statuses": {k: statuses.count(k) for k in sorted(set(statuses))},
          "ate_rmse_m": ate, "ate_bound_m": 0.05, "map_finalize_solved": solved,
          "tpu_record_map": CONFIG7_TPU_MAP,
          "ba_engines": sorted(set(e for _, e in pipe.ba_solves)),
          "launches": counts, "frames_s": frames_s, "finalize_s": finalize_s,
          "depth_seeding_s": seed_s[0], "phase_times": pipe.timers.report(),
          "final_system": {"K": int(snap.n_cams), "L": int(snap.n_pts),
                           "O": O_final, **routes}})
    if not (ate < 0.05 and pipe.initialized and not lost):
        raise AssertionError(f"depth-seeded run: ATE {ate} m (bound 0.05) or "
                             f"frames lost: {statuses}")
    # config 7's measurement on this map: the marginal ms of a dense LM
    # iteration (bench/protocols.ba_marginal: 8 / 24 / 48 / 72 iterations,
    # best of 2 each, a least-squares line) with its roofline
    from bundleadjustment_tpu_torch.bench.protocols import ba_marginal

    marginal = ba_marginal(pipe, device)
    emit({"phase": "depth_seeded_ba_marginal", **marginal})
    if not (marginal["ba_marginal_ms"] > 0
            and 0 < marginal["ba_marginal_port_bound_share"] <= 1):
        raise AssertionError(f"config-7 marginal fit failed: {marginal}")
    return counts


def phase_pipeline_predetect(device, data, frames, n_frames, res_default, runs):
    """The CLI with --predetect (32 frames a detection pass); then detection
    ms a frame, batched (B = 32) against per-frame, and how far batched and
    per-frame detection differ on the card over every frame."""
    import numpy as np
    import torch

    from bundleadjustment_tpu_torch.ops.features import detect_and_describe, detect_batch

    pipe, res, runs["pipeline_predetect"] = phase_pipeline(
        device, data, n_frames, "pipeline_predetect", ("--predetect",))
    cfg = pipe.feat_cfg
    imgs = torch.from_numpy(np.stack([f["gray"] for f in frames]).astype(np.float32))
    imgs = imgs.to(device)
    B = min(32, len(frames))
    batched_ms = cuda_time(lambda: detect_batch(imgs[:B], cfg), reps=3, warmup=1) / B
    single_ms = cuda_time(lambda: [detect_and_describe(imgs[i], cfg) for i in range(B)],
                          reps=3, warmup=1) / B
    valid_diff = desc_diff = 0
    xy_diff = 0.0
    for s in range(0, len(frames), 32):
        batch = detect_batch(imgs[s:s + 32], cfg)
        for i in range(batch.xy.shape[0]):
            one = detect_and_describe(imgs[s + i], cfg)
            both = batch.valid[i] & one.valid
            valid_diff += int((batch.valid[i] != one.valid).sum())
            desc_diff += int((batch.desc[i] != one.desc).any(1)[both].sum())
            if bool(both.any()):
                xy_diff = max(xy_diff, float((batch.xy[i] - one.xy).abs()[both].max()))
    from bundleadjustment_tpu_torch.utils.flops import frontend_fields

    emit({"phase": "predetect_detection", "batch": B, "frames": len(frames),
          "batched_ms_per_frame": batched_ms, "per_frame_ms": single_ms,
          **frontend_fields(batched_ms, 480, 640, device, cfg.n_features,
                            cfg.n_levels, cfg.scale_factor, prefix="batched_"),
          "keypoints_per_frame": int(batch.valid.shape[1]),
          "valid_differ": valid_diff, "desc_differ": desc_diff,
          "max_abs_xy_diff_px": xy_diff,
          "frames_per_s": res["frames"] / res["wall_s"],
          "frames_per_s_default": res_default["frames"] / res_default["wall_s"],
          "ate_rmse_m": res["ate_rmse"], "ate_default_m": res_default["ate_rmse"],
          "keyframes": res["keyframes"], "keyframes_default": res_default["keyframes"]})


def ply_faces(path):
    """Face count in the header of an OFF file."""
    with open(path) as f:
        f.readline()
        return int(f.readline().split()[1])


def gt_cloud(frames, K4, device, every=4, stride=2):
    """World-frame ground-truth cloud: `backproject_depth` of every
    `every`-th frame at `stride`, valid pixels only."""
    import numpy as np

    from bundleadjustment_tpu_torch.vis.pointcloud import backproject_depth

    parts = []
    for f in frames[::every]:
        pts, ok = backproject_depth(K4, f["depth"], f["gt_cam_to_world"],
                                    stride=stride, device=device)
        parts.append(pts[ok])
    return np.concatenate(parts)


def phase_pipeline_outputs(device, data, frames, K4, n_frames, tmp, runs):
    """The CLI with --reconstruction-error, --faces-type poisson and
    --display-pointcloud on the sequence; checks the error, the PLYs and the
    Poisson faces."""
    from bundleadjustment_tpu_torch.vis.mesh import read_ply_vertices, write_ply

    gt = gt_cloud(frames, K4, device)
    gt_path = os.path.join(tmp, "gt_cloud.ply")
    write_ply(gt_path, gt)

    checked = {}

    def outputs(out, prefix, res):
        plys = {s: os.path.exists(f"{prefix}_{s}.ply") for s in
                ("gt_cloud", "estimated_cloud", "combined_colored_cloud", "cloud")}
        cloud = (len(read_ply_vertices(prefix + "_cloud.ply")) if plys["cloud"]
                 else None)
        checked.update({
            "gt_points": len(gt), "plys": plys,
            "map_final": os.path.exists(os.path.join(out, "map_final.ply")),
            "mesh_faces": ply_faces(prefix + "_mesh.off"),
            "glyph_faces": 4 * res["n_keyframes_final"], "cloud_points": cloud,
            "reconstruction_error": res.get("reconstruction_error")})
        return checked

    _, res, runs["pipeline_outputs"] = phase_pipeline(
        device, data, n_frames, "pipeline_outputs",
        ("--reconstruction-error", gt_path, "--faces-type", "poisson",
         "--display-pointcloud"), outputs=outputs)
    err = checked["reconstruction_error"]
    if not (err is not None and 0 <= err < 0.05):
        raise AssertionError(f"reconstruction error {err} (bound 0.05)")
    if not (all(checked["plys"].values()) and checked["map_final"]
            and checked["cloud_points"] == res["n_map_points"]):
        raise AssertionError(f"output files missing: {checked}")
    if not checked["mesh_faces"] > checked["glyph_faces"]:
        raise AssertionError(f"the mesh has no Poisson faces: {checked}")


def run_frames(pipe, frames):
    return [pipe.process_frame(f) for f in frames]


def phase_checkpoint_resume(device, data, n_frames, res_default, tmp, cut=20):
    """The default configuration on the sequence, cut after `cut` frames:
    save, load onto the card, finish, finalize; every frame tracked, ATE <
    0.05 m and within max(0.6 ATE, 0.01 m) of phase 8's run. Then the
    config-7 depth-seeded settings for 6 frames keep their pending seeds
    across a save / load."""
    import numpy as np

    from bundleadjustment_tpu_torch import cli
    from bundleadjustment_tpu_torch.data.synthetic import render_layered_scene
    from bundleadjustment_tpu_torch.data.tum import FrameData
    from bundleadjustment_tpu_torch.metrics.ate import evaluate_ate
    from bundleadjustment_tpu_torch.pipeline.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
    from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline

    args = cli.build_parser().parse_args(
        pipeline_argv(data, os.path.join(tmp, "ckpt_out"), n_frames, device))
    cfg = cli.config_from_args(args)
    ds = cli.load_dataset(args)
    frames = [ds[i] for i in range(len(ds))]
    t0 = time.perf_counter()
    pipe = BundleAdjustmentPipeline(cfg, ds.K4, ds.width, ds.height, device=device)
    statuses = run_frames(pipe, frames[:cut])
    path = os.path.join(tmp, "state.npz")
    t1 = time.perf_counter()
    save_checkpoint(path, pipe)
    t2 = time.perf_counter()
    pipe = load_checkpoint(path, cfg, device=device)
    t3 = time.perf_counter()
    statuses += run_frames(pipe, frames[cut:])
    pipe.finalize()
    sync(device)
    wall = time.perf_counter() - t0
    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f.timestamp for f in frames])
    gt_xyz = np.array([f.gt_cam_to_world[:3, 3] for f in frames])
    ate = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz, max_difference=0.05)["rmse"]
    ate0 = res_default["ate_rmse"]
    # the depth-seeded variant: the config-7 settings on their own scene
    seeded, _ = render_layered_scene(n_frames=6, **CONFIG7_RENDER)
    K4 = np.array([525.0, 525.0, (640 - 1) / 2.0, (480 - 1) / 2.0], np.float32)
    fd = [FrameData(index=i, timestamp=f["timestamp"], gray=f["gray"],
                    depth=f["depth"], rgb=None, gt_cam_to_world=f["gt_cam_to_world"])
          for i, f in enumerate(seeded)]
    cfg7 = PipelineConfig(**CONFIG7_PIPELINE)
    p7 = BundleAdjustmentPipeline(cfg7, K4, 640, 480, device=device)
    s7 = run_frames(p7, fd[:4])
    save_checkpoint(os.path.join(tmp, "seeded.npz"), p7)
    r7 = load_checkpoint(os.path.join(tmp, "seeded.npz"), cfg7, device=device)
    kept = r7._pending_seeds == p7._pending_seeds
    s7 += run_frames(r7, fd[4:])
    emit({"phase": "checkpoint_resume", "cut": cut, "frames": len(statuses),
          "statuses": {k: statuses.count(k) for k in sorted(set(statuses))},
          "ate_rmse_m": ate, "ate_default_m": ate0,
          "ate_abs_diff_m": abs(ate - ate0), "bound_m": max(0.6 * ate0, 0.01),
          "wall_s": wall, "save_s": t2 - t1, "load_s": t3 - t2,
          "file_bytes": os.path.getsize(path), "resumed_on": str(pipe.device),
          "seeded_statuses": s7, "pending_seeds_saved": len(p7._pending_seeds),
          "pending_seeds_kept": kept})
    lost = [s for s in statuses[2:] if s not in ("tracked", "keyframe")]
    if len(statuses) != n_frames or lost or not pipe.initialized:
        raise AssertionError(f"checkpoint resume: not every frame tracked: {statuses}")
    if not (ate < 0.05 and abs(ate - ate0) < max(0.6 * ate0, 0.01)):
        raise AssertionError(f"checkpoint resume: ATE {ate} m against {ate0} m")
    if not (p7._pending_seeds and kept):
        raise AssertionError("the pending depth seeds did not survive the resume")


def timed_host(fn, reps=3):
    """(least ms of `reps` calls by the host clock around synchronised
    calls after one warm-up, peak allocated bytes, the last result)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, torch.cuda.max_memory_allocated(), out


def phase_outputs_at_scale(device, frames, K4, n_map=10_000, n_cloud=100_000,
                           grids=(96, 128)):
    """icp_align of an n_map-point map onto an n_cloud-point cloud and
    poisson_reconstruct of the cloud at each grid: host ms, peak memory and
    two bounds. "bound_ms" is the least time of the nearest-neighbour
    search (`bound`): a fused distance-argmin reads the points once a pass
    and does NN_PAIR_OPS float32 operations a (point, point) pair.
    "blocks_bound_ms" is this design's: one write of every materialised
    distance block over HBM_BYTES_S."""
    import numpy as np

    from bundleadjustment_tpu_torch.metrics.reconstruction import icp_align
    from bundleadjustment_tpu_torch.vis.poisson import (
        estimate_normals,
        poisson_reconstruct,
    )

    rng = np.random.default_rng(7)
    cloud = gt_cloud(frames[:8], K4, device, every=4, stride=2)
    cloud = cloud[rng.permutation(len(cloud))[:n_cloud]].astype(np.float32)
    c, s = np.cos(0.02), np.sin(0.02)
    R0 = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    src = (cloud[:n_map] @ R0.T + [0.01, -0.005, 0.01]
           + rng.normal(scale=0.002, size=(n_map, 3))).astype(np.float32)
    iters = 30
    ms, peak, icp = timed_host(lambda: icp_align(src, cloud, iters, device=device))
    passes = iters + 1
    pairs = passes * len(src) * len(cloud)
    emit({"phase": "outputs_at_scale", "what": "icp_align", "N": len(src),
          "M": len(cloud), "iterations": iters, "ms": ms, "peak_bytes": peak,
          **bound(passes * (len(src) + len(cloud)) * 12, NN_PAIR_OPS * pairs),
          "blocks_bound_ms": pairs * 4 / HBM_BYTES_S * 1e3,
          "n_corr": icp["n_corr"], "fitness": icp["fitness"],
          "rotation_residual": float(np.abs(icp["R"] @ R0 - np.eye(3)).max())})
    vps = np.stack([f["gt_cam_to_world"][:3, 3] for f in frames[:8:4]])
    nrm_ms, nrm_peak, _ = timed_host(
        lambda: estimate_normals(cloud, viewpoints=vps, device=device), reps=1)
    knn_pairs = len(cloud) * len(cloud)
    for grid in grids:
        ms, peak, (verts, faces) = timed_host(
            lambda: poisson_reconstruct(cloud, viewpoints=vps, grid=grid,
                                        device=device), reps=2)
        emit({"phase": "outputs_at_scale", "what": "poisson_reconstruct",
              "points": len(cloud), "grid": grid, "ms": ms, "peak_bytes": peak,
              "normals_ms": nrm_ms, "normals_peak_bytes": nrm_peak,
              **bound(len(cloud) * 12, NN_PAIR_OPS * knn_pairs),
              "blocks_bound_ms": knn_pairs * 4 / HBM_BYTES_S * 1e3,
              "verts": len(verts), "faces": len(faces)})
        if not len(faces):
            raise AssertionError(f"poisson_reconstruct at grid {grid}: no faces")
    if not (icp["n_corr"] > 0.9 * len(src) and np.isfinite(icp["fitness"])):
        raise AssertionError(f"icp_align at scale: {icp['n_corr']} correspondences")


def phase_pipeline_shapes(pipe, results):
    """Time the dense-BA kernels at the pipeline's own final global-BA shape
    (every active keyframe, landmarks with >= 2 observations)."""
    from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem_auto

    m = pipe.map
    snap = m.snapshot_problem(m.active_keyframes().tolist(), min_obs=2)
    prob, _, O = densify_problem_auto(
        snap.K4, snap.cam_idx, snap.pt_idx, snap.uv, snap.sigma2, snap.valid,
        snap.cam_fixed, snap.points.shape[0], device=pipe.device)
    res = compare_dense_kernels(prob, pipe._t(snap.extr), pipe._t(snap.points),
                                "pipeline_final_ba")
    emit({"phase": "kernel", "shape": "pipeline_final_ba",
          "K": int(snap.extr.shape[0]), "L": int(snap.points.shape[0]), "O": O,
          "n_obs": int(snap.valid.sum()), **res})
    for name, r in res.items():
        results[name]["shapes"]["pipeline_final_ba"] = r


def phase_protocol_config1(device):
    """The port's protocol runner at full size: `bench/protocols.config1`
    (50 frames 640x480 forward, seed 11, 1000 features, 8 levels, no local
    BA, the 3 x 100 final BA, microbatches of TRACK_BATCH frames) on the
    card; its JSON line, ATE < 0.05 m (the JAX package's protocol bound).
    Returns the run's launch counts."""
    from bundleadjustment_tpu_torch.bench import protocols

    # run_protocol zeroes the launch counts just before the frames and
    # reads them just after finalize
    out = protocols.config1(track_batch=TRACK_BATCH, device=device)
    emit({"phase": "protocol_config1", **out, "ate_bound_m": 0.05})
    if not out["ate_rmse_m"] < 0.05:
        raise AssertionError(f"config 1: ATE {out['ate_rmse_m']} m >= 0.05")
    return out["launches"]


def phase_protocol_resume_worker(device, n_frames=40, cut=20):
    """The protocol runner's fresh-process resume (`bench/protocols.
    checkpoint_resume`, the core of protocol 6r) on the smoke's 40-frame
    sequence with the CLI's default configuration and local BA: `cut`
    frames here, a checkpoint, the uninterrupted rest here; the checkpoint
    resumed by `python -m bundleadjustment_tpu_torch.bench.protocols
    --resume-worker` on the card. |ATE difference| <= max(0.6 ATE, 0.01 m)
    (tests/test_checkpoint_protocol.py), every frame in both trajectories,
    and the child loaded no jax module. Returns the launch counts of this
    process's run."""
    import dataclasses

    import torch

    from bundleadjustment_tpu_torch import cli
    from bundleadjustment_tpu_torch.bench import protocols

    render = dict(n_frames=n_frames, width=640, height=480, fx=525.0, fy=525.0,
                  trajectory="forward", motion_step=0.03, seed=11)
    args = cli.build_parser().parse_args(pipeline_argv("", "", n_frames, device))
    r = protocols.checkpoint_resume(render, dataclasses.asdict(cli.config_from_args(args)),
                                    cut, device, timeout=600)
    resumed, ate, statuses = r["resumed"], r["ate_straight"], r["statuses"]
    bound = max(0.6 * ate, 0.01)
    emit({"phase": "protocol_resume_worker", "cut": cut, "frames": n_frames,
          "statuses": {k: statuses.count(k) for k in sorted(set(statuses))},
          "ate_straight_m": ate, "resumed": resumed, "ate_abs_diff_m":
          abs(resumed["ate_rmse_m"] - ate), "bound_m": bound,
          "worker_wall_s": r["wall_resume"], "checkpoint_bytes": r["checkpoint_bytes"],
          "launches": r["launches"]})
    if resumed["jax_modules"] or resumed["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the resume worker loaded {resumed['jax_modules']} "
                             f"or ran on {resumed['device']}")
    if not (len(statuses) == resumed["frames_tracked"] == n_frames
            and abs(resumed["ate_rmse_m"] - ate) <= bound):
        raise AssertionError(f"resumed run: {resumed} against ATE {ate} m")
    return r["launches"]


def stage_agreement(name, got, ref):
    """A frontend stage's outputs on the card (got) against the CPU's (ref)
    by the rule of tests/test_torch_frontend_stages.py: float maps within
    rtol 1e-5 and atol 1e-6 of the map's largest magnitude ("err_over_tol":
    the largest error over its tolerance, <= 1), FAST and BRIEF equal,
    orientation to 1e-4, nms_topk's values equal and its indices as sets
    where the values are distinct, detect_level0 >= 99% of keypoints the
    same (validity, position to 1e-3 px) with equal descriptors and angles
    to 1e-4."""
    import numpy as np

    host = lambda x: x.cpu().numpy()[0]  # noqa: E731
    if name in ("harris", "blur", "resize_7levels"):
        pairs = zip(got, ref) if name == "resize_7levels" else [(got, ref)]
        err, over = 0.0, 0.0
        for g, r in pairs:
            g, r = host(g), host(r)
            e = np.abs(g - r)
            err = max(err, float(e.max()))
            over = max(over, float((e / (1e-5 * np.abs(r) + 1e-6 * np.abs(r).max())).max()))
        return {"ok": over <= 1.0, "max_abs_err": err, "err_over_tol": over}
    if name in ("fast", "brief"):
        differ = int((host(got) != host(ref)).sum())
        return {"ok": differ == 0, "differ": differ}
    if name == "orientation":
        err = float(np.abs(host(got) - host(ref)).max())
        return {"ok": err <= 1e-4, "max_abs_err": err}
    if name == "nms_topk":
        (gv, gi), (rv, ri) = map(host, got), map(host, ref)
        u, n = np.unique(rv, return_counts=True)
        distinct = u[n == 1]
        ok = (np.array_equal(np.sort(gv), np.sort(rv))
              and set(gi[np.isin(gv, distinct)].tolist())
              == set(ri[np.isin(rv, distinct)].tolist()))
        return {"ok": bool(ok), "distinct_values": len(distinct)}
    gy, gx, _, ga, gd, gvalid = map(host, got)
    ry, rx, _, ra, rd, rvalid = map(host, ref)
    same = (np.abs(gx - rx) < 1e-3) & (np.abs(gy - ry) < 1e-3) & (gvalid == rvalid)
    ang = float(np.abs(ga - ra)[same].max())
    desc = int((gd != rd)[same].any(-1).sum())
    return {"ok": bool(same.mean() >= 0.99 and desc == 0 and ang <= 1e-4),
            "same_share": float(same.mean()), "valid": int(gvalid.sum()),
            "desc_differ": desc, "angle_max_abs_err": ang}


def phase_frontend_stages(device):
    """`bench/frontend.run` at its full geometry (640x480, 1,000 features, 8
    levels, 12 frames) on the card, one line a measurement; then each of its
    eight stages on the card against the same stage on the CPU on one
    640x480 frame, every input computed on the CPU (`stage_agreement`;
    also the NMS mask equal)."""
    from bundleadjustment_tpu_torch.bench import frontend
    from bundleadjustment_tpu_torch.ops import features as F

    for line in frontend.run(device):
        emit({"phase": "frontend_stages", **line})
    cfg = F.FeatureConfig()
    fns = frontend.stage_fns(cfg, 480, 640)
    ins = frontend.stage_inputs(frontend.render_frames(1, 640, 480, "cpu"), cfg)
    checks = {}
    for name in frontend.STAGES:
        args = ins[name][0]
        checks[name] = stage_agreement(name, fns[name](*(a.to(device) for a in args)),
                                       fns[name](*args))
    hmap = ins["nms_topk"][0][0]
    nms_differ = int((F._nms3(hmap.to(device)).cpu() != F._nms3(hmap)).sum())
    checks["nms_mask"] = {"ok": nms_differ == 0, "differ": nms_differ}
    emit({"phase": "frontend_stages_card_vs_cpu", "frame": "640x480", "checks": checks})
    bad = [name for name, c in checks.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"frontend stages that differ on the card: {bad}")


def check_launches(runs):
    """Per-path launch check: each kernel launched by the run of its path
    (KERNELS), and the sharded run's local BAs and evals through B and C."""
    need = {}
    for name, (_, _, _, path) in KERNELS.items():
        need.setdefault(path, []).append(name)
    for path, names in ALSO_LAUNCHED.items():
        need[path] = need.get(path, []) + list(names)
    missing = {path: [n for n in names
                      if runs[path].get(n, 0) < MIN_LAUNCHES.get(n, 1)]
               for path, names in need.items()}
    missing = {p: n for p, n in missing.items() if n}
    emit({"phase": "launch_check", "required": need, "at_least": MIN_LAUNCHES,
          "launches": {p: runs[p] for p in need}, "missing": missing})
    if missing:
        raise AssertionError(f"runs that did not launch their kernels: {missing}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np

    from bundleadjustment_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    phase_env()
    phase_build()
    rng = np.random.default_rng(0)
    results = {}
    phase_hamming(rng, device, results)
    phase_dense_kernels(device, results)
    phase_large_o_kernels(device, results)
    phase_dense_solve(device)
    runs = {"large_o_solve": phase_large_o_solve(device),
            "chol_solve_path": phase_chol_solve_path(device),
            "dense_pcg_solve": phase_dense_pcg_solve(device)}
    phase_flat_sharded_pcg(device)
    phase_two_view(device)
    n_frames = 40
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "seq")
        frames, K4 = write_sequence(data, n_frames, extra=TRACK_BATCH)
        frames, next_frames = frames[:n_frames], frames[n_frames:]
        pipe, res, runs["pipeline"] = phase_pipeline(device, data, n_frames)
        phase_pipeline_per_frame(device, data, n_frames, res, runs)
        phase_track_batch_step(pipe, device, next_frames, runs)
        runs["pipeline_sharded"] = phase_pipeline_sharded(
            device, data, n_frames, res["ate_rmse"])
        phase_pipeline_monocular(device, data, tmp, runs)
        phase_pipeline_solvers(device, data, n_frames, runs)
        phase_pipeline_predetect(device, data, frames, n_frames, res, runs)
        phase_pipeline_outputs(device, data, frames, K4, n_frames, tmp, runs)
        phase_checkpoint_resume(device, data, n_frames, res, tmp)
        phase_outputs_at_scale(device, frames, K4)
    runs["pipeline_depth_seeded"] = phase_pipeline_depth_seeded(device)
    runs["protocol_config1"] = phase_protocol_config1(device)
    runs["protocol_resume_worker"] = phase_protocol_resume_worker(device)
    phase_frontend_stages(device)
    check_launches(runs)
    phase_pipeline_shapes(pipe, results)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": runs[path][name], **{k: results[name][k] for k in keys}}
        for name, (route, src, rep, path) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
