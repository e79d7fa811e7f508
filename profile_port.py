#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's pipeline spends its time on one NVIDIA GPU.

    python3 profile_port.py [--frames 40] [--track-batch 8]

Runs the pipeline of chip_smoke.py (a rendered 640x480 TUM-format sequence,
CLI defaults: gtdepth, ba, local BA, 3x100 final BA, 1000 features, 8
levels, tracking microbatches of `--track-batch` frames, 1 for one frame at
a time) and prints one JSON object per line:

1. `{"run": "cold" | "warm", ...}`: two unprofiled CLI runs in this process,
   host wall seconds (ending in torch.cuda.synchronize()), frames/s, ATE,
   launch counts of the hand-written kernels and the PhaseTimer phases;
2. a third run, through `process_frames` as the CLI runs it, under
   torch.profiler in two windows: the tracking frames [n/2, 3n/4) and the
   frames [3n/4, n) plus `finalize`.
   For each window (`{"window": ...}`): wall seconds (the profiler's own
   overhead included), device busy seconds (the durations of the kernels
   the card ran, summed), busy share, kernel launches in all and per frame,
   and the host seconds spent in cudaLaunchKernel; then, per hand-written
   kernel, its launches and the sum / median / max of its durations, the
   ten kernels with the most device time and the ten host ops with the most
   self time.

Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

# the kernels of bundleadjustment_tpu_torch/csrc/*.cu, by their __global__ names
OURS = ("hamming_chunks", "hamming_merge", "dense_eval_units", "dense_eval_finish",
        "dense_eval_backsub", "schur_tiles", "schur_finish", "schur_prepare_kernel",
        "chol_solve_kernel")


def emit(obj):
    print(json.dumps(obj), flush=True)


def kernel_events(prof):
    """(name, duration ms) of every kernel the card ran in the profile."""
    from bundleadjustment_tpu_torch.utils.timing import device_events

    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in device_events(prof)]


def report_window(name, prof, wall, n_frames):
    kern = kernel_events(prof)
    busy_s = sum(d for _, d in kern) / 1e3
    launch = [e for e in prof.key_averages() if e.key == "cudaLaunchKernel"]
    emit({"window": name, "frames": n_frames, "wall_s": wall,
          "device_busy_s": busy_s, "busy_share": busy_s / wall,
          "kernel_launches": len(kern),
          "launches_per_frame": len(kern) / max(n_frames, 1),
          "cudaLaunchKernel_host_s": sum(e.self_cpu_time_total for e in launch) / 1e6,
          "cudaLaunchKernel_calls": sum(e.count for e in launch)})
    for ours in OURS:
        d = [ms for n, ms in kern if ours in n]
        if d:
            emit({"window": name, "ours": ours, "launches": len(d),
                  "sum_ms": sum(d), "median_ms": statistics.median(d),
                  "max_ms": max(d)})
    by_name = {}
    for n, ms in kern:
        tot, cnt = by_name.get(n, (0.0, 0))
        by_name[n] = (tot + ms, cnt + 1)
    for n, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        emit({"window": name, "kernel": n[:100], "device_ms": tot, "count": cnt})
    host = [e for e in prof.key_averages() if not str(e.device_type).endswith("CUDA")]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        emit({"window": name, "host_op": e.key[:100],
              "self_cpu_ms": e.self_cpu_time_total / 1e3, "count": e.count})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--track-batch", type=int, default=8)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_port: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from bundleadjustment_tpu_torch import cli, kernels
    from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline

    n = args.frames
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "seq")
        chip_smoke.write_sequence(data, n)
        argv = ["--dataset-name", "synthetic", "--dataset-path", data,
                "--output-path", os.path.join(tmp, "out"), "--frames", str(n),
                "--local-ba", "--trajectory", "--device", "cuda",
                "--track-batch", str(args.track_batch)]
        for run in ("cold", "warm"):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            _, res = cli.run_cli(argv)
            sync()
            wall = time.perf_counter() - t0
            emit({"run": run, "frames": n, "wall_s": wall, "frames_per_s": n / wall,
                  "ate_rmse_m": res.get("ate_rmse"),
                  "launches": kernels.launch_counts(),
                  "phase_times": res["phase_times"]})

        cli_args = cli.build_parser().parse_args(argv)
        ds = cli.load_dataset(cli_args)
        pipe = BundleAdjustmentPipeline(cli.config_from_args(cli_args), ds.K4,
                                        ds.width, ds.height, device="cuda")
        frames = list(ds)
        a, b = n // 2, 3 * n // 4
        pipe.process_frames(frames[:a])
        sync()
        windows = (
            (f"frames_{a}_{b - 1}", b - a, lambda: pipe.process_frames(frames[a:b])),
            (f"frames_{b}_{n - 1}_and_finalize", n - b,
             lambda: (pipe.process_frames(frames[b:]), pipe.finalize())),
        )
        for name, n_frames, fn in windows:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                sync()
                wall = time.perf_counter() - t0
            report_window(name, prof, wall, n_frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
