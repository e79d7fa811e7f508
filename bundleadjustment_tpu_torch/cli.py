"""Command-line entry point of the port, with the JAX package's flag surface.

    python -m bundleadjustment_tpu_torch.cli \
        --dataset-name synthetic --dataset-path /data/seq \
        --output-path ./out --trajectory --device cuda

Same flags as `python -m bundleadjustment_tpu.cli`, plus `--device` (default
`cuda`; `cpu` runs the plain PyTorch versions of the kernels).
`--global-ba sharded` runs the landmark-sharded global BA over the default
torch.distributed process group when the caller has initialised one
(`parallel/multihost.py`), else as one shard. Writes the
TUM trajectory (`--trajectory`), the COFF mesh and `<prefix>_results.json`.

`--init-type standard` (two-view E/H bootstrap, no depth) and `--estimation
pnp` / `essential_or_homography` are the monocular configurations; `--seed`
seeds their RANSAC sampler.

Flags of modes that are not ported raise NotImplementedError naming the
ROADMAP item that ports them: --global-ba windowed, --ba-solver pcg,
--depth-landmarks, --predetect, --reconstruction-error, --faces-type
poisson, --display-pointcloud. --no-warmup, --matcher, --no-fused-tracking
and --track-batch are accepted and change nothing (their --help says so):
they tuned the JAX package's compilation and dispatch, which the port does
not have; the JAX microbatch of --track-batch also froze the local-map
snapshot for a batch, and its --help says how far the port's per-frame
result stays from that.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="bundleadjustment_tpu_torch",
        description="SfM / bundle adjustment pipeline (PyTorch/CUDA port)")
    p.add_argument("--init-type", choices=["standard", "gtdepth"], default="gtdepth")
    p.add_argument("--estimation", choices=["pnp", "ba", "essential_or_homography"],
                   default="ba")
    p.add_argument("--faces-type", choices=["standard", "poisson", "greedy"],
                   default="standard")
    p.add_argument("--dataset-name",
                   choices=["freiburg_xyz", "freiburg_teddy", "replica", "tum",
                            "synthetic"], default="replica")
    p.add_argument("--dataset-path", default="")
    p.add_argument("--output-path", default="./out")
    p.add_argument("--local-ba", action="store_true", default=False)
    p.add_argument("--frames", type=int, default=2000)
    p.add_argument("--reconstruction-error", default="", metavar="GT_PLY")
    p.add_argument("--trajectory", action="store_true", default=False)
    p.add_argument("--display-pointcloud", action="store_true", default=False)
    p.add_argument("--cull-frames", action="store_true", default=False)
    p.add_argument("--n-features", type=int, default=1000)
    p.add_argument("--n-levels", type=int, default=8)
    p.add_argument("--ba-solver", choices=["dense", "pcg"], default="dense")
    no_op = ("accepted for the JAX CLI's flag surface; changes nothing in the "
             "port, which ")
    p.add_argument("--matcher", choices=["auto", "pallas", "xla"], default="auto",
                   help=no_op + "sends every Hamming top-2 search through "
                   "kernel A on cuda and its plain version on cpu")
    p.add_argument("--no-fused-tracking", action="store_true", default=False,
                   help=no_op + "always tracks with the fused matcher, one "
                   "frame at a time (see --track-batch)")
    p.add_argument("--no-warmup", action="store_true", default=False,
                   help=no_op + "compiles nothing ahead of the first frame")
    p.add_argument("--track-batch", type=int, default=8,
                   help=no_op + "tracks one frame at a time, as the JAX CLI "
                   "does at --track-batch 1; against the JAX CLI's default "
                   "microbatch of 8 it agrees to the JAX package's own "
                   "tolerance for it (statuses and keyframes equal, map size "
                   "within 2%%, ATE within 0.01 m)")
    p.add_argument("--ba-layout", choices=["auto", "flat", "dense_landmark"],
                   default="auto")
    p.add_argument("--global-ba", choices=["single", "windowed", "sharded"],
                   default="single", dest="global_ba")
    p.add_argument("--depth-landmarks", action="store_true", default=False)
    p.add_argument("--predetect", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--verbose", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the hand-written kernels) or cpu "
                        "(their plain PyTorch versions)")
    return p


def output_prefix(args):
    """Encode the config into the output name (as the JAX CLI does)."""
    parts = [args.dataset_name, args.init_type, args.estimation,
             "localba" if args.local_ba else "globalba", f"f{args.frames}"]
    if args.cull_frames:
        parts.append("cull")
    return "_".join(parts)


def load_dataset(args):
    from bundleadjustment_tpu_torch.data.replica import ReplicaDataset
    from bundleadjustment_tpu_torch.data.tum import TUMDataset

    if args.dataset_name in ("freiburg_xyz", "freiburg_teddy", "tum", "synthetic"):
        ds = TUMDataset(root=args.dataset_path, max_frames=args.frames)
        sidecar = os.path.join(args.dataset_path, "intrinsics.json")
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                k = json.load(f)
            ds.K4 = np.array([k["fx"], k["fy"], k["cx"], k["cy"]], np.float32)
            ds.width, ds.height = k["width"], k["height"]
        return ds
    return ReplicaDataset(root=args.dataset_path, max_frames=args.frames)


def _check_flags(args):
    item = {"predetect": "--predetect",
            "reconstruction_error": "metrics/reconstruction.py",
            "display_pointcloud": "vis/{pointcloud,live}.py"}
    for flag, what in item.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet (ROADMAP queue 1: "
                f"{what})")
    if args.faces_type == "poisson":
        raise NotImplementedError("--faces-type poisson is not ported yet "
                                  "(ROADMAP queue 1: vis/poisson.py)")


def config_from_args(args):
    """The PipelineConfig of parsed CLI flags; raises NotImplementedError
    for a mode that is not ported."""
    from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
    from bundleadjustment_tpu_torch.pipeline.driver import check_config

    _check_flags(args)
    cfg = PipelineConfig(
        init_type=args.init_type, estimation=args.estimation,
        faces_type=args.faces_type, dataset_name=args.dataset_name,
        dataset_path=args.dataset_path, output_path=args.output_path,
        local_ba=args.local_ba, max_frames=args.frames,
        cull_frames=args.cull_frames, n_features=args.n_features,
        n_levels=args.n_levels, ba_solver=args.ba_solver,
        ba_layout=args.ba_layout, global_ba_mode=args.global_ba,
        depth_landmarks=args.depth_landmarks, matcher=args.matcher,
        fused_tracking=not args.no_fused_tracking,
        track_batch=args.track_batch, seed=args.seed, verbose=args.verbose)
    check_config(cfg)
    return cfg


def run_cli(argv=None):
    """Parse `argv`, run the pipeline, write the outputs.
    Returns (pipeline, results dict)."""
    from bundleadjustment_tpu_torch.data.tum import write_tum_trajectory
    from bundleadjustment_tpu_torch.geometry import np_se3
    from bundleadjustment_tpu_torch.metrics.ate import evaluate_ate
    from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline
    from bundleadjustment_tpu_torch.vis.mesh import create_map_mesh, write_off

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    ds = load_dataset(args)
    pipe = BundleAdjustmentPipeline(cfg, ds.K4, ds.width, ds.height,
                                    device=args.device)
    os.makedirs(args.output_path, exist_ok=True)
    prefix = os.path.join(args.output_path, output_prefix(args))
    stats = pipe.run(ds)

    ts, mats = pipe.trajectory_cam_to_world()
    if args.trajectory:
        write_tum_trajectory(prefix + "_estimatedPoses.txt", ts, mats)
    pts, pt_colors = pipe.map_points_colored()
    kf_slots = pipe.map.active_keyframes()
    cam_mats = [np_se3.rt6_to_mat44(np_se3.rt6_inverse(pipe.map.kf_pose[k]))
                for k in kf_slots]
    verts, faces, colors = create_map_mesh(pts, colors=pt_colors,
                                           cam_poses=cam_mats,
                                           faces_type=args.faces_type)
    write_off(prefix + "_mesh.off", verts, faces, colors)

    results = dict(stats)
    results["n_map_points"] = int(len(pts))
    results["n_keyframes_final"] = int(len(kf_slots))
    results["device"] = str(pipe.device)
    gt = [(f.timestamp, f.gt_cam_to_world) for f in ds
          if f.gt_cam_to_world is not None]
    if len(gt) >= 2 and len(ts) >= 2:
        gt_ts = np.array([t for t, _ in gt])
        gt_xyz = np.array([M[:3, 3] for _, M in gt])
        try:
            ate = evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz,
                               max_difference=0.05)
            results["ate_rmse"] = ate["rmse"]
            results["ate_scale"] = ate["scale"]
        except ValueError:
            pass
    with open(prefix + "_results.json", "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))
    return pipe, results


def main(argv=None):
    return run_cli(argv)[1]


if __name__ == "__main__":
    main(sys.argv[1:])
