"""Map / trajectory checkpointing.

Port of `bundleadjustment_tpu/pipeline/checkpoint.py` (the reference has no
checkpoint or resume, SURVEY.md §5): the whole pipeline state -- keyframe
records (poses, keypoints, descriptors, observation links), landmarks,
trajectory and tracking state -- goes into one compressed .npz, format
version 3 with the JAX package's keys, and `load_checkpoint` restores a
`BundleAdjustmentPipeline` that continues mid-sequence on `device`. A file
written by either package loads into the other.

Per-tracked-frame keypoint sets (`TrackRecord.feats`, `assoc_kp`, for the
finalize-time guided refinement) are not saved, as in the source: after a
resume, finalize falls back to the stored 2D-3D association lists for the
frames tracked before the checkpoint. `_prev_track` is not saved either, so
the first frame after a resume takes the split path.

The one deliberate difference: the source drops the pending depth seeds
(`_pending_seeds`, the 1-observation landmarks of `depth_landmarks` still
waiting for a second view), so they die after a resume. The port writes
them under an extra key, `pending_seeds`, which the JAX loader ignores,
and reads them back when the key is there (absent: none pending).
"""

from __future__ import annotations

import json

import numpy as np


CHECKPOINT_VERSION = 3


def save_checkpoint(path, pipe):
    """Serialize pipeline + map state to `path` (.npz), with the pending
    depth seeds under `pending_seeds`."""
    m = pipe.map
    n_kf = int(m._lib.map_num_frames(m._h))
    n_pt = int(m._lib.map_num_points(m._h))

    # observation links as a flat table (pt, kf, kp)
    links = []
    for pt in range(n_pt):
        if not m.pt_active[pt]:
            continue
        kfs, kps = m.point_observations(pt)
        for kf, kp in zip(kfs, kps):
            links.append((pt, int(kf), int(kp)))
    links = np.asarray(links, np.int32).reshape(-1, 3)

    traj = np.array(
        [
            (rec.timestamp, rec.slot, *rec.extr, float(rec.is_keyframe))
            for rec in pipe.trajectory
        ],
        np.float64,
    ).reshape(-1, 9)
    # keyframe-relative anchors (v3): ref slot (-1 = none) + rel rt6 (nan)
    traj_ref = np.array(
        [-1 if rec.ref_kf is None else int(rec.ref_kf)
         for rec in pipe.trajectory], np.int32)
    traj_rel = np.array(
        [rec.rel if rec.rel is not None else [np.nan] * 6
         for rec in pipe.trajectory], np.float64).reshape(-1, 6)

    # per-record 2D-3D associations (variable length -> flat + offsets);
    # needed so finalize()'s trajectory refinement works after a resume
    assoc_off = np.zeros(len(pipe.trajectory) + 1, np.int64)
    assoc_pt_flat, assoc_uv_flat, assoc_sig_flat = [], [], []
    for i, rec in enumerate(pipe.trajectory):
        n = 0 if rec.assoc_pt is None else len(rec.assoc_pt)
        assoc_off[i + 1] = assoc_off[i] + n
        if n:
            assoc_pt_flat.append(np.asarray(rec.assoc_pt, np.int64))
            assoc_uv_flat.append(np.asarray(rec.assoc_uv, np.float32))
            assoc_sig_flat.append(np.asarray(rec.assoc_sig, np.float32))
    has_assoc = np.array(
        [rec.assoc_pt is not None for rec in pipe.trajectory], bool
    )
    assoc_pt_flat = (
        np.concatenate(assoc_pt_flat) if assoc_pt_flat else np.zeros(0, np.int64)
    )
    assoc_uv_flat = (
        np.concatenate(assoc_uv_flat) if assoc_uv_flat
        else np.zeros((0, 2), np.float32)
    )
    assoc_sig_flat = (
        np.concatenate(assoc_sig_flat) if assoc_sig_flat
        else np.zeros(0, np.float32)
    )

    meta = {
        "version": CHECKPOINT_VERSION,
        "initialized": pipe.initialized,
        "kf_counter": pipe.kf_counter,
        "last_slot": -1 if pipe.last_slot is None else int(pipe.last_slot),
        "ref_slot": -1 if pipe.ref_slot is None else int(pipe.ref_slot),
        "stats": pipe.stats,
        "K4": np.asarray(pipe.K4).tolist(),
        "width": pipe.width,
        "height": pipe.height,
    }

    np.savez_compressed(
        path,
        meta=json.dumps(meta),
        kf_active=m.kf_active[:n_kf].copy(),
        kf_is_keyframe=m.kf_is_keyframe[:n_kf].copy(),
        kf_timestamp=m.kf_timestamp[:n_kf].copy(),
        kf_pose=m.kf_pose[:n_kf].copy(),
        kf_gt=m.kf_gt[:n_kf].copy(),
        kf_nkp=m.kf_nkp[:n_kf].copy(),
        kp_xy=m.kp_xy[:n_kf].copy(),
        kp_octave=m.kp_octave[:n_kf].copy(),
        kp_sigma2=m.kp_sigma2[:n_kf].copy(),
        kp_desc=m.kp_desc[:n_kf].copy(),
        kp_outlier=m.kp_outlier[:n_kf].copy(),
        pt_active=m.pt_active[:n_pt].copy(),
        pt_pos=m.pt_pos[:n_pt].copy(),
        pt_desc=m.pt_desc[:n_pt].copy(),
        pt_first_kf=m.pt_first_kf[:n_pt].copy(),
        pt_dmin=m.pt_dmin[:n_pt].copy(),
        pt_dmax=m.pt_dmax[:n_pt].copy(),
        pt_color=m.pt_color[:n_pt].copy(),
        links=links,
        trajectory=traj,
        traj_ref=traj_ref,
        traj_rel=traj_rel,
        assoc_off=assoc_off,
        has_assoc=has_assoc,
        assoc_pt=assoc_pt_flat,
        assoc_uv=assoc_uv_flat,
        assoc_sig=assoc_sig_flat,
        last_extr=(np.zeros(6) if pipe.last_extr is None else pipe.last_extr),
        prev_extr=(np.zeros(6) if pipe.prev_extr is None else pipe.prev_extr),
        has_last_extr=np.asarray(pipe.last_extr is not None),
        has_prev_extr=np.asarray(pipe.prev_extr is not None),
        last_feats_xy=(np.zeros((0, 2), np.float32) if pipe.last_feats is None
                       else pipe.last_feats.xy),
        last_feats_octave=(np.zeros(0, np.int32) if pipe.last_feats is None
                           else pipe.last_feats.octave),
        last_feats_sigma2=(np.zeros(0, np.float32) if pipe.last_feats is None
                           else pipe.last_feats.sigma2),
        last_feats_desc=(np.zeros((0, 8), np.uint32) if pipe.last_feats is None
                         else pipe.last_feats.desc),
        last_feats_valid=(np.zeros(0, bool) if pipe.last_feats is None
                          else pipe.last_feats.valid),
        pending_seeds=np.asarray(pipe._pending_seeds, np.int64),
    )


def load_checkpoint(path, config=None, device="cuda"):
    """Restore a BundleAdjustmentPipeline on `device` from a checkpoint file
    of either package."""
    from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
    from bundleadjustment_tpu_torch.pipeline.driver import (
        BundleAdjustmentPipeline,
        FrameFeatures,
        TrackRecord,
    )

    with np.load(path, allow_pickle=False) as npz:
        z = {k: npz[k] for k in npz.files}
    meta = json.loads(str(z["meta"]))
    if meta["version"] != CHECKPOINT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")

    cfg = config or PipelineConfig()
    pipe = BundleAdjustmentPipeline(cfg, np.asarray(meta["K4"], np.float32),
                                    meta["width"], meta["height"], device=device)
    m = pipe.map

    n_kf = len(z["kf_active"])
    # re-add frames in slot order to reproduce identical slot numbering
    for kf in range(n_kf):
        n_kp = int(z["kf_nkp"][kf])
        slot = m.add_frame(
            float(z["kf_timestamp"][kf]),
            z["kf_pose"][kf],
            z["kp_xy"][kf, :n_kp],
            z["kp_octave"][kf, :n_kp],
            z["kp_sigma2"][kf, :n_kp],
            z["kp_desc"][kf, :n_kp],
            gt_pose44=z["kf_gt"][kf],
        )
        if slot != kf:
            raise ValueError(f"{path}: frame {kf} restored into slot {slot}")
        if z["kf_is_keyframe"][kf]:
            m.set_keyframe(kf)

    n_pt = len(z["pt_active"])
    for pt in range(n_pt):
        slot = m.add_point(
            z["pt_pos"][pt], desc=z["pt_desc"][pt],
            first_kf=int(z["pt_first_kf"][pt]),
        )
        if slot != pt:
            raise ValueError(f"{path}: point {pt} restored into slot {slot}")

    for pt, kf, kp in z["links"]:
        m.add_observation(int(pt), int(kf), int(kp))

    # deactivate erased records AFTER links (links only reference active ones)
    for kf in range(n_kf):
        if not z["kf_active"][kf]:
            m.erase_frame(kf)
    for pt in range(n_pt):
        if not z["pt_active"][pt]:
            m.erase_point(pt)
    m.kp_outlier[:n_kf] = z["kp_outlier"]
    m.pt_dmin[:n_pt] = z["pt_dmin"]
    m.pt_dmax[:n_pt] = z["pt_dmax"]
    m.pt_color[:n_pt] = z["pt_color"]

    # covisibility rebuild for live keyframes
    for kf in m.active_keyframes():
        m.update_covisibility(int(kf), cfg.covis_threshold)

    pipe.initialized = bool(meta["initialized"])
    pipe.kf_counter = int(meta["kf_counter"])
    pipe.last_slot = None if meta["last_slot"] < 0 else int(meta["last_slot"])
    pipe.ref_slot = None if meta["ref_slot"] < 0 else int(meta["ref_slot"])
    pipe.stats = dict(meta["stats"])
    pipe.last_extr = z["last_extr"] if bool(z["has_last_extr"]) else None
    pipe.prev_extr = z["prev_extr"] if bool(z["has_prev_extr"]) else None
    if len(z["last_feats_xy"]):
        pipe.last_feats = FrameFeatures(
            xy=z["last_feats_xy"],
            octave=z["last_feats_octave"],
            sigma2=z["last_feats_sigma2"],
            desc=z["last_feats_desc"],
            valid=z["last_feats_valid"],
        )
    off = z["assoc_off"]
    has_assoc = z["has_assoc"]
    traj_ref = z["traj_ref"]
    traj_rel = z["traj_rel"]
    last_kf = None
    for i, row in enumerate(z["trajectory"]):
        a, b = int(off[i]), int(off[i + 1])
        ref = None if traj_ref[i] < 0 else int(traj_ref[i])
        rel = None if np.isnan(traj_rel[i, 0]) else traj_rel[i].copy()
        rec = TrackRecord(
            timestamp=float(row[0]),
            slot=int(row[1]),
            extr=np.asarray(row[2:8]),
            is_keyframe=bool(row[8]),
            ref_kf=ref,
            rel=rel,
            assoc_pt=z["assoc_pt"][a:b].copy() if has_assoc[i] else None,
            assoc_uv=z["assoc_uv"][a:b].copy() if has_assoc[i] else None,
            assoc_sig=z["assoc_sig"][a:b].copy() if has_assoc[i] else None,
        )
        pipe.trajectory.append(rec)
        if rec.is_keyframe:
            last_kf = rec.slot
    if last_kf is not None:
        pipe._last_kf_slot = int(last_kf)
    if "pending_seeds" in z:
        pipe._pending_seeds = [int(p) for p in z["pending_seeds"]]
    return pipe
