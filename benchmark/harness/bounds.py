"""The yardstick of the roofline metrics: the card's published peaks and the
least operations and bytes of the dense LM iteration and of its parts,
worked out from the problem's valid observations.

The operation counts per observation, slot, slot pair and landmark are a
frozen copy of `bundleadjustment_tpu_torch/utils/flops.py` (`EVAL_OPS` ..
`PAIR_OPS`, the arithmetic of `lm_iter_bound`). The bytes differ from
there on purpose: `lm_iter_bound` counts the program's padded [L, O]
tensors, so a change of the program's layout would move its yardstick;
here every byte is one the problem needs (valid observations, landmarks,
poses), so the least time is the same whatever layout or route computes
it. `benchmark/tests/test_frozen_parity.py` states the difference.

Conventions: a multiply-add is 2 operations; float32 data; K cameras, L
landmarks, `n_obs` valid observations, `n_slots` of them of a free camera,
`n_pairs` the pairs (a, b), a <= b, of free-camera observations of one
landmark.
"""

from __future__ import annotations

# Published peaks of one card (NVIDIA's data sheet, SXM part, dense, at its
# 700 W limit): float32 outside the tensor cores, operations/s, and HBM3,
# bytes/s. Keyed by the start of `torch.cuda.get_device_name()`.
PEAKS = {"NVIDIA H100": {"fp32_ops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}}

EVAL_OPS = 320  # per valid observation: projection, residual, Huber, Jacobians, blocks
BS_OPS = 36  # more per valid observation: the landmark back-substitution
PREP_OPS = 60  # per landmark: damping, V^-1, chol(V^-1), zv
G_OPS, WZ_OPS = 90, 30  # per free-camera slot: G = W C, W zv
PAIR_OPS = 216  # per slot pair: 36 entries of G G'^T, 3 multiplies, 2 adds, 1 add into S
F = 4  # bytes of a float32, an int32 index
OBS_BYTES = 4 + 8 + 4 + 1  # per observation: camera index, pixel, variance, valid flag


def peaks(device_name):
    for prefix, p in PEAKS.items():
        if device_name.startswith(prefix):
            return p
    return None


def problem_stats(cam_idx, pt_idx, cam_fixed, n_points):
    """K, L, n_obs, n_slots, n_pairs of a flat observation table (numpy)."""
    import numpy as np

    cam_idx, pt_idx = np.asarray(cam_idx), np.asarray(pt_idx)
    free = ~np.asarray(cam_fixed, bool)[cam_idx]
    slots = np.bincount(pt_idx[free], minlength=n_points).astype(np.float64)
    seen = np.bincount(pt_idx, minlength=n_points) > 0
    return {"K": int(len(cam_fixed)), "L": int(seen.sum()), "n_obs": int(len(cam_idx)),
            "n_slots": int(free.sum()), "n_pairs": float((slots * (slots + 1) / 2).sum())}


def iter_work(st):
    """(ops, bytes) of one exact LM iteration: eval + assembly + back-
    substitution, the point prepare, S from the slot pairs, its Cholesky
    solve; the intrinsics, fixed flags and observations read once, poses
    and landmarks read and written once."""
    N = 6 * st["K"]
    ops = ((EVAL_OPS + BS_OPS) * st["n_obs"] + PREP_OPS * st["L"]
           + (G_OPS + WZ_OPS) * st["n_slots"] + PAIR_OPS * st["n_pairs"]
           + N ** 3 / 3 + 2 * N ** 2)
    n_bytes = (4 * F + st["K"] + OBS_BYTES * st["n_obs"]
               + 2 * F * (6 * st["K"] + 3 * st["L"]))
    return ops, n_bytes


def schur_work(st):
    """(ops, bytes) of forming the damped Schur system S, b once: the point
    prepare and G per slot, every slot pair once; W, the point blocks and
    the camera indices read once, S and b written once."""
    N = 6 * st["K"]
    ops = PREP_OPS * st["L"] + (G_OPS + WZ_OPS) * st["n_slots"] + PAIR_OPS * st["n_pairs"]
    n_bytes = (F * (18 + 1) * st["n_slots"] + F * (6 + 3) * st["L"]
               + F * 27 * st["K"] + F * (N * N + N))
    return ops, n_bytes


def eval_work(st, back_substitution=True):
    """(ops, bytes) of one kernel-B call: the observations, poses and
    landmarks read once; the camera rows, point blocks, W and the cost
    written once; with the back-substitution the previous W, V^-1, g_p and
    the camera step read and the new landmarks written."""
    ops = (EVAL_OPS + (BS_OPS if back_substitution else 0)) * st["n_obs"]
    n_bytes = (OBS_BYTES * st["n_obs"] + F * 12 * st["K"] + F * 3 * st["L"]
               + F * 27 * st["K"] + F * (6 + 3) * st["L"] + F * 18 * st["n_slots"] + F)
    if back_substitution:
        n_bytes += F * 18 * st["n_slots"] + F * (6 + 3 + 3) * st["L"] + F * 6 * st["K"]
    return ops, n_bytes


def least_s(work, pk):
    """Seconds of (ops, bytes) at the peaks `pk`: the larger of the
    operations over the float32 rate and the bytes over HBM's."""
    ops, n_bytes = work
    return max(ops / pk["fp32_ops_per_s"], n_bytes / pk["hbm_bytes_per_s"])
