"""FLOP / byte accounting for the BA solve and the feature frontend: MFU and
roofline fields for the port's benches.

Port of `bundleadjustment_tpu/utils/flops.py`. The counts are the JAX
package's, term by term (`FLOP_MODEL_VERSION` 2), so a figure here and one
of the JAX package count the same work. That work is the TPU engine's
mechanics, not all of it the port's:

- `reduce_U` (the [K, O*L] one-hot reduce of the 27 camera rows),
  `gather_pose` (the one-hot gather of the [K, 12] pose table) and
  `schur_Pf` (the one-hot batched matmul that places G by camera) are MXU
  products of one-hot matrices. The port's kernels B, C and D index the
  camera directly (and route (c) sums Pf by `index_add_`), so these terms
  are operations the port does not perform; at K = 64 they are most of
  `total` outside `schur_QQt`;
- `schur_QQt` is route (c)'s explicit product; kernel C (route (s), O <=
  64) sums the same entries of S slot pair by slot pair, which needs far
  fewer operations when a landmark is seen by few cameras;
- the frontend's `resize_mxu` is the two dense resize products a level, as
  the port's `_resize_linear` also computes them.

So an MFU from this model on the card is a comparison with the JAX
package's figures, not the share of the card's peak that the port's useful
work reaches: at 128c/100k it exceeds 1. The runners print it as
`jax_model_flops_ratio`. The port's own yardstick is `lm_iter_bound`: the
least time an LM iteration of the port could take on this problem's data,
from the same byte and operation counts as the kernel table of
`chip_smoke.py`; its share of a measured time is at most 1.

The peaks are the card's published float32 rate outside the tensor cores
and its HBM rate: the port runs its products in full float32
(`device.resolve_device` turns TF32 off). Conventions: 1 multiply-add = 2
FLOPs; K cameras, L landmarks (padded), O observation slots per landmark.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
# its 700 W limit): float32 outside the tensor cores, FLOP/s, and HBM3,
# bytes/s. Keyed by the start of `torch.cuda.get_device_name`.
PEAK_FLOPS = {"NVIDIA H100": 67e12}
PEAK_HBM_BW = {"NVIDIA H100": 3.35e12}


def _device_name(device) -> str:
    """The card's name for a torch.device / "cuda:N", or a name as given;
    "" for the CPU."""
    import torch

    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    dev = torch.device(device)
    if dev.type != "cuda":
        return ""
    return torch.cuda.get_device_name(dev)


def _lookup(table, device):
    name = _device_name(device).lower()
    for prefix, peak in table.items():
        if name.startswith(prefix.lower()):
            return peak
    return None


def device_peak_flops(device) -> float | None:
    """Peak float32 FLOP/s of a card (torch.device or device name), or None
    if unknown (the CPU)."""
    return _lookup(PEAK_FLOPS, device)


def device_peak_bw(device) -> float | None:
    """Peak HBM bandwidth (B/s) of a card, or None if unknown (the CPU)."""
    return _lookup(PEAK_HBM_BW, device)


# FLOP-model version, reported alongside MFU numbers in bench JSON.  v2
# (round 2): resid_jac 420->440 and the separate 2x cost-eval term removed
# when the engine switched to single-eval LM (trial residuals reused) —
# MFU/roofline figures are NOT comparable with v1 (BENCH_r01) numbers.
FLOP_MODEL_VERSION = 2


def dense_ba_iter_flops(K: int, L: int, O: int, solver: str = "dense",
                        pcg_iters: int = 0) -> dict:
    """FLOPs for ONE LM iteration of `dense_ba_solve` (component-major).

    Returns a breakdown dict with 'total'.  Terms follow dense_ba.py:

    - fused eval (one per iteration): projection, duv_dx, J_phi/Jp
      contractions, robust-cost rho — elementwise over [O, L] (~440
      FLOPs/obs counted from the unrolled component loops).  The trial
      point's REDUCED blocks (red/Vu/g_p/W) come from the SAME pass and are
      carried into the next iteration on acceptance, so there is no
      separate cost evaluation or per-iteration re-assembly;
    - block build: U/g_c one-hot reduce (21 symmetric-unique U rows + 6
      gradient rows = 27), V (6 unique), g_p (6), W (36);
    - schur (exact): G build, Pf one-hot batched matmul, S = QQ^T
      (the dominant term: 2*(6K)^2*(3L)), Cholesky (6K)^3/3, solve;
    - schur (pcg): per-CG-iteration matvec = gather + W-chain + reduce;
    - back-substitution.
    """
    OL = O * L
    br = {}
    br["resid_jac"] = 440 * OL
    # U (21 unique symmetric rows) + g_c (6 rows) via one-hot [K, O*L] matmul
    br["reduce_U"] = 2 * 27 * K * OL
    br["V_gp_W"] = (2 * 6 + 2 * 3 + 36) * OL
    # camera gather of [K,12] pose table
    br["gather_pose"] = 2 * 12 * K * OL
    if solver == "dense":
        br["schur_G"] = 2 * 54 * OL
        br["schur_Pf"] = 2 * 18 * K * OL
        br["schur_QQt"] = 2 * (6 * K) ** 2 * (3 * L)
        br["schur_chol"] = (6 * K) ** 3 // 3
        br["schur_rhs"] = 2 * 6 * K * OL + (2 * 9 + 2 * 18) * OL
    else:
        per_cg = (
            2 * 6 * K * OL  # gather dc
            + (36 + 18 + 36) * 2 * OL  # W chains + V_inv apply
            + 2 * 6 * K * OL  # reduce back
            + 2 * 36 * K  # U x
        )
        br["pcg"] = pcg_iters * per_cg + 2 * 36 * K * K  # + Minv prep
    # back-substitution: gather + W reduce + V_inv apply
    br["backsub"] = 2 * 6 * K * OL + (36 + 18) * 2 * OL
    br["total"] = sum(br.values())
    return br


def dense_ba_iter_bytes(K: int, L: int, O: int, dtype_bytes: int = 4) -> dict:
    """Approximate HBM traffic per LM iteration (reads of the big
    per-observation tensors; small K-sized tables ignored).

    Counts one read per materialized [.., O, L] tensor per consumer pass:
    problem inputs (uv 2, sigma 2, valid ~1, cam_idx 1), residuals (2),
    Jc (12), Jp (6), W (18), G (18), plus the [6K, 3L] Q read twice by the
    QQ^T matmul's operands (XLA reuses tiles; this is the upper bound).
    """
    OL = O * L
    tensors_OL = 2 + 2 + 1 + 1 + 2 + 12 + 6 + 18 + 18
    q = 2 * (6 * K) * (3 * L)
    total = dtype_bytes * (tensors_OL * OL + q)
    return {"total": total, "per_obs_tensors": dtype_bytes * tensors_OL * OL,
            "q_matrix": dtype_bytes * q}


# ---------------------------------------------------------------------------
# feature-frontend model (ops/features.py: detect_and_describe)
# ---------------------------------------------------------------------------


def _frontend_level_dims(H, W, n_levels, scale_factor, border=16):
    """Per-level (h, w) exactly as detect_and_describe computes them."""
    dims = [(H, W)]
    for lvl in range(1, n_levels):
        s = scale_factor ** lvl
        dims.append((max(int(round(H / s)), 2 * border + 8),
                     max(int(round(W / s)), 2 * border + 8)))
    return dims


def _frontend_level_allocs(n_features, n_levels, scale_factor):
    """Per-level keypoint budgets (ops/features.py:_level_allocations)."""
    inv = 1.0 / scale_factor
    weights = [inv ** i for i in range(n_levels)]
    total = sum(weights)
    alloc = [int(n_features * w / total) for w in weights]
    alloc[0] += n_features - sum(alloc)
    return [max(a, 8) for a in alloc]


def frontend_flops(H, W, n_features=1000, n_levels=8, scale_factor=1.2,
                   n_disc=709, n_bits=256) -> dict:
    """FLOPs (+ integer-op and byte estimates) for ONE frame of
    `detect_and_describe` (ops/features.py), term by term.

    Terms follow the shift-add/matmul lowering:

    - resize: two dense matmuls per level>0, [h_l,H]@[H,W] + [h_l,W]@[W,w_l]
      (the MXU work; everything else is VPU elementwise);
    - sobel: 2 gradients x 2 separable passes (2+3 nonzero taps, 2 FLOP/tap);
    - structure tensor: 3 products + 3-channel separable 7-tap blur;
    - harris/shi response arithmetic;
    - fast: 16 circle compares x2 polarities + 2x contiguous-9 shift-AND
      chains (integer ops, counted separately);
    - nms + top-k: 9-neighbor max + ~2 compares/element partial reduction;
    - blur: separable 7-tap over the level image;
    - orientation: [M_l, n_disc] gather + centroid moments (5 FLOP/sample);
    - brief: pattern rotation (8 FLOP/bit), 2 gathers/bit, compare+pack
      (~6 op/bit);
    - subpixel: ~20 FLOP/keypoint.

    Bytes: each full-image pass reads+writes the level plane once; the model
    counts the distinct [h_l, w_l] traversals of the fused graph (XLA fuses
    the elementwise chains, so passes ~ the number of independent
    producer/consumer groups: sobel in, 3ch blur in+out, fast in, nms,
    top-k, blur, resize in/out) — an estimate good to tens of percent,
    stated as such.
    """
    dims = _frontend_level_dims(H, W, n_levels, scale_factor)
    allocs = _frontend_level_allocs(n_features, n_levels, scale_factor)
    br = {"resize_mxu": 0, "sobel": 0, "structure_blur": 0, "response": 0,
          "nms_topk": 0, "blur": 0, "orientation": 0, "brief": 0,
          "subpixel": 0}
    int_ops = 0
    bytes_ = 0
    for lvl, ((h, w), m) in enumerate(zip(dims, allocs)):
        p = h * w
        if lvl > 0:
            br["resize_mxu"] += 2 * h * H * W + 2 * h * W * w
            bytes_ += 4 * (H * W + h * W + h * w)
        br["sobel"] += (4 + 6) * 2 * p  # kd(2 taps)+ks(3 taps), ix and iy
        br["structure_blur"] += 3 * p + 3 * 2 * 7 * 2 * p
        br["response"] += 12 * p
        int_ops += 128 * p  # fast compares + shift-AND chains
        br["nms_topk"] += 10 * p + 2 * p
        br["blur"] += 2 * 7 * 2 * p
        br["orientation"] += m * n_disc * 5
        br["brief"] += m * n_bits * (8 + 6)
        br["subpixel"] += 20 * m
        # ~12 fused full-plane traversals (read+write) per level
        bytes_ += 12 * 2 * 4 * p
        # gathers: orientation disc + brief endpoints
        bytes_ += 4 * m * (n_disc + 2 * n_bits)
    br["total"] = sum(br.values())
    return {**br, "int_ops": int_ops, "bytes": bytes_}


def frontend_roofline(ms_per_frame: float, H, W, device, n_features=1000,
                      n_levels=8, scale_factor=1.2) -> dict:
    """Achieved GFLOP/s, MFU (against the card's float32 peak; small by
    construction for a bandwidth-bound frontend, reported for
    comparability), and HBM bandwidth utilization for a measured per-frame
    time. `device`: a torch.device or a device name."""
    fl = frontend_flops(H, W, n_features, n_levels, scale_factor)
    t = ms_per_frame / 1e3
    achieved = fl["total"] / t
    peak = device_peak_flops(device)
    bw = device_peak_bw(device)
    return {
        "flops_per_frame": fl["total"],
        "int_ops_per_frame": fl["int_ops"],
        "bytes_per_frame": fl["bytes"],
        "achieved_gflops": achieved / 1e9,
        "mfu": (achieved / peak) if peak else None,
        "achieved_gbps": fl["bytes"] / t / 1e9,
        "bw_util": (fl["bytes"] / t / bw) if bw else None,
        "dominant_term": max(
            ((k, v) for k, v in fl.items()
             if k not in ("total", "int_ops", "bytes")),
            key=lambda kv: kv[1],
        )[0],
    }


def roofline(iter_s: float, K: int, L: int, O: int, device,
             solver: str = "dense", pcg_iters: int = 0) -> dict:
    """Achieved TFLOP/s, MFU against the card's float32 peak, and arithmetic
    intensity for a measured LM-iterations/s figure. `device`: a
    torch.device or a device name."""
    fl = dense_ba_iter_flops(K, L, O, solver, pcg_iters)
    by = dense_ba_iter_bytes(K, L, O)
    achieved = fl["total"] * iter_s
    peak = device_peak_flops(device)
    return {
        "flops_per_iter": fl["total"],
        "bytes_per_iter": by["total"],
        "arith_intensity": fl["total"] / max(by["total"], 1),
        "achieved_tflops": achieved / 1e12,
        "mfu": (achieved / peak) if peak else None,
        "peak_tflops": (peak / 1e12) if peak else None,
        "dominant_term": max(
            ((k, v) for k, v in fl.items() if k != "total"),
            key=lambda kv: kv[1],
        )[0],
    }


# ---------------------------------------------------------------------------
# the port's own bound of an LM iteration
# ---------------------------------------------------------------------------
# float32 operations, counted from the kernels' arithmetic (chip_smoke.py's
# kernel table uses the same counts)
EVAL_OPS = 320  # per valid observation: kernel B's eval + assembly
BS_OPS = 36  # more per valid observation for the back-substitution
PREP_OPS = 60  # per landmark: damping, V^-1, chol(V^-1), zv
G_OPS, WZ_OPS = 90, 30  # per non-zero W slot: G = W C, W zv
PAIR_OPS = 216  # per slot pair of a landmark: 36 entries of G G'^T, each 3
                # multiplies, 2 adds and the add into S
# per PCG iteration: W^T x and W z (18 multiply-adds each) per non-zero W
# slot, V^-1 y (9) per landmark, U x and the preconditioner (36 each) per
# camera; the vector updates and dot products are left out
CG_SLOT_OPS, CG_POINT_OPS, CG_CAM_OPS = 72, 18, 144


def lm_iter_bound(prob, device, solver="dense", pcg_iters=0) -> dict | None:
    """The least time one LM iteration of the port's `dense_ba_solve` on
    `prob` (a `DenseBAProblem`) could take on the card: {"bound_ms",
    "bound_by", "bytes", "ops"}, the larger of its bytes over the HBM rate
    and its operations over the float32 rate; None where the peaks are
    unknown (the CPU).

    Bytes: the problem's tensors, the poses and the points read once, the
    poses and points written once. Operations: what this problem's data
    needs (valid observations, non-zero W slots, i.e. valid observations of
    a free camera, and a landmark's slot pairs once each): kernel B's eval
    with the back-substitution, the point prepare, and then the exact
    solve's S (slot pairs) and its Cholesky solve, (6K)^3 / 3 + 2 (6K)^2,
    or `pcg_iters` PCG iterations."""
    peak, bw = device_peak_flops(device), device_peak_bw(device)
    if not (peak and bw):
        return None
    K = int(prob.cam_fixed.shape[0])
    L = int(prob.pt_valid.sum())
    n_obs = float(prob.valid.sum())
    slots = (prob.valid & ~prob.cam_fixed[prob.cam_idx.long()]).sum(1).double()
    n_slots, n_pairs = float(slots.sum()), float((slots * (slots + 1) / 2).sum())
    ops = (EVAL_OPS + BS_OPS) * n_obs + PREP_OPS * L
    if solver == "dense":
        N = 6 * K
        ops += (G_OPS + WZ_OPS) * n_slots + PAIR_OPS * n_pairs + N ** 3 / 3 + 2 * N ** 2
    else:
        ops += WZ_OPS * n_slots + pcg_iters * (
            CG_SLOT_OPS * n_slots + CG_POINT_OPS * L + CG_CAM_OPS * K)
    tensors = (prob.K4, prob.cam_idx, prob.uv, prob.sigma2, prob.valid,
               prob.cam_fixed, prob.pt_valid)
    n_bytes = (sum(t.numel() * t.element_size() for t in tensors)
               + 2 * 4 * (6 * K + 3 * int(prob.cam_idx.shape[0])))
    t_bytes, t_ops = n_bytes / bw, ops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(n_bytes), "ops": int(ops)}


def solve_roofline(ms_per_iter: float, prob, device, solver="dense",
                   pcg_iters=0, prefix="") -> dict:
    """The roofline fields a runner prints for a measured ms an LM iteration
    of `dense_ba_solve` on `prob`, each key after `prefix`: the port's own
    bound (`lm_iter_bound`) and the share of it reached
    ("port_bound_share", at most 1), and the JAX package's FLOP model
    (`roofline`) under names that say whose model it is: its
    "jax_model_flops_ratio" to the card's peak counts TPU work the port
    does not do and may exceed 1. None where the card's peaks are unknown."""
    K, (L, O) = int(prob.cam_fixed.shape[0]), prob.cam_idx.shape
    roof = roofline(1e3 / ms_per_iter, K, int(L), int(O), device, solver, pcg_iters)
    b = lm_iter_bound(prob, device, solver, pcg_iters) or {}
    out = {
        "port_bound_ms": b.get("bound_ms"),
        "port_bound_by": b.get("bound_by"),
        "port_bound_share": b["bound_ms"] / ms_per_iter if b else None,
        "jax_model_version": FLOP_MODEL_VERSION,
        "jax_model_flops_per_iter": roof["flops_per_iter"],
        "jax_model_bytes_per_iter": roof["bytes_per_iter"],
        "jax_model_tflops": roof["achieved_tflops"],
        "jax_model_flops_ratio": roof["mfu"],
        "jax_model_dominant_term": roof["dominant_term"],
    }
    return {prefix + k: v for k, v in out.items()}


def frontend_fields(ms_per_frame: float, H, W, device, n_features=1000,
                    n_levels=8, scale_factor=1.2, prefix="") -> dict:
    """`frontend_roofline` under the names a runner prints, each key after
    `prefix`: the JAX package's model of the frontend's work ("jax_model_...";
    its ratios to the card's peaks are None where they are unknown)."""
    r = frontend_roofline(ms_per_frame, H, W, device, n_features, n_levels,
                          scale_factor)
    out = {
        "jax_model_flops_per_frame": r["flops_per_frame"],
        "jax_model_bytes_per_frame": r["bytes_per_frame"],
        "jax_model_gflops": r["achieved_gflops"],
        "jax_model_flops_ratio": r["mfu"],
        "jax_model_gbps": r["achieved_gbps"],
        "jax_model_bw_ratio": r["bw_util"],
        "jax_model_dominant_term": r["dominant_term"],
    }
    return {prefix + k: v for k, v in out.items()}
