"""The yardstick of the roofline metrics of the cells with BAL's camera: the
least operations and bytes of the dense LM iteration and of its parts at a
camera width of 9 (axis-angle, translation, focal, k1, k2), worked out from
the problem's valid observations, in `bounds.py`'s conventions (a
multiply-add is 2 operations; float32 data; every byte one the problem
needs, whatever layout or route computes it; `bounds.problem_stats` gives
K, L, n_obs, n_slots and n_pairs, which do not depend on the camera).

The counts a valid observation, slot, slot pair and landmark, against the
pinhole's of `bounds.py`:

- EVAL_OPS 470 = 320 + 6 (p, |p|^2, 1 + k1 n + k2 n^2 and f r p in the
  residual, against f x / z + c) + 18 (d(f r p)/dp, a 2x2 factor, in the
  Jacobian of the projection) + 18 (the three columns of f, k1, k2, and
  their weights) + 81 (45 + 9 camera rows against 21 + 6, 3 operations
  each) + 27 (W, 27 entries against 18, 3 each);
- BS_OPS 54: W^T dc, 27 multiply-adds (36 at 18);
- PREP_OPS 60: the point block does not change;
- G_OPS 135, WZ_OPS 45: G = W C (27 entries, 5 operations each) and W zv
  (9 entries, 5 each);
- PAIR_OPS 486: 81 entries of G G'^T, 3 multiplies, 2 adds, 1 add into S.

Bytes: a camera is 15 floats where the kernels read it (R, t and f, k1,
k2) and 9 where it is read or written as the state; the camera rows are
54 floats a camera; W 27 a slot; S (9K)^2.
"""

from __future__ import annotations

from harness.bounds import F, OBS_BYTES, least_s, peaks, problem_stats  # noqa: F401

P = 9  # parameters a camera
NR = P * (P + 1) // 2 + P  # camera rows: 54
EVAL_OPS = 470
BS_OPS = 54
PREP_OPS = 60
G_OPS, WZ_OPS = 135, 45
PAIR_OPS = 486


def iter_work(st):
    """(ops, bytes) of one exact LM iteration at width 9: eval + assembly +
    back-substitution, the point prepare, S from the slot pairs, its
    Cholesky solve; fixed flags and observations read once, cameras (9
    floats) and landmarks read and written once."""
    N = P * st["K"]
    ops = ((EVAL_OPS + BS_OPS) * st["n_obs"] + PREP_OPS * st["L"]
           + (G_OPS + WZ_OPS) * st["n_slots"] + PAIR_OPS * st["n_pairs"]
           + N ** 3 / 3 + 2 * N ** 2)
    n_bytes = (st["K"] + OBS_BYTES * st["n_obs"] + 2 * F * (P * st["K"] + 3 * st["L"]))
    return ops, n_bytes


def schur_work(st):
    """(ops, bytes) of forming the damped Schur system S, b once at width 9:
    the point prepare and G per slot, every slot pair once; W, the point
    blocks, the camera rows and the camera indices read once, S and b
    written once."""
    N = P * st["K"]
    ops = PREP_OPS * st["L"] + (G_OPS + WZ_OPS) * st["n_slots"] + PAIR_OPS * st["n_pairs"]
    n_bytes = (F * (3 * P + 1) * st["n_slots"] + F * (6 + 3) * st["L"]
               + F * NR * st["K"] + F * (N * N + N))
    return ops, n_bytes


def eval_work(st, back_substitution=True):
    """(ops, bytes) of one kernel-B call at width 9: the observations,
    cameras (15 floats) and landmarks read once; the camera rows, point
    blocks, W and the cost written once; with the back-substitution the
    previous W, V^-1, g_p and the camera step read and the new landmarks
    written."""
    ops = (EVAL_OPS + (BS_OPS if back_substitution else 0)) * st["n_obs"]
    n_bytes = (OBS_BYTES * st["n_obs"] + F * 15 * st["K"] + F * 3 * st["L"]
               + F * NR * st["K"] + F * (6 + 3) * st["L"] + F * 3 * P * st["n_slots"] + F)
    if back_substitution:
        n_bytes += F * 3 * P * st["n_slots"] + F * (6 + 3 + 3) * st["L"] + F * P * st["K"]
    return ops, n_bytes
