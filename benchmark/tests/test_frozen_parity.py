"""The benchmark's frozen copies against the program's originals today, on
the CPU at a small size: the map generator, and the bound arithmetic of an
LM iteration (which counts the problem's valid observations where the
program's `utils/flops.lm_iter_bound` counts its padded layout)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from bundleadjustment_tpu_torch.data.track_scene import make_track_scene as program_scene
from bundleadjustment_tpu_torch.solvers.dense_ba import densify_problem
from bundleadjustment_tpu_torch.utils.flops import lm_iter_bound
from harness import bounds
from harness.scenes import make_track_scene

SIZES = [dict(n_cams=8, n_pts=300, n_obs=1200, n_all=20),
         dict(n_cams=12, n_pts=500, n_obs=2500, n_all=0, width=1200, height=680,
              fx=600.0, fy=600.0)]


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
@pytest.mark.parametrize("size", SIZES)
def test_map_generator_equals_the_program_s(size, seed):
    ours, theirs = make_track_scene(seed=seed, **size), program_scene(seed=seed, **size)
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(theirs, f.name),
                                      err_msg=f.name)


def test_max_track_bounds_the_tracks():
    sc = make_track_scene(n_cams=16, n_pts=400, n_obs=2400, n_all=0, max_track=8, seed=3)
    lengths = np.bincount(sc.pt_idx)
    assert lengths.min() >= 2 and lengths.max() <= 8 and lengths.sum() == 2400


@pytest.mark.parametrize("size", SIZES)
def test_bound_differs_from_the_program_s_by_the_padding(size):
    sc = make_track_scene(seed=1, **size)
    K, L = sc.extr_gt.shape[0], sc.points_gt.shape[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    prob, dropped = densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2, sc.valid,
                                    fixed, L, max_obs=128, device="cpu")
    assert dropped == 0
    name = "NVIDIA H100 80GB HBM3"
    theirs = lm_iter_bound(prob, name)
    st = bounds.problem_stats(sc.cam_idx, sc.pt_idx, fixed, L)
    ops, n_bytes = bounds.iter_work(st)
    assert int(ops) == theirs["ops"]
    # the program's count reads every [L, O] slot of the padded layout (17
    # bytes: camera index, pixel, variance, valid flag) and a landmark
    # validity mask; the problem needs its valid observations only
    O = prob.cam_idx.shape[1]
    assert theirs["bytes"] - n_bytes == bounds.OBS_BYTES * (L * O - st["n_obs"]) + L
    pk = bounds.peaks(name)
    assert bounds.least_s((ops, n_bytes), pk) * 1e3 <= theirs["bound_ms"]
