"""The outputs check of the cell with BAL's camera against faults of the
timed path and against the control, on the CPU at a small map (10 cameras,
300 points, tracks of 2-10): a run driven through the harness with the
program's solve broken underneath has to come out not correct, and a sound
one correct. The faults: a solve that returns its start, one that holds k2
at 0 (the float64 reference with k2 set to 0 and held there, in the
program's place: a solve that drops a distortion term), one landmark moved by 5 cm,
and the control (the reference in TF32 in the program's place)."""

from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch

import bundleadjustment_tpu_torch.solvers.dense_ba as dense_ba
from harness.cell import Cell
from harness.run_cell import run_cell
from reference import bal_ba as ref

CELL = "bal_dubrovnik356.global_ba"
SEED = 2**31 + 4099
SMALL_MAP = {"n_keyframes": 10, "n_landmarks": 300, "n_observations": 1662, "max_track": 10}


def small_cell(**traffic):
    cell = Cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["map"].update(SMALL_MAP)
    cell.traffic = {**cell.traffic, "warmup_solves": 0, **traffic}
    return cell


def drive(cell, seed):
    t0 = time.perf_counter()
    return run_cell(cell, seed, 0.0, False, "cpu", lambda: time.perf_counter() - t0)


def unchanged(solve):
    """A solve that returns its starting state."""
    def run(prob, cams, pts, config, **kw):
        _, _, info = solve(prob, cams, pts, config, **kw)
        return cams.clone(), pts.clone(), info
    return run


def altered(solve):
    """A solve whose answer has one landmark moved by 5 cm."""
    def run(prob, cams, pts, config, **kw):
        c, p, info = solve(prob, cams, pts, config, **kw)
        p = p.clone()
        p[0, 0] += 0.05
        return c, p, info
    return run


def _reference_in_place(arith, hold=()):
    """The reference in the program's place, on the program's problem."""
    cost = ref.cost_settings(Cell(CELL).config)

    def fault(_solve):
        def run(prob, cams, pts, config, **kw):
            ok = prob.valid.cpu().numpy()
            pt_idx, _slot = np.nonzero(ok)
            flat = ref.Problem(prob.cam_idx.cpu().numpy()[ok], pt_idx,
                               prob.uv.cpu().numpy()[ok], prob.sigma2.cpu().numpy()[ok],
                               prob.cam_fixed.cpu().numpy(), prob.valid.shape[0], "cpu",
                               ref.Arith(arith), **cost)
            c0 = cams.cpu().clone()
            c0[:, list(hold)] = 0.0
            c, X, info = ref.solve(flat, c0, pts.cpu(), hold=hold)
            return c.float(), X.float(), {"cost": torch.tensor(info["cost"])}
        return run
    return fault


control = _reference_in_place("tf32")
k2_held_at_0 = _reference_in_place("float64", hold=[8])


def test_sound_run_is_correct():
    r = drive(small_cell(), SEED)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"cost_excess", "reproj_gap_rms_px", "cam_gap", "pt_gap_rms"}


@pytest.mark.parametrize("fault", [unchanged, k2_held_at_0, altered, control],
                         ids=["unchanged", "k2_held_at_0", "altered", "control"])
def test_fault_is_caught(monkeypatch, fault):
    monkeypatch.setattr(dense_ba, "dense_ba_solve", fault(dense_ba.dense_ba_solve))
    r = drive(small_cell(), SEED)
    failing = [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]
    assert not r["correct"] and failing, r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_and_k2_held_fail_on_three_seeds(monkeypatch, seed):
    for fault in (control, k2_held_at_0):
        with monkeypatch.context() as m:
            m.setattr(dense_ba, "dense_ba_solve", fault(dense_ba.dense_ba_solve))
            assert not drive(small_cell(), seed)["correct"]


@pytest.mark.parametrize("key,value", [
    (("solve", "huber_delta"), 3.0),
    (("solve", "cheirality_penalty"), 1.0e3),
    (("solve", "precision"), {"dtype": "float64", "tf32": False}),
    (("map", "generator"), "track_scene"),
], ids=["huber_delta", "cheirality_penalty", "precision", "map_generator"])
def test_a_setting_the_run_cannot_hold_stops_it(key, value):
    cell = small_cell()
    cell.config[key[0]][key[1]] = value
    with pytest.raises(ValueError):
        drive(cell, SEED)


def test_the_parent_program_fails_at_once(monkeypatch):
    """A program whose `densify_problem` takes no camera model (the
    repository before BAL's camera) stops the run at set-up with an error,
    before any solve."""
    real = dense_ba.densify_problem

    def old(*a, camera_model=None, **kw):
        if camera_model is not None:
            raise TypeError("densify_problem() got an unexpected keyword argument "
                            "'camera_model'")
        return real(*a, **kw)

    monkeypatch.setattr(dense_ba, "densify_problem", old)
    with pytest.raises(TypeError):
        drive(small_cell(), SEED)
