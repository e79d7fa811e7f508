"""The global-BA cells' outputs check against faults of the timed path and
against the control, on the CPU at a size a test run holds: a run driven
through the harness (`cpu_run.drive`, the look for a card skipped) with the
program's solve broken underneath has to come out not correct, and a sound
one correct. The cells run on one card, so no exchange between cards can
be left out."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from cpu_run import drive, small_cell

import bundleadjustment_tpu_torch.solvers.dense_ba as dense_ba
from harness.cell import Cell
from reference import global_ba as ref

CELLS = ["tum_fr1_xyz.global_ba", "replica_room0.global_ba"]
SEED = 2**31 + 4099


def unchanged(solve):
    """A solve that returns its starting state."""
    def run(prob, cams, pts, config, **kw):
        _, _, info = solve(prob, cams, pts, config, **kw)
        return cams.clone(), pts.clone(), info
    return run


def half_left_out(solve):
    """A solve that leaves every other landmark's observations out."""
    def run(prob, cams, pts, config, **kw):
        keep = torch.arange(prob.valid.shape[0], device=prob.valid.device) % 2 == 0
        part = dataclasses.replace(prob, valid=prob.valid & keep[:, None],
                                   pt_valid=prob.pt_valid & keep)
        return solve(part, cams, pts, config, **kw)
    return run


def altered(solve):
    """A solve whose answer has one landmark moved by 1 cm."""
    def run(prob, cams, pts, config, **kw):
        c, p, info = solve(prob, cams, pts, config, **kw)
        p = p.clone()
        p[0, 0] += 0.01
        return c, p, info
    return run


def control(_solve, cost=ref.cost_settings(Cell(CELLS[0]).config)):
    """The control: the reference in TF32 in the program's place."""
    def run(prob, cams, pts, config, **kw):
        ok = prob.valid.cpu().numpy()
        pt_idx, _slot = np.nonzero(ok)
        flat = ref.Problem(prob.K4.cpu(), prob.cam_idx.cpu().numpy()[ok], pt_idx,
                           prob.uv.cpu().numpy()[ok], prob.sigma2.cpu().numpy()[ok],
                           prob.cam_fixed.cpu().numpy(), prob.valid.shape[0], "cpu",
                           ref.Arith("tf32"), **cost)
        R, t, X, info = ref.solve(flat, cams.cpu(), pts.cpu())
        c = torch.cat([ref.R_to_aa(R), t], -1).float()
        return c, X.float(), {"cost": torch.tensor(info["cost"])}
    return run


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = drive(small_cell(workload), SEED)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"cost_excess", "reproj_gap_rms_px", "cam_gap", "pt_gap_rms"}


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered, control])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_caught(monkeypatch, workload, fault):
    monkeypatch.setattr(dense_ba, "dense_ba_solve", fault(dense_ba.dense_ba_solve))
    r = drive(small_cell(workload), SEED)
    failing = [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]
    assert not r["correct"] and failing, r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_three_seeds(monkeypatch, workload, seed):
    monkeypatch.setattr(dense_ba, "dense_ba_solve", control(dense_ba.dense_ba_solve))
    assert not drive(small_cell(workload), seed)["correct"]


@pytest.mark.parametrize("key,value", [
    (("solve", "huber_delta"), 3.0),
    (("solve", "cheirality_penalty"), 1.0e3),
    (("solve", "precision"), {"dtype": "float64", "tf32": False}),
    (("sensor", "cx"), 300.0),
], ids=["huber_delta", "cheirality_penalty", "precision", "principal_point"])
def test_a_setting_the_run_cannot_hold_stops_it(key, value):
    """A configuration the program does not compute as stated (its cost,
    its precision) or the map generator cannot make stops the run."""
    cell = small_cell(CELLS[0])
    cell.config[key[0]][key[1]] = value
    with pytest.raises(ValueError):
        drive(cell, SEED)
