"""The final global BA's LM trials, the port against the JAX package.

Both pipelines run the rendered 160x120 plane sequence of
tests/test_torch_pipeline.py (gtdepth, ba tracking, the dense engine) and
record every solve of `finalize` (the default 3 x 100 final BA). Once the
map has converged, the LM
rejects every trial: its freeze needs an accepted relative decrease below
rtol = 1e-9, under float32 resolution, so lambda grows until the Schur
Cholesky fails, and the NaN step puts every observation behind its camera
(trial cost = the cheirality penalty times the observations). The test
holds the port to that account: each all-behind trial of the port is a
step whose camera solve came back non-finite, and the other way round;
and the JAX package shows all-behind trials too. With `-s` it prints a
summary per package (trials, accepted, all-behind). Marked slow (about
40 s on a CPU, most of it both pipelines' tracking):

    python -m pytest tests/test_torch_final_ba.py -m slow -s
"""

import json

import numpy as np
import pytest

from bundleadjustment_tpu.data.synthetic import render_plane_sequence
from bundleadjustment_tpu.data.tum import FrameData
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline as JaxPipeline
from bundleadjustment_tpu.pipeline import PipelineConfig as JaxConfig
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.pipeline.driver import BundleAdjustmentPipeline
from bundleadjustment_tpu_torch.solvers import dense_kernels
from bundleadjustment_tpu_torch.solvers.lm import CHEIRALITY_PENALTY, LMConfig


def _accepted(cost0, hist, rtol):
    """Accepted [n] bool of an LM run from its seed cost and trial costs, by
    the solvers' rule: a finite cost below the current one, the state
    frozen once an accepted step decreased the cost by less than rtol."""
    cost, done, acc = float(cost0), False, []
    for c in np.asarray(hist, np.float64):
        accept = bool(np.isfinite(c) and c < cost)
        if accept and not done:
            done = (cost - c) / max(cost, 1e-20) < rtol
            cost = c
        acc.append(accept)
    return np.array(acc)


def _final_solves(pipe, ds, steps=None):
    """(n_obs, info) of every solve of `finalize`; `steps` (a list) is
    emptied just before it."""
    for f in ds:
        pipe.process_frame(f)
    if steps is not None:
        steps.clear()
    log, solve = [], pipe._solve_ba

    def wrapped(snap, max_iters):
        info = solve(snap, max_iters)
        log.append((int(np.asarray(snap.valid).sum()), info))
        return info

    pipe._solve_ba = wrapped
    pipe.finalize()
    return log


@pytest.mark.slow
def test_final_ba_all_behind_trials_are_failed_solves(monkeypatch):
    fr, K4 = render_plane_sequence(n_frames=12, width=160, height=120,
                                   motion_step=0.05, fx=150.0, fy=150.0)
    ds = [FrameData(index=i, timestamp=f["timestamp"], gray=f["gray"],
                    depth=f["depth"], rgb=None, gt_cam_to_world=f["gt_cam_to_world"])
          for i, f in enumerate(fr)]
    base = dict(init_type="gtdepth", estimation="ba", n_features=200, n_levels=3,
                local_ba=False, ba_layout="dense_landmark")
    nan_steps = []  # per port LM step: did the camera solve come back non-finite
    # the dense solve's default table; its camera solve (`chol_solve`, the
    # library call) is the one the CPU run takes
    ops = dense_kernels.KERNEL_OPS
    solve_nan = ops.chol_solve

    def counted(S, b):
        x = solve_nan(S, b)
        nan_steps.append(not bool(np.isfinite(x.numpy()).all()))
        return x

    monkeypatch.setattr(dense_kernels, "KERNEL_OPS", ops._replace(chol_solve=counted))
    logs = {"jax": _final_solves(JaxPipeline(JaxConfig(track_batch=1, **base), K4,
                                             160, 120), ds)}
    logs["port"] = _final_solves(BundleAdjustmentPipeline(
        PipelineConfig(**base), K4, 160, 120, device="cpu"), ds, nan_steps)

    rtol = LMConfig().rtol
    behind, accepted = {}, {}
    for name, log in logs.items():
        hist = [np.asarray(info["cost_history"], np.float64) for _, info in log]
        behind[name] = np.concatenate([
            np.isclose(h, CHEIRALITY_PENALTY * n, rtol=1e-6)
            for h, (n, _) in zip(hist, log)])
        accepted[name] = sum(int(_accepted(float(info["cost0"]), h, rtol).sum())
                             for h, (_, info) in zip(hist, log))
    print(json.dumps({name: {"solves": len(logs[name]), "trials": len(behind[name]),
                             "accepted": accepted[name],
                             "all_behind": int(behind[name].sum())}
                      for name in logs} | {"port_non_finite_steps": sum(nan_steps)}))
    assert len(nan_steps) == len(behind["port"])
    np.testing.assert_array_equal(np.array(nan_steps), behind["port"])
    assert behind["port"].any() and behind["jax"].any()
