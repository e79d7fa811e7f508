"""Port parity of the tracking microbatch (`track_batch > 1`, the default of
8), on the CPU at 160x120, 200 features, 3 levels, rendered plane frames.

- The pairwise matcher (`match_descriptors_pairwise`: B query sets against
  B train sets in one kernel A call) equals the JAX matcher pair by pair,
  bit for bit.
- The batch step (`track_batch_step`) against the JAX package's
  `_track_batch_jit` on the same numpy inputs: B = 4 frames after a
  gtdepth initialisation, `ba` and `pnp`, the local-map pass on and off,
  both fed the JAX package's bucketed snapshot (1,024 rows, the padding
  invalid). Equal: octave, sigma2, descriptors and validity, the matches
  and their distances, the associations, the first-pass inliers, the
  snapshot hits, their keypoints, the re-solve's inliers and whether it
  won; keypoint positions within 1e-3 px (tests/test_torch_features.py's
  bound). The step's detection equals per-frame `detect_and_describe`
  exactly, the condition for detecting the batch in one pass. Poses (rt,
  rt2) within 1e-4. Each of the step's motion-only solves is also held,
  within 1e-4, to the JAX package's float64 solve of the same problem.
- The port batched against the port one frame at a time, to the JAX
  package's criteria for its own two paths (tests/test_pipeline.py): without
  the local-map pass statuses, keyframes and map size equal and
  trajectories within 1e-3; the pnp guard; with the local-map pass statuses
  and keyframes equal, map sizes within 2%, both ATEs < 0.06 m and within
  0.01 m, guided association counts within 3 a frame.
- The port batched against the JAX package batched, at track_batch 4 and
  8 over 16 frames: statuses and keyframes equal, map sizes within max(2%,
  2), ATEs within 0.01 m (tests/test_torch_pipeline.py's bounds).
- A keyframe in mid-batch: the statuses of the run one frame at a time,
  every frame processed once, and the batch's frames after the keyframe
  discarded and run again.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundleadjustment_tpu.ops import matching as jm
from bundleadjustment_tpu.ops.features import FeatureConfig as JaxFeatureConfig
from bundleadjustment_tpu.pipeline import BundleAdjustmentPipeline as JaxPipeline
from bundleadjustment_tpu.pipeline import PipelineConfig as JaxConfig
from bundleadjustment_tpu.pipeline import driver as jd
from bundleadjustment_tpu.solvers.lm import MotionOnlyConfig as JaxMotionOnlyConfig
from bundleadjustment_tpu_torch.metrics import evaluate_ate
from bundleadjustment_tpu_torch.ops import features as tf
from bundleadjustment_tpu_torch.ops import matching as tm
from bundleadjustment_tpu_torch.pipeline.config import PipelineConfig
from bundleadjustment_tpu_torch.pipeline.driver import (
    BundleAdjustmentPipeline,
    track_batch_step,
)
from test_torch_pipeline import _frames, _run
from torch_port_helpers import as_tensor, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BASE = dict(init_type="gtdepth", n_features=200, n_levels=3, local_ba=False,
            final_ba_outer=1, final_ba_iters=10)
OUT = ("xy", "octave", "sigma2", "desc", "valid", "idx", "dist", "ok", "inl",
       "rt", "hit", "idx2", "inl2", "rt2", "use2")
JAX_SNAPSHOT_ROWS = 1024


def _descs(rng, B, m1, m2):
    t = rng.integers(0, 2**32, (B, m2, 8), dtype=np.uint32)
    q = np.stack([t[b, rng.integers(0, m2, m1)] for b in range(B)])
    q[:, ::2] ^= rng.integers(0, 2**32, q[:, ::2].shape, dtype=np.uint32) \
        & np.uint32(0x00110011)
    t[1, 1::2] = t[1, 0::2]  # ties
    return q, t, rng.random((B, m1)) > 0.1, rng.random((B, m2)) > 0.2


@pytest.mark.parametrize("ratio,max_dist", [(0.7, None), (0.9, 64.0)])
def test_pairwise_matcher_matches_jax(rng, ratio, max_dist):
    q, t, va, vb = _descs(rng, 3, 90, 160)
    vb[2] = False
    got = tm.match_descriptors_pairwise(as_tensor(q), as_tensor(t),
                                        torch.from_numpy(va), torch.from_numpy(vb),
                                        ratio=ratio, max_dist=max_dist)
    assert got[0].shape == (3, 90)
    for b in range(3):
        ref = jm.match_descriptors_fused(jnp.asarray(q[b]), jnp.asarray(t[b]),
                                         jnp.asarray(va[b]), jnp.asarray(vb[b]),
                                         ratio=ratio, max_dist=max_dist,
                                         interpret=True)
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(ref[1]))
    assert (got[0][:2] >= 0).sum() > 40 and (got[0][2] == -1).all()


@pytest.fixture(scope="module")
def scene():
    return _frames(12, 0.05)


def _step_inputs(scene, estimation, tlm):
    """The port pipeline after ref, initialisation and one tracked frame;
    the step's inputs for the next 4 frames with the JAX package's bucketed
    snapshot (the same rows, padded with invalid ones)."""
    _, ds, K4 = scene
    pipe = BundleAdjustmentPipeline(
        PipelineConfig(estimation=estimation, track_local_map=tlm, track_batch=4,
                       **BASE), K4, 160, 120, device="cpu")
    assert [pipe.process_frame(f) for f in ds[:3]] == ["ref", "initialized", "tracked"]
    grays = [f.gray for f in ds[3:7]]
    snap_ids, args, kw = pipe._batch_inputs(grays)
    _, _, kp_ptid = pipe._prev_track
    n, N = len(snap_ids), JAX_SNAPSHOT_ROWS
    if tlm:
        ids, lm_xyz, lm_desc, _ = pipe._tlm_snapshot()
        np.testing.assert_array_equal(ids, snap_ids)
        assert n > 50 and args[6].shape == (n, 3)
    else:
        assert n == 0
        lm_xyz = np.zeros((0, 3), np.float32)
        lm_desc = np.zeros((0, 8), np.uint32)
    pad = lambda a, tail, dt: np.concatenate(  # noqa: E731
        [a.astype(dt), np.zeros((N - n,) + tail, dt)])
    lm_xyz, lm_desc = pad(lm_xyz, (3,), np.float32), pad(lm_desc, (8,), np.uint32)
    lm_valid = np.arange(N) < n
    sid = np.full(len(kp_ptid), N, np.int64)
    has = kp_ptid >= 0
    if tlm:
        sid[has] = np.searchsorted(snap_ids, kp_ptid[has])
    args = list(args)
    args[5:9] = [torch.from_numpy(sid), torch.from_numpy(lm_xyz),
                 as_tensor(lm_desc), torch.from_numpy(lm_valid)]
    return pipe, grays, args, kw


@pytest.mark.parametrize("tlm", [True, False], ids=["tlm", "no_tlm"])
@pytest.mark.parametrize("estimation", ["ba", "pnp"])
def test_step_matches_jax(scene, estimation, tlm):
    pipe, grays, args, kw = _step_inputs(scene, estimation, tlm)
    got = dict(zip(OUT, track_batch_step(*args, **kw)))
    np_ = lambda t: (t.numpy().view(np.uint32)  # noqa: E731
                     if t.dtype == torch.int32 and t.shape[-1] == 8 else t.numpy())
    mc = kw["mcfg"]
    jkw = {k: v for k, v in kw.items() if k not in ("feat_cfg", "mcfg")}
    ref = jd._track_batch_jit(
        *[jnp.asarray(np_(a)) for a in args[:5]],
        jnp.asarray(args[5].numpy().astype(np.int32)),
        *[jnp.asarray(np_(a)) for a in args[6:]],
        feat_cfg=JaxFeatureConfig(n_features=200, n_levels=3),
        mcfg=JaxMotionOnlyConfig(outer_iters=mc.outer_iters,
                                 inner_iters=mc.inner_iters, robust=mc.robust),
        use_pallas=False, **jkw)
    ref = {k: np.asarray(v) for k, v in zip(OUT, ref)}
    assert ref["rt"].shape == (4, 6) and got["rt"].shape == (4, 6)
    np.testing.assert_allclose(got["xy"].numpy(), ref["xy"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["desc"].numpy(), ref["desc"].view(np.int32))
    for k in ("octave", "sigma2", "valid", "idx", "dist", "ok", "inl", "hit",
              "idx2", "inl2", "use2"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    for k in ("rt", "rt2"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert got["ok"].sum(1).min() >= pipe.cfg.min_track_points
    assert bool(got["use2"].any()) == tlm and bool(got["hit"].any()) == tlm
    # the batch's detection is per-frame detection, bit for bit
    for k, g in enumerate(grays):
        one = tf.detect_and_describe(torch.from_numpy(np.asarray(g, np.float32)),
                                     pipe.feat_cfg)
        for name in ("xy", "octave", "sigma2", "desc", "valid"):
            assert torch.equal(got[name][k], getattr(one, name)), (k, name)


@pytest.mark.parametrize("tlm", [True, False], ids=["tlm", "no_tlm"])
@pytest.mark.parametrize("estimation", ["ba", "pnp"])
def test_step_solves_match_jax_float64(scene, estimation, tlm, monkeypatch):
    """Every motion-only solve of the step, frame by frame (the first pass
    and, with the local-map pass, the re-solve), against the JAX package's
    `motion_only_ba` in float64 on the inputs the port's step gave it:
    poses within 1e-4, inliers equal. The float64 solve is the reference
    the float32 solves of both packages approximate: on this scene the
    float32 Huber LM is flat to a few 1e-4 along its weakest direction, so
    two float32 solves of one problem that sum in different orders (the
    JAX package's jitted one and its op-by-op one among them) may differ
    by that much."""
    import jax

    from bundleadjustment_tpu.solvers.lm import motion_only_ba as jax_motion_only_ba
    from bundleadjustment_tpu_torch.pipeline import driver as td

    calls = []

    def record(K4, rt6, X, uv, sigma2, valid, cfg):
        out = port_motion_only_ba(K4, rt6, X, uv, sigma2, valid, cfg)
        calls.append(([a.numpy() for a in (K4, rt6, X, uv, sigma2, valid)], cfg,
                      [o.numpy() for o in out]))
        return out

    port_motion_only_ba = td.motion_only_ba
    monkeypatch.setattr(td, "motion_only_ba", record)
    _, _, args, kw = _step_inputs(scene, estimation, tlm)
    calls.clear()  # the solves of the frames before the batch
    got = dict(zip(OUT, track_batch_step(*args, **kw)))
    assert len(calls) == 4 * (2 if tlm else 1)
    for n, (ins, mc, (rt, inl)) in enumerate(calls):
        k, second = (n // 2, n % 2) if tlm else (n, 0)
        np.testing.assert_array_equal(rt[0], got["rt2" if second else "rt"][k])
        with jax.enable_x64(True):
            ref_rt, ref_inl = jax_motion_only_ba(
                *[jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
                  for a in ins],
                JaxMotionOnlyConfig(outer_iters=mc.outer_iters,
                                    inner_iters=mc.inner_iters, robust=mc.robust))
            ref_rt, ref_inl = np.asarray(ref_rt), np.asarray(ref_inl)
        assert ref_rt.dtype == np.float64
        what = f"frame {k}, {'re-solve' if second else 'first pass'}"
        np.testing.assert_allclose(rt, ref_rt, rtol=0, atol=1e-4, err_msg=what)
        np.testing.assert_array_equal(inl, ref_inl, err_msg=what)


def _track(pipe, ds, frames, batched, finalize=True):
    statuses = (pipe.process_frames(ds) if batched
                else [pipe.process_frame(f) for f in ds])
    if finalize:
        pipe.finalize()
    ts, mats = pipe.trajectory_cam_to_world()
    gt_ts = np.array([f["timestamp"] for f in frames])
    gt_xyz = np.array([f["gt_cam_to_world"][:3, 3] for f in frames])
    return statuses, ts, mats, evaluate_ate(ts, mats[:, :3, 3], gt_ts, gt_xyz)["rmse"]


PER_FRAME = {
    # name: (frames, config, finalize)
    "no_tlm": (12, dict(estimation="ba", track_local_map=False), True),
    "pnp_guard": (10, dict(estimation="pnp", track_local_map=False), False),
    "tlm": (12, dict(estimation="ba", track_local_map=True), True),
}


@pytest.mark.parametrize("case", list(PER_FRAME))
def test_batched_matches_per_frame(case):
    n, extra, finalize = PER_FRAME[case]
    frames, ds, K4 = _frames(n, 0.05)
    pipes = [BundleAdjustmentPipeline(PipelineConfig(track_batch=tb, **BASE, **extra),
                                      K4, 160, 120, device="cpu") for tb in (4, 1)]
    batches = []
    track = pipes[0]._track_batch
    pipes[0]._track_batch = lambda grays: batches.append(len(grays)) or track(grays)
    (st_b, ts_b, m_b, ate_b), (st_1, ts_1, m_1, ate_1) = (
        _track(p, ds, frames, batched, finalize)
        for p, batched in zip(pipes, (True, False)))
    assert batches and max(batches) == 4, batches
    assert st_b == st_1 and len(ts_b) == len(ts_1) == n
    n_b, n_1 = (len(p.map.active_points()) for p in pipes)
    if case != "pnp_guard":
        assert pipes[0].stats["keyframes"] == pipes[1].stats["keyframes"]
    if case == "tlm":
        assert abs(n_b - n_1) <= max(0.02 * n_1, 2), (n_b, n_1)
        assert ate_b < 0.06 and ate_1 < 0.06, (ate_b, ate_1)
        assert abs(ate_b - ate_1) < 0.01, (ate_b, ate_1)
        cnt = [[0 if r.assoc_pt is None else len(r.assoc_pt) for r in p.trajectory]
               for p in pipes]
        assert all(abs(a - b) <= 3 for a, b in zip(*cnt)), cnt
    else:
        assert case == "pnp_guard" or n_b == n_1
        np.testing.assert_allclose(m_b, m_1, atol=1e-3)


@pytest.mark.parametrize("track_batch", [4, 8])
def test_batched_matches_jax_batched(track_batch):
    frames, ds, K4 = _frames(16, 0.05)
    base = dict(BASE, estimation="ba", track_batch=track_batch)
    ref = _run(JaxPipeline(JaxConfig(**base), K4, 160, 120), ds, frames, batched=True)
    pipe = BundleAdjustmentPipeline(PipelineConfig(**base), K4, 160, 120, device="cpu")
    batches = []
    track = pipe._track_batch
    pipe._track_batch = lambda grays: batches.append(len(grays)) or track(grays)
    got = _run(pipe, ds, frames, batched=True)
    assert max(batches) == track_batch, batches
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert abs(got[2] - ref[2]) <= max(0.02 * ref[2], 2), (got[2], ref[2])
    assert abs(got[3] - ref[3]) < 0.01, (got[3], ref[3])


def test_keyframe_mid_batch_reruns_the_rest():
    frames, ds, K4 = _frames(12, 0.05)
    cfg = dict(BASE, estimation="ba", kf_max_interval=3)
    pipe = BundleAdjustmentPipeline(PipelineConfig(track_batch=4, **cfg), K4, 160, 120,
                                    device="cpu")
    ref = BundleAdjustmentPipeline(PipelineConfig(track_batch=1, **cfg), K4, 160, 120,
                                   device="cpu")
    batches, processed = [], []
    track, step = pipe._track_batch, pipe.process_frame
    pipe._track_batch = lambda grays: batches.append(len(grays)) or track(grays)

    def process(frame, precomputed=None, prefeats=None):
        processed.append((frame.index, precomputed is not None))
        return step(frame, precomputed=precomputed, prefeats=prefeats)

    pipe.process_frame = process
    statuses = pipe.process_frames(ds)
    assert statuses == [ref.process_frame(f) for f in ds]
    assert [i for i, _ in processed] == list(range(12))
    # a keyframe inside a batch: the batch delivered fewer frames than it ran
    kf = [i for i, s in enumerate(statuses) if s == "keyframe"]
    assert kf and sum(batches) > sum(pre for _, pre in processed), (batches, statuses)
    assert all(pre for i, pre in processed if i > 1)
