"""Port parity for the windowed global BA (`parallel/windows.py`) and the pose
graph (`parallel/posegraph.py`), on the CPU.

- `make_windows` equal to the JAX package's.
- The pose-graph Jacobians (torch.func.jacfwd under vmap, in float64)
  against the JAX `jax.jacfwd` values of the same edges: float64 atol
  1e-5, float32 atol 1e-4 away from rotations of pi; `solve_pose_graph` on tests/test_posegraph.py's loop
  against the JAX solve: poses atol 1e-4, costs rtol 1e-4.
- `windowed_global_ba` on tests/test_windows.py's synthetic store (12
  cameras, 200 landmarks, window 6, stride 3) against the JAX package's,
  on one rank and on 2 gloo ranks, with the bounds the JAX package holds
  between its own sharded and vmap paths (tests/test_windows.py,
  test_windowed_ba_sharded_matches_vmap): window costs rtol 1e-4, keyframe
  poses rtol 1e-4 / atol 2e-4, landmarks rtol 1e-3 / atol 2e-3.
- The halo exchange: one all-reduce of 16 bytes per global landmark,
  whatever the observation count; an inert dummy window changes no
  window's result and no halo sum.
- `--global-ba windowed` through the CLI.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.geometry import np_se3 as jnp_se3
from bundleadjustment_tpu.mapstate import SceneMap as JaxSceneMap
from bundleadjustment_tpu.parallel import posegraph as jpg
from bundleadjustment_tpu.parallel import windows as jw
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.mapstate.scene import SceneMap
from bundleadjustment_tpu_torch.parallel import multihost
from bundleadjustment_tpu_torch.parallel import posegraph as tpg
from bundleadjustment_tpu_torch.parallel import windows as tw
from bundleadjustment_tpu_torch.solvers.lm import LMConfig
from torch_port_helpers import (  # noqa: F401
    one_thread,
    spawn_ranks,
    synthetic_store,
    windowed_rank,
)

pytestmark = pytest.mark.usefixtures("one_thread")


def test_make_windows_matches_jax():
    for n, w, s in ((5, 10, 5), (20, 10, 5), (12, 6, 3), (13, 6, 3), (71, 10, 5),
                    (3, 10, 5), (11, 4, 1), (30, 7, 7)):
        assert tw.make_windows(n, w, s) == jw.make_windows(n, w, s), (n, w, s)


def _loop(K=20, drift=0.02, seed=0):
    """tests/test_posegraph.py's loop: GT poses on a circle, drifted
    odometry, one exact loop edge of weight 50."""
    rng = np.random.default_rng(seed)
    gt = []
    for k in range(K):
        ang = 2 * np.pi * k / K
        R = jnp_se3.aa_to_R(np.array([0.0, 0.0, ang]))
        gt.append(np.concatenate([[0.0, 0.0, ang],
                                  -R @ np.array([np.cos(ang), np.sin(ang), 0.0])]))
    gt = np.asarray(gt)
    rels = []
    for i in range(K - 1):
        rel = jnp_se3.rt6_compose(gt[i], jnp_se3.rt6_inverse(gt[i + 1]))
        rel[:3] += rng.normal(0, drift, 3)
        rel[3:] += rng.normal(0, drift, 3)
        rels.append(rel)
    poses = [gt[0]]
    for i in range(K - 1):
        poses.append(jnp_se3.rt6_compose(jnp_se3.rt6_inverse(rels[i]), poses[i]))
    loop = jnp_se3.rt6_compose(gt[-1], jnp_se3.rt6_inverse(gt[0]))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    graph = jpg.PoseGraph(
        edge_i=jnp.asarray(np.r_[np.arange(K - 1), K - 1].astype(np.int32)),
        edge_j=jnp.asarray(np.r_[np.arange(1, K), 0].astype(np.int32)),
        rel=jnp.asarray(np.stack(rels + [loop]).astype(np.float32)),
        weight=jnp.asarray(np.array([1.0] * (K - 1) + [50.0], np.float32)),
        valid=jnp.ones(K, bool), node_fixed=jnp.asarray(fixed))
    return graph, np.asarray(poses, np.float32)


def _jax_jacobians(Ti, Tj, Z):
    zero6 = jnp.zeros(6, Ti.dtype)

    def per_edge(ti, tj, z):
        Ji = jax.jacfwd(lambda x: jpg._edge_residual_local(x, zero6, ti, tj, z))(zero6)
        Jj = jax.jacfwd(lambda x: jpg._edge_residual_local(zero6, x, ti, tj, z))(zero6)
        return Ji, Jj

    return [np.asarray(J) for J in jax.jit(jax.vmap(per_edge))(
        jnp.asarray(Ti), jnp.asarray(Tj), jnp.asarray(Z))]


def test_edge_jacobians_match_jax_jacfwd():
    """Against the JAX `jacfwd` in float64 (`jax.enable_x64`) on every edge,
    atol 1e-5, and in float32 on the edges whose node rotations stay below
    3 rad, atol 1e-4. The loop passes through pi: there the float32
    forward-mode tangent of the log map loses its digits (the JAX float32
    value at the node of 3.13 rad is 0.87 off its float64 value)."""
    graph, poses = _loop()
    Ti, Tj = poses[np.asarray(graph.edge_i)], poses[np.asarray(graph.edge_j)]
    Z = np.array(graph.rel)
    got = tpg.edge_jacobians(torch.from_numpy(Ti), torch.from_numpy(Tj),
                             torch.from_numpy(Z))
    with jax.enable_x64(True):
        ref64 = _jax_jacobians(Ti.astype(np.float64), Tj.astype(np.float64),
                               Z.astype(np.float64))
    ref32 = _jax_jacobians(Ti, Tj, Z)
    away = ((np.linalg.norm(Ti[:, :3], axis=1) < 3.0)
            & (np.linalg.norm(Tj[:, :3], axis=1) < 3.0))
    assert 0 < away.sum() < len(away)
    for g, r64, r32 in zip(got, ref64, ref32):
        assert g.dtype == torch.float32 and np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), r64, atol=1e-5)
        np.testing.assert_allclose(g.numpy()[away], r32[away], atol=1e-4)
    np.testing.assert_allclose(
        tpg.edge_residual(torch.from_numpy(Ti), torch.from_numpy(Tj),
                          torch.from_numpy(Z)).numpy(),
        np.asarray(jax.vmap(jpg._edge_residual)(jnp.asarray(Ti), jnp.asarray(Tj),
                                                jnp.asarray(Z))), atol=1e-5)


def test_solve_pose_graph_matches_jax():
    graph, poses = _loop()
    ref_poses, ref = jpg.solve_pose_graph(graph, jnp.asarray(poses))
    got_poses, got = tpg.solve_pose_graph(interop.from_reference(graph, device="cpu"),
                                          torch.from_numpy(poses))
    np.testing.assert_allclose(got_poses.numpy(), np.asarray(ref_poses), atol=1e-4)
    for k in ("cost0", "cost"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4)
    assert float(got["cost"]) < 0.2 * float(got["cost0"])


def _store(map_cls):
    """tests/test_windows.py's `_build_synthetic_store` (12 cameras, 200
    landmarks, seed 21), for either package's map store class."""
    return synthetic_store(map_cls, make_synthetic_scene)


CFG = dict(max_iters=8, solver="dense")


def _check_maps(info, m, info_ref, m_ref):
    assert info["windows"] == info_ref["windows"] >= 2
    np.testing.assert_allclose(info["window_cost"], info_ref["window_cost"],
                               rtol=1e-4)
    np.testing.assert_allclose(m.kf_pose[:12], m_ref.kf_pose[:12], rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(m.active_points(), m_ref.active_points())
    np.testing.assert_allclose(m.pt_pos[m.active_points()],
                               m_ref.pt_pos[m_ref.active_points()], rtol=1e-3,
                               atol=2e-3)


@pytest.fixture(scope="module")
def jax_windowed():
    """The JAX package's windowed global BA of the synthetic store: (info,
    store)."""
    _, m_ref = _store(JaxSceneMap)
    return jw.windowed_global_ba(m_ref, window=6, stride=3), m_ref


def test_windowed_global_ba_matches_jax(jax_windowed):
    info_ref, m_ref = jax_windowed
    sc, m = _store(SceneMap)
    info = tw.windowed_global_ba(m, window=6, stride=3, device="cpu")
    _check_maps(info, m, info_ref, m_ref)
    err = np.linalg.norm(m.kf_pose[:12] - sc.extr_gt, axis=1)
    err0 = np.linalg.norm(sc.extr_init - sc.extr_gt, axis=1)
    assert err.mean() < 0.5 * err0.mean()
    assert all(c1 < c0 for c0, c1 in zip(info["window_cost0"], info["window_cost"]))


def test_windowed_global_ba_two_gloo_ranks_match_jax(jax_windowed, tmp_path):
    info_ref, m_ref = jax_windowed
    spawn_ranks(windowed_rank, 2, (2, str(tmp_path / "rendezvous"), str(tmp_path)))
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    for k in ("poses", "points", "window_cost"):
        np.testing.assert_array_equal(r0[k], r1[k])
    assert int(r0["windows"]) == info_ref["windows"] == 3  # one dummy pads to 4
    np.testing.assert_allclose(r0["window_cost"], info_ref["window_cost"], rtol=1e-4)
    np.testing.assert_allclose(r0["poses"], m_ref.kf_pose[:12], rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(r0["points"], m_ref.pt_pos[m_ref.active_points()],
                               rtol=1e-3, atol=2e-3)
    # the halo: one all-reduce of 16 B per global landmark; the window
    # results: one all-gather
    assert int(r0["all_reduce"]) == 1 and int(r0["all_gather"]) == 1
    assert int(r0["all_reduce_bytes"]) == 16 * int(r0["global_landmarks"])


def _batch(n_obs_pad=0):
    _, m = _store(SceneMap)
    kfs = [int(k) for k in m.active_keyframes()]
    windows = tw.make_windows(len(kfs), 6, 3)
    snaps = [m.snapshot_problem([kfs[i] for i in w], min_obs=2) for w in windows]
    ids = np.unique(np.concatenate([s.pt_ids for s in snaps]))
    batch = tw.stack_windows(snaps, {int(p): g for g, p in enumerate(ids)})
    if n_obs_pad:  # more padded (invalid) observation slots in every window
        for k in ("cam_idx", "pt_idx", "uv", "sigma2", "valid"):
            a = batch[k]
            fill = tw._PAD_FILL[k]
            extra = np.full((a.shape[0], n_obs_pad) + a.shape[2:], fill, a.dtype)
            batch[k] = np.concatenate([a, extra], 1)
    return m.K4, batch, len(ids)


def test_halo_bytes_are_16_per_global_landmark(tmp_path):
    cfg = LMConfig(max_iters=2)
    multihost.init_process_group(0, 1, str(tmp_path / "rdv"), "cpu")
    try:
        for pad in (0, 512):
            K4, batch, G = _batch(pad)
            before = dict(multihost.COLLECTIVES)
            tw.solve_windows(K4, batch, cfg, G, multihost.default_group(), "cpu")
            assert multihost.COLLECTIVES["all_reduce"] - before["all_reduce"] == 1
            assert (multihost.COLLECTIVES["all_reduce_bytes"]
                    - before["all_reduce_bytes"]) == 16 * G
    finally:
        multihost.destroy_process_group()


def test_dummy_window_changes_nothing():
    K4, batch, G = _batch()
    W = len(batch["extr"])
    cfg = LMConfig(**CFG)
    got = tw.solve_windows(K4, batch, cfg, G, device="cpu")
    padded = tw.solve_windows(K4, tw.pad_windows(batch, W + 1), cfg, G, device="cpu")
    np.testing.assert_array_equal(padded[0][:W], got[0])
    for a, b in zip(padded[1:3], got[1:3]):
        np.testing.assert_array_equal(a[:W], b)
    for a, b in zip(padded[3:], got[3:]):
        np.testing.assert_array_equal(a, b)
    assert padded[1][W] == padded[2][W] == 0.0  # the dummy: no cost at all


def test_cli_global_ba_windowed_runs(tmp_path):
    from test_torch_pipeline import _cli_run

    res, _ = _cli_run(tmp_path, "--global-ba", "windowed")
    assert res["frames"] == 6 and res["ate_rmse"] < 0.06
