"""Port parity of the blocked Cholesky solve (kernel E's plain route on the
CPU) against the JAX package's Pallas kernel in interpret mode and against
float64 numpy, and of the dense LM solve with the camera system solved by it.

Tolerances: relative max error < 1e-5 against float64 on S = A A^T + N I
(the bound of tests/test_pallas_chol.py) and between the two packages;
dense solve: cameras atol 5e-4, final cost rtol 1e-3 (the bounds of
tests/test_torch_solvers.py)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bundleadjustment_tpu.data.synthetic import make_synthetic_scene
from bundleadjustment_tpu.solvers import dense_ba as jd
from bundleadjustment_tpu.solvers import lm as jl
from bundleadjustment_tpu.solvers.pallas_chol import pallas_chol_solve
from bundleadjustment_tpu_torch import interop
from bundleadjustment_tpu_torch.solvers import chol as tc
from bundleadjustment_tpu_torch.solvers import dense_ba as td
from bundleadjustment_tpu_torch.solvers import dense_kernels as dk
from bundleadjustment_tpu_torch.solvers.lm import LMConfig

T = torch.from_numpy


def _spd(N, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N)).astype(np.float32)
    S = A @ A.T + N * np.eye(N, dtype=np.float32)
    return S, rng.standard_normal(N).astype(np.float32)


def _rel(x, ref):
    return np.abs(np.asarray(x, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("N", [48, 128, 384])
def test_chol_solve_matches_pallas_and_numpy(N):
    S, b = _spd(N)
    x = tc.chol_solve(T(S), T(b)).numpy()
    x_jax = np.asarray(pallas_chol_solve(jnp.asarray(S), jnp.asarray(b),
                                         interpret=True))
    x64 = np.linalg.solve(S.astype(np.float64), b)
    assert _rel(x, x64) < 1e-5
    assert _rel(x_jax, x64) < 1e-5
    assert _rel(x, x_jax.astype(np.float64)) < 1e-5


@pytest.mark.parametrize("N", [1, 7, 50, 426])
def test_chol_solve_ragged_last_panel(N):
    """N need not be a multiple of 8 (6 x 71 cameras = 426)."""
    S, b = _spd(N, seed=N)
    S0 = S.copy()
    x = tc.chol_solve(T(S), T(b)).numpy()
    assert x.shape == (N,)
    assert _rel(x, np.linalg.solve(S.astype(np.float64), b)) < 1e-5
    np.testing.assert_array_equal(S, S0)  # S is not overwritten


def test_chol8_inv_factors_and_inverts():
    S, _ = _spd(8, seed=3)
    LT, Linv = tc._chol_inv(T(S))
    np.testing.assert_allclose((LT.T @ LT).numpy(), S, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((Linv @ LT.T).numpy(), np.eye(8), atol=1e-5)
    assert torch.equal(LT, torch.triu(LT)) and torch.equal(Linv, torch.tril(Linv))


def test_chol_inv_of_the_kernels_panel_factors_and_inverts():
    """The PxP diagonal factor at kernel E's P: S = A A^T + P I (so
    LT^T LT is held to 1e-5 of S's scale, not of its entries)."""
    S, _ = _spd(tc.PANEL_E, seed=4)
    LT, Linv = tc._chol_inv(T(S))
    np.testing.assert_allclose((LT.T @ LT).numpy(), S, rtol=1e-5,
                               atol=1e-5 * np.abs(S).max())
    np.testing.assert_allclose((Linv @ LT.T).numpy(), np.eye(tc.PANEL_E), atol=1e-5)
    assert torch.equal(LT, torch.triu(LT)) and torch.equal(Linv, torch.tril(Linv))


@functools.lru_cache(maxsize=None)
def _pallas_reference(N):
    """(S, b, x from the JAX package's Pallas kernel in interpret mode, x in
    float64). The Pallas kernel wants N % 8 == 0: a ragged N is padded with
    the identity, whose solution is x padded with zeros."""
    S, b = _spd(N, seed=N)
    Np = -(-N // 8) * 8
    Sp = np.eye(Np, dtype=np.float32)
    Sp[:N, :N] = S
    bp = np.zeros(Np, np.float32)
    bp[:N] = b
    x_jax = np.asarray(pallas_chol_solve(jnp.asarray(Sp), jnp.asarray(bp),
                                         interpret=True))[:N]
    return S, b, x_jax, np.linalg.solve(S.astype(np.float64), b)


@pytest.mark.parametrize("panel", [tc.PANEL, tc.PANEL_E])
@pytest.mark.parametrize("N", [1, 7, 48, 50, 384, 426])
def test_chol_solve_plain_panels_match_pallas_and_numpy(N, panel):
    """The plain version with the reference's panels and with kernel E's,
    including N < P and ragged last panels, against the Pallas kernel and
    float64."""
    S, b, x_jax, x64 = _pallas_reference(N)
    x = tc.chol_solve_plain(T(S), T(b), panel=panel).numpy()
    assert _rel(x, x64) < 1e-5
    assert _rel(x, x_jax.astype(np.float64)) < 1e-5


def _upper_tiles(N, panel, tile):
    """The tiles of the first trailing update that hold an entry on or above
    the diagonal, b's column included, counted one by one."""
    q = min(panel, N)
    return sum(1 for i0 in range(q, N, tile) for k0 in range(q, N + 1, tile)
               if k0 + tile - 1 >= i0)


@pytest.mark.parametrize("N, sms, blocks_per_sm, grid, barriers, ld", [
    (1, 132, 1, 1, 2, 4),          # one panel, nothing trails it
    (48, 132, 1, 1, 5, 52),        # the pipeline's final BA: one block
    (384, 132, 1, 21, 35, 388),    # E's path: fewer tiles than SMs
    (426, 132, 1, 28, 41, 428),    # ragged last panel
    (3600, 132, 1, 132, 338, 3604),  # every SM
    (3600, 132, 2, 264, 338, 3604),
    (3600, 16, 1, 16, 338, 3604),  # a smaller card
])
def test_launch_plan(N, sms, blocks_per_sm, grid, barriers, ld):
    """Kernel E's host-side plan: grid (co-resident blocks, no more than the
    first trailing update has tiles, at least one), panels, barriers (one
    after the copy, two per panel step less the last one's update, one per
    backward step less the last) and scratch ([S | b] rows padded to a
    multiple of 4 floats, and one PxP inverse per panel)."""
    plan = tc.launch_plan(N, sms, blocks_per_sm)
    P = tc.PANEL_E
    panels = -(-N // P)
    assert plan["panel"] == P and plan["panels"] == panels
    assert plan["tiles_first_step"] == _upper_tiles(N, P, tc.TILE)
    assert plan["grid"] == grid
    assert plan["grid_barriers"] == barriers == 1 + 2 * panels - 1 + panels - 1
    assert plan["ld"] == ld and ld % 4 == 0 and ld > N
    assert plan["scratch_floats"] == N * ld + panels * P * P


def _scene():
    sc = make_synthetic_scene(n_cams=8, n_pts=200, pixel_noise=0.3, seed=32)
    cf = np.zeros(8, bool)
    cf[:2] = True
    sc.extr_init[1] = sc.extr_gt[1]
    return sc, cf


def _dense_problem():
    """The 8-camera scene as the port's dense problem on the CPU."""
    sc, cf = _scene()
    dense, _ = td.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                  sc.valid, cf, 200, max_obs=16, device="cpu")
    return dense, T(sc.extr_init), T(sc.points_init)


def test_indefinite_system_is_not_accepted():
    """An indefinite S: the clamped factor returns huge or non-finite values
    (the library call returns NaN), it does not hang, and the LM step that
    uses it is rejected: cameras and cost stay where they were."""
    S, b = _spd(48, seed=5)
    S = S - 2.0 * np.diag(np.diag(S))  # negative diagonal
    x = tc.chol_solve(T(S), T(b))
    assert x.shape == (48,)
    assert not bool(torch.isfinite(x).all()) or float(x.abs().max()) > 1e6

    dense, cams, pts = _dense_problem()
    bad = dk.PLAIN_OPS._replace(chol_solve=lambda S_, b_: tc.chol_solve(-S_, b_))
    out, _, info = td.dense_ba_solve(dense, cams, pts, LMConfig(max_iters=3), ops=bad)
    assert float(info["cost"]) == float(info["cost0"])
    np.testing.assert_array_equal(out.numpy()[2:, 3:], cams.numpy()[2:, 3:])


@pytest.mark.parametrize("robust", [True, False])
def test_dense_solve_with_chol_ops_matches_library_and_jax(robust):
    """10 LM iterations with the camera system solved by `chol_solve_plain`
    (PLAIN_OPS_CHOL) against the library Cholesky (PLAIN_OPS) and against
    the JAX package's dense solve."""
    sc, cf = _scene()
    dense_j, _ = jd.densify_problem(sc.K4, sc.cam_idx, sc.pt_idx, sc.uv, sc.sigma2,
                                    sc.valid, cf, 200, max_obs=16)
    cfg = jl.LMConfig(max_iters=10, robust=robust)
    cams_j, _, info_j = jd.dense_ba_solve(dense_j, jnp.asarray(sc.extr_init),
                                          jnp.asarray(sc.points_init), cfg)
    dense = interop.from_reference(dense_j, device="cpu")
    args = (dense, T(sc.extr_init), T(sc.points_init), interop.from_reference(cfg))
    cams_c, _, info_c = td.dense_ba_solve(*args, ops=dk.PLAIN_OPS_CHOL)
    cams_l, _, info_l = td.dense_ba_solve(*args, ops=dk.PLAIN_OPS)
    for cams_ref, info_ref in ((cams_l.numpy(), info_l), (np.asarray(cams_j), info_j)):
        np.testing.assert_allclose(cams_c.numpy(), cams_ref, atol=5e-4)
        np.testing.assert_allclose(float(info_c["cost"]), float(info_ref["cost"]),
                                   rtol=1e-3)
    assert float(info_c["cost"]) < 0.01 * float(info_c["cost0"])


def test_ops_tables_differ_in_the_solve_only():
    from bundleadjustment_tpu_torch.solvers.schur import cholesky_solve_nan

    assert dk.KERNEL_OPS.chol_solve is cholesky_solve_nan
    assert dk.PLAIN_OPS.chol_solve is cholesky_solve_nan
    assert dk.KERNEL_OPS_CHOL[:-1] == dk.KERNEL_OPS[:-1]
    assert dk.PLAIN_OPS_CHOL[:-1] == dk.PLAIN_OPS[:-1]
    assert dk.KERNEL_OPS_CHOL.chol_solve is tc.chol_solve
    assert dk.PLAIN_OPS_CHOL.chol_solve is tc.chol_solve_plain
