"""Port parity: `vis/poisson.py` against the JAX package, piece by piece on
the same inputs and end to end on the sphere of tests/test_poisson.py.

Bounds: k-NN PCA normals |cos| >= 0.9999 on >= 99% of the points (the
eigenvector's sign is fixed by the viewpoint; k-NN ties may pick another
neighbour); the trilinear splat grid within 1e-5; the spectral solve's chi
within 1e-4 of its largest magnitude; surface nets (a host copy) equal on
the same chi; whole reconstructions within 1% in vertex and face counts
and within tests/test_poisson.py's radius bounds."""

import numpy as np
import pytest
import torch

from bundleadjustment_tpu.vis import mesh as jmesh
from bundleadjustment_tpu.vis import poisson as jp
from bundleadjustment_tpu_torch.vis import mesh as tmesh
from bundleadjustment_tpu_torch.vis import poisson as tp
from torch_port_helpers import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def sphere_cloud(n=3000, r=1.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * r, v


def test_normals_match_jax():
    pts, gt = sphere_cloud(2000)
    ref = jp.estimate_normals(pts, k=12, viewpoints=pts * 3.0)
    got = tp.estimate_normals(pts, k=12, viewpoints=pts * 3.0, chunk=512,
                              device="cpu")
    cos = np.abs((got * ref).sum(1))
    assert (cos >= 0.9999).mean() >= 0.99, np.sort(cos)[:20]
    # oriented toward the viewpoints, as the source orients them
    assert ((got * gt).sum(1) > 0.9).mean() > 0.97
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_splat_solve_and_surface_nets_match_jax():
    pts, nrm = sphere_cloud(3000, seed=2)
    p01, _, _ = jp._to_unit_cube(pts)
    q01, _, _ = tp._to_unit_cube(pts)
    np.testing.assert_array_equal(q01, p01)
    V_ref = np.asarray(jp.splat_normals(p01, nrm, 32))
    V = tp.splat_normals(p01, nrm, 32, device="cpu")
    np.testing.assert_allclose(V.numpy(), V_ref, rtol=0, atol=1e-5)
    # the solve on the same field
    chi_ref = np.asarray(jp.solve_poisson_grid(V_ref))
    chi = tp.solve_poisson_grid(torch.from_numpy(V_ref.copy())).numpy()
    scale = np.abs(chi_ref).max()
    np.testing.assert_allclose(chi / scale, chi_ref / scale, rtol=0, atol=1e-4)
    iso_ref = float(np.mean(jp.sample_trilinear(chi_ref, p01)))
    iso = float(torch.mean(tp.sample_trilinear(torch.from_numpy(chi_ref.copy()), p01)))
    assert abs(iso - iso_ref) <= 1e-12 * max(abs(iso_ref), 1.0)
    verts_ref, faces_ref = jp.surface_nets(chi_ref, iso_ref)
    verts, faces = tp.surface_nets(chi_ref, iso_ref)
    np.testing.assert_array_equal(verts, verts_ref)
    np.testing.assert_array_equal(faces, faces_ref)
    assert len(faces) > 500


@pytest.mark.parametrize("normals", ["exact", "estimated"])
def test_reconstruct_sphere_matches_jax(normals):
    pts, gt = sphere_cloud(3000, seed=0 if normals == "exact" else 1)
    kw = (dict(normals=gt) if normals == "exact" else dict(viewpoints=pts * 3.0))
    ref_v, ref_f = jp.poisson_reconstruct(pts, grid=64, **kw)
    verts, faces = tp.poisson_reconstruct(pts, grid=64, device="cpu", **kw)
    assert abs(len(verts) - len(ref_v)) <= 0.01 * len(ref_v)
    assert abs(len(faces) - len(ref_f)) <= 0.01 * len(ref_f)
    bound = 0.02 if normals == "exact" else 0.03  # tests/test_poisson.py
    r = np.linalg.norm(verts, axis=1)
    assert abs(r.mean() - 1.0) < bound and r.std() < bound
    assert faces.min() >= 0 and faces.max() < len(verts)


def test_map_mesh_poisson_faces_match_jax():
    pts, _ = sphere_cloud(1500, seed=4)
    ref = jmesh.create_map_mesh(pts, cam_poses=[np.eye(4)], faces_type="poisson")
    verts, faces, cols = tmesh.create_map_mesh(pts, cam_poses=[np.eye(4)],
                                               faces_type="poisson", device="cpu")
    assert len(faces) > 500 and len(cols) == len(verts)
    assert abs(len(verts) - len(ref[0])) <= 0.01 * len(ref[0])
    assert abs(len(faces) - len(ref[1])) <= 0.01 * len(ref[1])
