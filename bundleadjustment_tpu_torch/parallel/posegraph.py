"""Pose-graph optimisation: stitching local windows into one trajectory.

Port of `bundleadjustment_tpu/parallel/posegraph.py`. Nodes are keyframe
extrinsics (world->camera rt6, [K, 6]); an edge (i, j) carries a measured
relative transform Z_ij ~ T_i o T_j^-1 and a weight; its residual is
r_ij = log(Z_ij^-1 o (T_i o T_j^-1)) in R^6 (rotation log, translation
difference). LM with Gauss-Newton steps: per-edge 6x12 Jacobians with
respect to left perturbations of both nodes by forward-mode autodiff
(`torch.func.jacfwd`, batched over the edges with `torch.func.vmap`, as
the reference's `jax.jacfwd` under `vmap`), normal equations summed per
node with `index_add_`, solved matrix-free by block-Jacobi preconditioned
CG (`solvers/schur.py:pcg`, a fixed `cg_iters`, no host synchronisation). Nodes marked fixed (node 0
by default) anchor the gauge. Edges are padded with a validity mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jacfwd, vmap

from bundleadjustment_tpu_torch.device import resolve_device
from bundleadjustment_tpu_torch.geometry.se3 import aa_to_rotmat, rotmat_to_aa
from bundleadjustment_tpu_torch.solvers.schur import block_jacobi, pcg


@dataclass
class PoseGraph:
    edge_i: torch.Tensor  # [E] int64
    edge_j: torch.Tensor  # [E] int64
    rel: torch.Tensor  # [E, 6] measured T_i o T_j^-1
    weight: torch.Tensor  # [E]
    valid: torch.Tensor  # [E] bool
    node_fixed: torch.Tensor  # [K] bool


def edge_residual(Ti, Tj, Zij):
    """r = log(Z^-1 o (Ti o Tj^-1)) as [..., 6] (aa, t)."""
    Ri = aa_to_rotmat(Ti[..., :3])
    Rj = aa_to_rotmat(Tj[..., :3])
    Rz = aa_to_rotmat(Zij[..., :3])
    R_ij = Ri @ Rj.transpose(-1, -2)
    t_ij = Ti[..., 3:] - (R_ij @ Tj[..., 3:, None])[..., 0]
    RzT = Rz.transpose(-1, -2)
    R_e = RzT @ R_ij
    t_e = (RzT @ (t_ij - Zij[..., 3:])[..., None])[..., 0]
    return torch.cat([rotmat_to_aa(R_e), t_e], -1)


def _perturb(x, T):
    """Left perturbation of T by x in R^6 (rotation composed, translation
    added)."""
    return torch.cat([rotmat_to_aa(aa_to_rotmat(x[:3]) @ aa_to_rotmat(T[:3])),
                      T[3:] + x[3:]])


def edge_residual_local(xi, xj, Ti, Tj, Zij):
    """The residual as a function of local left-perturbations xi, xj."""
    return edge_residual(_perturb(xi, Ti), _perturb(xj, Tj), Zij)


def edge_jacobians(Ti, Tj, Z):
    """d r / d xi and d r / d xj at xi = xj = 0, each [E, 6, 6] in the
    poses' dtype. Differentiated in float64: under vmap a sample's
    rotation angle is a 0-d tensor, and the forward-mode tangent of a 0-d
    float32 tensor plus a Python float comes out float64, which the float32
    rotation products then refuse."""
    dt = Ti.dtype
    Ti, Tj, Z = Ti.double(), Tj.double(), Z.double()
    zero6 = torch.zeros(6, dtype=torch.float64, device=Ti.device)

    def per_edge(ti, tj, z):
        Ji = jacfwd(lambda x: edge_residual_local(x, zero6, ti, tj, z))(zero6)
        Jj = jacfwd(lambda x: edge_residual_local(zero6, x, ti, tj, z))(zero6)
        return Ji, Jj

    Ji, Jj = vmap(per_edge)(Ti, Tj, Z)
    return Ji.to(dt), Jj.to(dt)


def solve_pose_graph(graph: PoseGraph, poses0, max_iters=20, cg_iters=50,
                     lam0=1e-6):
    """LM pose-graph solve from poses0 [K, 6]. Returns (poses [K, 6], info)
    with info's values as device tensors."""
    K = poses0.shape[0]
    dev, dt_ = poses0.device, poses0.dtype
    ei, ej = graph.edge_i, graph.edge_j
    zero = torch.zeros((), dtype=dt_, device=dev)
    fixed = graph.node_fixed[:, None]
    w = torch.where(graph.valid, graph.weight, zero)
    sw = torch.sqrt(w)

    def residuals(poses):
        return edge_residual(poses[ei], poses[ej], graph.rel) * sw[:, None]

    def cost_of(poses):
        r = residuals(poses)
        return torch.sum(r * r)

    def to_nodes(xi, xj):
        return (torch.zeros((K,) + xi.shape[1:], dtype=dt_, device=dev)
                .index_add_(0, ei, xi).index_add_(0, ej, xj))

    eye6 = torch.eye(6, dtype=dt_, device=dev)
    poses = poses0
    cost = cost_of(poses)
    cost0 = cost
    lam = torch.tensor(lam0, dtype=dt_, device=dev)
    nu = torch.tensor(2.0, dtype=dt_, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    hist = []
    for _ in range(max_iters):
        r = residuals(poses)
        Ji, Jj = edge_jacobians(poses[ei], poses[ej], graph.rel)
        Ji = torch.where(graph.node_fixed[ei][:, None, None], zero,
                         Ji * sw[:, None, None])
        Jj = torch.where(graph.node_fixed[ej][:, None, None], zero,
                         Jj * sw[:, None, None])
        g = to_nodes(torch.einsum("eri,er->ei", Ji, r),
                     torch.einsum("eri,er->ei", Jj, r))
        D = to_nodes(torch.einsum("eri,erj->eij", Ji, Ji),
                     torch.einsum("eri,erj->eij", Jj, Jj))
        dD = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-8)
        D_damped = D + (lam * dD)[..., None] * eye6
        D_damped = torch.where(graph.node_fixed[:, None, None], eye6, D_damped)
        Minv = block_jacobi(D_damped)

        def matvec(x):
            y = (torch.einsum("eri,ei->er", Ji, x[ei])
                 + torch.einsum("eri,ei->er", Jj, x[ej]))
            out = to_nodes(torch.einsum("eri,er->ei", Ji, y),
                           torch.einsum("eri,er->ei", Jj, y))
            out = out + (lam * dD) * x  # Marquardt damping
            return torch.where(fixed, x, out)  # gauge pinning

        x = pcg(matvec, torch.where(fixed, zero, -g), Minv, cg_iters)

        dphi = torch.where(fixed, zero, x[:, :3])
        dt = torch.where(fixed, zero, x[:, 3:])
        R_new = aa_to_rotmat(dphi) @ aa_to_rotmat(poses[:, :3])
        poses_new = torch.cat([rotmat_to_aa(R_new), poses[:, 3:] + dt], -1)
        new_cost = cost_of(poses_new)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        take = accept & ~done
        rel_dec = (cost - new_cost) / torch.clamp(cost, min=1e-20)
        poses = torch.where(take, poses_new, poses)
        lam, nu = (
            torch.where(done, lam, torch.where(accept, lam / 3.0, lam * nu)),
            torch.where(done, nu, torch.where(accept, torch.full_like(nu, 2.0),
                                              nu * 2.0)),
        )
        cost = torch.where(take, new_cost, cost)
        done = done | (accept & (rel_dec < 1e-10))
        hist.append(new_cost)
    info = {"cost0": cost0, "cost": cost,
            "cost_history": torch.stack(hist) if hist else cost[None][:0]}
    return poses, info


def make_pose_graph(edge_i, edge_j, rel, weight, node_fixed, device="cuda"):
    """A PoseGraph on `device` from host lists / arrays (every edge valid)."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, dtype)).to(device)

    return PoseGraph(edge_i=t(edge_i, np.int64), edge_j=t(edge_j, np.int64),
                     rel=t(np.asarray(rel, np.float32).reshape(-1, 6), np.float32),
                     weight=t(weight, np.float32),
                     valid=torch.ones(len(edge_i), dtype=torch.bool, device=device),
                     node_fixed=t(node_fixed, bool))
