"""Sim(3) pose-graph optimization (essential graph).

Replaces Optimizer::OptimizeEssentialGraph (reference src/Optimizer.cc:2413
7-DoF; :2749 6-DoF; the 4-DoF inertial variant is a parameterization mask
here instead of a separate vertex class): nodes are Sim3 poses, edges are
relative-pose measurements from the spanning tree, strong-covisibility
pairs, and loop/merge constraints.

Formulation: per-edge residual r = log(S_ij * S_j * S_i^-1) with
Jacobians from vmapped forward-mode autodiff at delta = 0 (14 columns of a
7-vector — cheaper than hand-deriving the Sim3 right Jacobian and immune
to its sign conventions); the normal system is assembled by scatter-add of
7x7 blocks and solved dense — at the 512-KF cap that is a 3584^2
Cholesky.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import sim3
from multi_orbslam3_jax.opt import robust


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity edge list. S_ij is the measured relative transform
    satisfying S_ij = S_i * S_j^-1 at measurement time (so the residual
    log(S_ij * S_j * S_i^-1) vanishes at consistency)."""

    i: jnp.ndarray        # (E,) int32
    j: jnp.ndarray        # (E,) int32
    S_ij: jnp.ndarray     # (E, 13) packed Sim3 (sim3.stack layout)
    weight: jnp.ndarray   # (E,) float32
    valid: jnp.ndarray    # (E,) bool


def make_edges(S_nodes: jnp.ndarray, i: jnp.ndarray, j: jnp.ndarray,
               weight: jnp.ndarray, valid: jnp.ndarray) -> PoseGraphEdges:
    """Measure current relative transforms between node pairs (the way the
    reference builds spanning-tree/covisibility edges before correction)."""
    Si = sim3.unstack(S_nodes[i])
    Sj = sim3.unstack(S_nodes[j])
    S_ij = sim3.compose(Si, sim3.inverse(Sj))
    return PoseGraphEdges(i=i, j=j, S_ij=sim3.stack(S_ij), weight=weight,
                          valid=valid)


def _retract(S: sim3.Sim3, zeta, right: bool) -> sim3.Sim3:
    """Left (camera-frame) or right (world-frame) perturbation. The 4-DoF
    inertial mode needs the RIGHT side: nodes are S_cw, so a right
    perturbation acts on WORLD coordinates, where "rotation about z only"
    is exactly the gravity-preserving yaw the reference's
    VertexPose4DoF/Edge4DoF parameterize (Optimizer.cc:8430)."""
    if right:
        return sim3.compose(S, sim3.exp(zeta))
    return sim3.compose(sim3.exp(zeta), S)


def _edge_residual(S_ij_flat, Si_flat, Sj_flat, di, dj, right=False):
    Si = _retract(sim3.unstack(Si_flat), di, right)
    Sj = _retract(sim3.unstack(Sj_flat), dj, right)
    return sim3.log(sim3.compose(sim3.compose(sim3.unstack(S_ij_flat), Sj),
                                 sim3.inverse(Si)))


@functools.partial(jax.jit, static_argnames=("iters", "yaw_only", "solver",
                                             "cg_iters"))
@robust.f32_matmuls
def optimize_pose_graph(S_nodes: jnp.ndarray, fixed: jnp.ndarray,
                        edges: PoseGraphEdges, iters: int = 15,
                        fix_scale: bool | jnp.ndarray = False,
                        yaw_only: bool = False, solver: str = "auto",
                        cg_iters: int = 60) -> jnp.ndarray:
    """S_nodes: (K, 13) packed Sim3; fixed: (K,) bool.

    fix_scale: freeze the scale DoF (6-DoF mode, stereo/RGBD maps).
    yaw_only: additionally freeze roll/pitch (the reference's 4-DoF
    inertial pose graph, Optimizer::OptimizeEssentialGraph4DoF) — gravity
    direction is observable with an IMU so only yaw + translation float.
    In this mode the perturbation switches to the RIGHT (world) side so
    the zeroed omega_x/omega_y really are world roll/pitch: the corrected
    poses satisfy R_new z = R_old z (gravity column invariant).

    solver: "dense" materializes H (K*7)^2 and Cholesky-solves — right for
    client-scale maps (K<=512 -> 3584^2). "cg" never
    materializes H: per-edge 7x7 blocks + scatter-add matvec inside a
    block-Jacobi-preconditioned conjugate-gradient loop — the server
    arena at 2048+ slots would need an 822 MB dense Hessian (the
    reference's g2o is sparse for the same reason, Optimizer.cc:2413
    operates on spanning tree + covisibility edges only). "auto" picks
    cg when K*7 > 4096.
    """
    K = S_nodes.shape[0]
    if solver == "auto":
        solver = "cg" if K * 7 > 4096 else "dense"
    zero = jnp.zeros(7)

    # DoF mask over (omega_x, omega_y, omega_z, v, sigma)
    dof = jnp.ones(7)
    if yaw_only:
        dof = dof.at[0].set(0.0).at[1].set(0.0)
    dof = dof * jnp.where(jnp.asarray(fix_scale), jnp.ones(7).at[6].set(0.0),
                          jnp.ones(7))

    def build_and_solve(S_cur):
        Si_flat = S_cur[edges.i]
        Sj_flat = S_cur[edges.j]

        def one(S_ij_f, Si_f, Sj_f):
            r = _edge_residual(S_ij_f, Si_f, Sj_f, zero, zero, yaw_only)
            Ji = jax.jacfwd(_edge_residual, argnums=3)(S_ij_f, Si_f, Sj_f,
                                                       zero, zero, yaw_only)
            Jj = jax.jacfwd(_edge_residual, argnums=4)(S_ij_f, Si_f, Sj_f,
                                                       zero, zero, yaw_only)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(one)(edges.S_ij, Si_flat, Sj_flat)   # (E,7) ...
        w = jnp.where(edges.valid, edges.weight, 0.0)
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        free = (~fixed).astype(jnp.float32)[:, None] * dof[None, :]  # (K,7)
        b = jnp.zeros((K, 7))
        b = b.at[edges.i].add(jnp.einsum("eri,er->ei", Jiw, r))
        b = b.at[edges.j].add(jnp.einsum("eri,er->ei", Jjw, r))
        bf = b * free

        if solver == "dense":
            H = jnp.zeros((K, 7, K, 7))
            H = H.at[edges.i, :, edges.i, :].add(
                jnp.einsum("eri,erj->eij", Ji, Jiw))
            H = H.at[edges.j, :, edges.j, :].add(
                jnp.einsum("eri,erj->eij", Jj, Jjw))
            H = H.at[edges.i, :, edges.j, :].add(
                jnp.einsum("eri,erj->eij", Ji, Jjw))
            H = H.at[edges.j, :, edges.i, :].add(
                jnp.einsum("eri,erj->eij", Jj, Jiw))
            # clamp fixed nodes and disabled DoFs
            H = H * free[:, :, None, None] * free[None, None, :, :]
            Hf = H.reshape(K * 7, K * 7)
            ff = free.reshape(-1)
            Hf = Hf + jnp.diag(jnp.where(ff > 0, 1e-6, 1.0))
            Hf = Hf + 1e-5 * jnp.diag(jnp.diag(Hf))
            d = jnp.linalg.solve(Hf, -bf.reshape(-1)).reshape(K, 7) * free
        else:
            # block-sparse PCG: per-edge 7x7 blocks, scatter-add matvec
            Hii = jnp.einsum("eri,erj->eij", Ji, Jiw)      # (E, 7, 7)
            Hjj = jnp.einsum("eri,erj->eij", Jj, Jjw)
            Hij = jnp.einsum("eri,erj->eij", Ji, Jjw)
            Hji = jnp.einsum("eri,erj->eij", Jj, Jiw)
            # block-Jacobi preconditioner from the node diagonal blocks
            D = jnp.zeros((K, 7, 7)).at[edges.i].add(Hii)
            D = D.at[edges.j].add(Hjj)
            D = D * free[:, :, None] * free[:, None, :]
            diag = jnp.diagonal(D, axis1=-2, axis2=-1)
            D = D + jax.vmap(jnp.diag)(
                1e-5 * diag + jnp.where(free > 0, 1e-6, 1.0))
            D_inv = jnp.linalg.inv(D)

            def matvec(x):                                  # x: (K, 7)
                xm = x * free
                xi = xm[edges.i]
                xj = xm[edges.j]
                y = jnp.zeros((K, 7))
                y = y.at[edges.i].add(
                    jnp.einsum("eij,ej->ei", Hii, xi)
                    + jnp.einsum("eij,ej->ei", Hij, xj))
                y = y.at[edges.j].add(
                    jnp.einsum("eij,ej->ei", Hjj, xj)
                    + jnp.einsum("eij,ej->ei", Hji, xi))
                y = y * free
                # damping + identity on clamped dims keeps PD
                return y + 1e-5 * (jnp.abs(diag) + 1.0) * xm \
                    + jnp.where(free > 0, 0.0, 1.0) * x

            rhs = -bf

            def prec(x):
                return jnp.einsum("kij,kj->ki", D_inv, x)

            def cg_body(_, st):
                x, rr, p, rz = st
                Ap = matvec(p)
                denom = jnp.sum(p * Ap)
                alpha = rz / jnp.maximum(denom, 1e-20)
                x = x + alpha * p
                rr = rr - alpha * Ap
                z = prec(rr)
                rz_new = jnp.sum(rr * z)
                beta = rz_new / jnp.maximum(rz, 1e-20)
                return x, rr, z + beta * p, rz_new

            x0 = jnp.zeros((K, 7))
            r0 = rhs
            z0 = prec(r0)
            x, _, _, _ = jax.lax.fori_loop(
                0, cg_iters, cg_body, (x0, r0, z0, jnp.sum(r0 * z0)))
            d = x * free
        d = jnp.where(jnp.isfinite(d), d, 0.0)
        return sim3.stack(_retract(sim3.unstack(S_cur), d, yaw_only))

    def body(_, S_cur):
        return build_and_solve(S_cur)

    return jax.lax.fori_loop(0, iters, body, S_nodes)
