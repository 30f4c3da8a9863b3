"""Per-frame visual-inertial pose optimization.

Replaces Optimizer::PoseInertialOptimizationLastKeyFrame /
PoseInertialOptimizationLastFrame (reference src/Optimizer.cc:7603/:7998):
every tracked frame fuses its Huber-robustified reprojection residuals
with the IMU preintegration factor from the previous frame/keyframe and a
bias random-walk prior. The current frame carries a 15-dim state
[xi_cam(6), v(3), bg(3), ba(3)]; the previous state (pose, velocity) is
held fixed (the LastKeyFrame variant's structure — the reference's
LastFrame variant additionally carries a marginalized prior on the
previous frame, which here is equivalent to re-anchoring on the last
optimized state every frame).

Visual Jacobians are analytic (shared with pose_opt); the 9-dim inertial
residual is differentiated with forward-mode autodiff at delta = 0, like
inertial_ba. Camera-IMU extrinsics T_bc (reference include/ImuTypes.h:71,
Tbc) enter through the body-pose composition T_wb = (T_bc o T_cw)^-1.
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
from multi_orbslam3_jax.opt.inertial_ba import INFO_FLOOR
from multi_orbslam3_jax.opt.pose_opt import _residual_jac

D = 15


class VIPoseResult(NamedTuple):
    pose: jnp.ndarray       # (4, 4) optimized T_cw
    velocity: jnp.ndarray   # (3,) world-frame body velocity
    bg: jnp.ndarray         # (3,)
    ba: jnp.ndarray         # (3,)
    inliers: jnp.ndarray    # (M,) final visual inlier mask
    n_inliers: jnp.ndarray  # () int32
    chi2: jnp.ndarray       # () inertial residual chi2 (diagnostic)


def _vi_residual(d, T_cw, v, bg0, ba0, T_prev_cw, v_prev,
                 pre: Preintegrated, g_w, T_bc):
    """Whitened 9-dim preintegration residual (prev -> cur) as a function
    of the CURRENT frame's 15-dim delta; the previous state is fixed
    (reference EdgeInertial with fixed first vertex, G2oTypes.cc)."""
    T_cur = se3.retract(T_cw, d[:6])
    v_cur = v + d[6:9]
    bg = bg0 + d[9:12]
    ba = ba0 + d[12:15]
    T_wb_i = se3.inverse(se3.compose(T_bc, T_prev_cw))
    T_wb_j = se3.inverse(se3.compose(T_bc, T_cur))
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
    r_v = Ri.T @ (v_cur - v_prev - g_w * dt) - dV
    r_p = Ri.T @ (pj - pi - v_prev * dt - 0.5 * g_w * dt * dt) - dP
    r = jnp.concatenate([r_R, r_v, r_p])
    L = jnp.linalg.cholesky(pre.cov + INFO_FLOOR ** 2 * jnp.eye(9))
    return jax.scipy.linalg.solve_triangular(L, r, lower=True)


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
@robust.f32_matmuls
def pose_inertial_optimization(
        T_init: jnp.ndarray, v_init: jnp.ndarray,
        bg_init: jnp.ndarray, ba_init: jnp.ndarray,
        T_prev: jnp.ndarray, v_prev: jnp.ndarray,
        bg_prev: jnp.ndarray, ba_prev: jnp.ndarray,
        preint: Preintegrated,
        K: cam.PinholeK, p_world: jnp.ndarray, uv_obs: jnp.ndarray,
        inv_sigma2: jnp.ndarray, mask: jnp.ndarray,
        g_w: jnp.ndarray, T_bc: jnp.ndarray,
        rounds: int = 2, iters: int = 5,
        chi2_th: float = robust.CHI2_MONO,
        gyro_walk2: float = (1.9e-5) ** 2,
        acc_walk2: float = (3.0e-3) ** 2) -> VIPoseResult:
    """Optimize the current frame's [pose, velocity, biases] against the
    visual observations (p_world/uv_obs/mask as in pose_optimization) plus
    the preintegration factor from the fixed previous state and a bias
    random-walk prior anchored at the previous biases."""
    zero15 = jnp.zeros(D)
    lm_lambda = 1e-3
    dts = jnp.maximum(preint.dT, 1e-3)
    w_bg = 1.0 / (gyro_walk2 * dts)
    w_ba = 1.0 / (acc_walk2 * dts)

    def gn_iter(_, carry):
        T, v, bg, ba, active = carry
        # visual part (analytic, pose dims only)
        r, J6, behind = _residual_jac(T, K, p_world, uv_obs)
        c2 = jnp.sum(r * r, axis=-1) * inv_sigma2
        w = robust.huber_weight(c2, chi2_th) * inv_sigma2
        w = jnp.where(active & ~behind, w, 0.0)
        H = jnp.zeros((D, D))
        b = jnp.zeros(D)
        H = H.at[:6, :6].set(jnp.einsum("mri,m,mrj->ij", J6, w, J6))
        b = b.at[:6].set(jnp.einsum("mri,m,mr->i", J6, w, r))
        # inertial factor (autodiff at delta = 0)
        args = (T, v, bg, ba, T_prev, v_prev, preint, g_w, T_bc)
        r_in = _vi_residual(zero15, *args)
        J_in = jax.jacfwd(_vi_residual, argnums=0)(zero15, *args)
        H = H + J_in.T @ J_in
        b = b + J_in.T @ r_in
        # bias random-walk prior to the previous state's biases
        # (reference EdgePriorGyro/EdgePriorAcc with InfoG/InfoA)
        H = H.at[9:12, 9:12].add(w_bg * jnp.eye(3))
        H = H.at[12:15, 12:15].add(w_ba * jnp.eye(3))
        b = b.at[9:12].add(w_bg * (bg - bg_prev))
        b = b.at[12:15].add(w_ba * (ba - ba_prev))
        # damped solve with Jacobi equilibration (state mixes pixel-scale
        # and m/s-scale blocks; see inertial_ba for the conditioning note)
        Hd = H + lm_lambda * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(D)
        d = jnp.sqrt(jnp.maximum(jnp.diag(Hd), 1e-12))
        He = Hd / d[:, None] / d[None, :]
        dx = jnp.linalg.solve(He, -b / d) / d
        ok = jnp.all(jnp.isfinite(dx))
        dx = jnp.where(ok, dx, 0.0)
        T_new = se3.normalize(se3.retract(T, dx[:6]))
        return (T_new, v + dx[6:9], bg + dx[9:12], ba + dx[12:15], active)

    def round_body(_, carry):
        T, v, bg, ba, active = carry
        T, v, bg, ba, _ = jax.lax.fori_loop(
            0, iters, gn_iter, (T, v, bg, ba, active))
        r, _, behind = _residual_jac(T, K, p_world, uv_obs)
        c2 = jnp.sum(r * r, axis=-1) * inv_sigma2
        active = mask & (c2 <= chi2_th) & ~behind
        return T, v, bg, ba, active

    T, v, bg, ba, active = jax.lax.fori_loop(
        0, rounds, round_body, (T_init, v_init, bg_init, ba_init, mask))
    r, _, behind = _residual_jac(T, K, p_world, uv_obs)
    c2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    inliers = mask & (c2 <= chi2_th) & ~behind
    r_in = _vi_residual(zero15, T, v, bg, ba, T_prev, v_prev, preint,
                        g_w, T_bc)
    return VIPoseResult(pose=T, velocity=v, bg=bg, ba=ba, inliers=inliers,
                        n_inliers=jnp.sum(inliers.astype(jnp.int32)),
                        chi2=jnp.sum(r_in * r_in))
