"""Visual-inertial initialization: gravity direction, scale, biases,
velocities from a visually-tracked keyframe chain.

Replaces Optimizer::InertialOptimization (reference src/Optimizer.cc:5344,
:5534, :5696 — the stage-1/2 solves behind LocalMapping::InitializeIMU,
src/LocalMapping.cc:1390-1585). Poses stay fixed (visual odometry is
trusted up to scale); the solver estimates

    theta = [alpha, beta (gravity tilt), log s, bg(3), ba(3), v_0..K-1]

by Gauss-Newton on the 9-dim preintegration residuals between consecutive
keyframes, with Jacobians from forward-mode autodiff over the packed
parameter vector — the problem is tiny (9 + 3K parameters), so one jacfwd
of the full residual stack replaces g2o's vertex/edge machinery.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import so3
from multi_orbslam3_jax.imu.preintegration import Preintegrated
from multi_orbslam3_jax.opt import robust


class InertialInitResult(NamedTuple):
    R_wg: jnp.ndarray     # (3, 3) gravity-aligning rotation (g_w = R_wg g0)
    scale: jnp.ndarray    # () map scale correction
    bg: jnp.ndarray       # (3,)
    ba: jnp.ndarray       # (3,)
    velocities: jnp.ndarray  # (K, 3) world-frame body velocities
    chi2: jnp.ndarray     # () mean residual chi2


def _residuals(theta, R_wb, p_wb, preints: Preintegrated, G,
               floor=(1e-3, 1e-3, 1e-3)):
    """Stacked 9-dim residuals over K-1 consecutive pairs. `floor` is the
    (rot, vel, pos) visual-pose noise added to the preintegration
    covariance before whitening — callers with noisy SLAM poses pass
    cm-level values, unit tests with exact poses keep the default."""
    K = R_wb.shape[0]
    alpha, beta = theta[0], theta[1]
    s = jnp.exp(theta[2])
    bg = theta[3:6]
    ba = theta[6:9]
    v = theta[9:].reshape(K, 3)
    R_gw_correction = so3.exp(jnp.stack([alpha, beta, jnp.zeros_like(alpha)]))
    g_w = R_gw_correction @ jnp.array([0.0, 0.0, -1.0]) * G

    def pair(i):
        Ri = R_wb[i]
        Rj = R_wb[i + 1]
        dbg = bg - preints.bg[i]
        dba = ba - preints.ba[i]
        dt = preints.dT[i + 1]
        pre_dR = preints.dR[i + 1] @ so3.exp(preints.JRg[i + 1] @ dbg)
        pre_dV = preints.dV[i + 1] + preints.JVg[i + 1] @ dbg \
            + preints.JVa[i + 1] @ dba
        pre_dP = preints.dP[i + 1] + preints.JPg[i + 1] @ dbg \
            + preints.JPa[i + 1] @ dba
        r_R = so3.log(pre_dR.T @ Ri.T @ Rj)
        r_v = Ri.T @ (v[i + 1] - v[i] - g_w * dt) - pre_dV
        r_p = Ri.T @ (s * (p_wb[i + 1] - p_wb[i]) - v[i] * dt
                      - 0.5 * g_w * dt * dt) - pre_dP
        r = jnp.concatenate([r_R, r_v, r_p])
        # whiten with the preintegration information (the reference weights
        # EdgeInertialGS with Preintegrated::GetInformationMatrix) plus a
        # visual-pose noise floor: without it the near-singular whitening
        # turns pose noise into a rugged landscape
        fl = jnp.diag(jnp.asarray([floor[0]] * 3 + [floor[1]] * 3
                                  + [floor[2]] * 3) ** 2)
        L = jnp.linalg.cholesky(preints.cov[i + 1] + fl)
        return jax.scipy.linalg.solve_triangular(L, r, lower=True)

    return jax.vmap(pair)(jnp.arange(K - 1)).reshape(-1)


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale", "pose_sigma"))
@robust.f32_matmuls
def inertial_init(R_wb: jnp.ndarray, p_wb: jnp.ndarray,
                  preints: Preintegrated, G: float = 9.81,
                  prior_bg: float = 1e2, prior_ba: float = 1e5,
                  iters: int = 20,
                  fix_scale: bool = False,
                  pose_sigma=(1e-3, 1e-3, 1e-3)) -> InertialInitResult:
    """R_wb/p_wb: (K, 3, 3)/(K, 3) world-from-body keyframe poses (visual,
    arbitrary scale). preints: stacked Preintegrated with leading axis K —
    entry i holds the window from KF i-1 to KF i (entry 0 unused).
    """
    K = R_wb.shape[0]
    n_param = 9 + 3 * K

    # gravity-direction seed from accumulated velocity deltas (the
    # reference's dirG estimate in LocalMapping::InitializeIMU): in the
    # visual frame, sum_i R_i dV_i = v_K - v_0 - g*T ~ -g * total_time,
    # so gravity points along the NEGATIVE accumulated delta
    dirG = -jnp.sum(jnp.einsum("kij,kj->ki", R_wb[:-1], preints.dV[1:]),
                    axis=0)
    dirG = dirG / (jnp.linalg.norm(dirG) + 1e-9)
    g0 = jnp.array([0.0, 0.0, -1.0])
    axis = jnp.cross(g0, dirG)
    sin_a = jnp.linalg.norm(axis)
    cos_a = jnp.dot(g0, dirG)
    ang = jnp.arctan2(sin_a, cos_a)
    w_seed = axis / (sin_a + 1e-9) * ang   # only (x, y) enter the model

    # parameter prior weights (bias random-walk priors, reference
    # EdgePriorGyro/EdgePriorAcc)
    prior = jnp.zeros(n_param)
    prior = prior.at[3:6].set(prior_bg).at[6:9].set(prior_ba)
    if fix_scale:
        prior = prior.at[2].set(1e12)

    def solve_from(log_s0):
        theta0 = jnp.zeros(n_param)
        theta0 = theta0.at[0].set(w_seed[0]).at[1].set(w_seed[1])
        theta0 = theta0.at[2].set(log_s0)
        dts = jnp.maximum(preints.dT[1:], 1e-3)
        v_init = jnp.exp(log_s0) * (p_wb[1:] - p_wb[:-1]) / dts[:, None]
        v_init = jnp.concatenate([v_init[:1], v_init], axis=0)
        theta0 = theta0.at[9:].set(v_init.reshape(-1))

        def gn(_, theta):
            r = _residuals(theta, R_wb, p_wb, preints, G, pose_sigma)
            J = jax.jacfwd(_residuals)(theta, R_wb, p_wb, preints, G,
                                       pose_sigma)
            H = J.T @ J + jnp.diag(prior) + 1e-6 * jnp.eye(n_param)
            g = J.T @ r + prior * theta
            d = jnp.linalg.solve(H, -g)
            d = jnp.where(jnp.isfinite(d), d, 0.0)
            theta = theta + d
            # keep log-scale in a sane bracket (degenerate motions are
            # scale-flat; unbounded drift poisons the multi-start argmin)
            return theta.at[2].set(jnp.clip(theta[2], -4.0, 5.0))

        theta = jax.lax.fori_loop(0, iters, gn, theta0)
        r = _residuals(theta, R_wb, p_wb, preints, G, pose_sigma)
        return theta, jnp.mean(r * r)

    # multi-start over scale: the joint (scale, gravity, velocity) landscape
    # has local minima for gently-excited trajectories; a vmapped GN from
    # log-spaced scale seeds is cheap and reliably brackets the optimum
    if fix_scale:
        seeds = jnp.asarray([0.0])
    else:
        seeds = jnp.log(jnp.asarray([0.25, 1.0, 4.0, 16.0, 64.0]))
    thetas, chi2s = jax.vmap(solve_from)(seeds)
    best = jnp.argmin(chi2s)
    theta = thetas[best]
    R_wg = so3.exp(jnp.stack([theta[0], theta[1], jnp.zeros(())]))
    return InertialInitResult(
        R_wg=R_wg, scale=jnp.exp(theta[2]), bg=theta[3:6], ba=theta[6:9],
        velocities=theta[9:].reshape(K, 3),
        chi2=chi2s[best])
