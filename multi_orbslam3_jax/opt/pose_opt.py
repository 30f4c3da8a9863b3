"""Motion-only pose optimization (frame tracking).

Replaces Optimizer::PoseOptimization (reference src/Optimizer.cc:964):
Gauss-Newton on one SE(3) pose with Huber-robustified reprojection
residuals over a fixed-size masked observation batch. The reference runs
4 rounds of 10 LM iterations with outlier re-classification between
rounds; we mirror that as a fixed (rounds x iters) lax.fori_loop with
inlier masks recomputed each round — no data-dependent control flow.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3, so3
from multi_orbslam3_jax.opt import robust


class PoseOptResult(NamedTuple):
    pose: jnp.ndarray      # (4, 4) optimized T_cw
    inliers: jnp.ndarray   # (M,) bool final inlier classification
    n_inliers: jnp.ndarray  # () int32
    chi2: jnp.ndarray      # () float32 total inlier chi2


def _residual_jac(T: jnp.ndarray, K: cam.PinholeK, p_w: jnp.ndarray,
                  uv: jnp.ndarray, u_r=None, bf=0.0):
    """Residuals (M, R) and Jacobians (M, R, 6) wrt left-perturbation xi on
    T_cw (d p_c = -hat(p_c) omega + v). R=2 mono; R=3 when stereo right-u
    measurements u_r are given (rows zeroed where u_r < 0)."""
    p_c = se3.apply(T, p_w)
    r = cam.project(K, p_c) - uv
    Jproj = cam.project_jacobian(K, p_c)          # (M, 2, 3)
    if u_r is not None:
        st = (u_r >= 0).astype(p_c.dtype)
        z = jnp.maximum(p_c[..., 2], 1e-6)
        ur_pred = K.fx * p_c[..., 0] / z + K.cx - bf / z
        r = jnp.concatenate([r, (st * (ur_pred - u_r))[..., None]], axis=-1)
        J_ur = st[..., None] * jnp.stack(
            [K.fx / z, jnp.zeros_like(z),
             (bf - K.fx * p_c[..., 0]) / (z * z)], axis=-1)
        Jproj = jnp.concatenate([Jproj, J_ur[..., None, :]], axis=-2)
    Jpc = jnp.concatenate([-so3.hat(p_c), jnp.broadcast_to(
        jnp.eye(3, dtype=p_w.dtype), p_c.shape[:-1] + (3, 3))], axis=-1)  # (M,3,6)
    J = Jproj @ Jpc                               # (M, R, 6)
    behind = p_c[..., 2] <= 1e-3
    return r, J, behind


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
@robust.f32_matmuls
def pose_optimization(T_init: jnp.ndarray, K: cam.PinholeK,
                      p_world: jnp.ndarray, uv_obs: jnp.ndarray,
                      inv_sigma2: jnp.ndarray, mask: jnp.ndarray,
                      rounds: int = 4, iters: int = 10,
                      chi2_th: float = robust.CHI2_MONO,
                      u_r=None, bf=0.0) -> PoseOptResult:
    """p_world: (M, 3), uv_obs: (M, 2), inv_sigma2: (M,) per-observation
    information (1/sigma^2 of the keypoint's pyramid level), mask: (M,).
    u_r: optional (M,) stereo right-u (-1 mono) adding the reference's
    stereo edge rows (EdgeStereoSE3ProjectXYZOnlyPose); bf = baseline*fx."""

    lm_lambda = 1e-3
    if u_r is not None:
        chi2_th = jnp.where(u_r >= 0, robust.CHI2_STEREO, chi2_th)

    def gn_iter(_, carry):
        T, active = carry
        r, J, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
        chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
        w = robust.huber_weight(chi2, chi2_th) * inv_sigma2
        w = jnp.where(active & ~behind, w, 0.0)
        H = jnp.einsum("mri,m,mrj->ij", J, w, J)
        b = jnp.einsum("mri,m,mr->i", J, w, r)
        H = H + lm_lambda * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(6)
        dx = jnp.linalg.solve(H, -b)
        T_new = se3.normalize(se3.retract(T, dx))
        ok = jnp.all(jnp.isfinite(dx))
        return jnp.where(ok, T_new, T), active

    def round_body(_, carry):
        T, active = carry
        T, _ = jax.lax.fori_loop(0, iters, gn_iter, (T, active))
        r, _, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
        chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
        active = mask & (chi2 <= chi2_th) & ~behind
        return T, active

    T, active = jax.lax.fori_loop(0, rounds, round_body, (T_init, mask))
    r, _, behind = _residual_jac(T, K, p_world, uv_obs, u_r, bf)
    chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    inliers = mask & (chi2 <= chi2_th) & ~behind
    return PoseOptResult(pose=T, inliers=inliers,
                         n_inliers=jnp.sum(inliers.astype(jnp.int32)),
                         chi2=jnp.sum(jnp.where(inliers, chi2, 0.0)))
