"""Batched RANSAC PnP for relocalization.

Replaces the reference's PnPsolver (RANSAC EPnP, src/PnPsolver.cc) and
MLPnPsolver (src/MLPnPsolver.cpp, used in Tracking::Relocalization,
src/Tracking.cc:3353): instead of iterative RANSAC with data-dependent
convergence, a fixed batch of 6-point DLT pose hypotheses is evaluated in
parallel (one (12,12) SVD each, vmapped), scored by
reprojection over all correspondences, and the winner is polished with the
robust Gauss-Newton pose optimizer on its inlier set.

The 6-point DLT solves the full projective [R|t] from normalized bearings
and re-projects onto SO(3) by orthogonal Procrustes — equivalent accuracy
class to EPnP for the relocalization use case (coarse pose for a guided
re-track; the fine pose always comes from pose_optimization afterwards).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.opt import pose_opt
from multi_orbslam3_jax.opt import robust


class PnPResult(NamedTuple):
    ok: jnp.ndarray         # () bool
    pose: jnp.ndarray       # (4, 4) T_cw
    inliers: jnp.ndarray    # (M,) bool
    n_inliers: jnp.ndarray  # () int32


def _dlt_pose(X: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(6, 3) world points + (6, 3) unit-plane bearings -> T_cw (4, 4).

    Linear DLT on P = [R|t] followed by Procrustes projection to SO(3).
    """
    Xh = jnp.concatenate([X, jnp.ones((X.shape[0], 1))], axis=1)   # (6, 4)
    x, y = b[:, 0], b[:, 1]
    z = jnp.zeros_like(Xh)
    r1 = jnp.concatenate([Xh, z, -x[:, None] * Xh], axis=1)        # (6, 12)
    r2 = jnp.concatenate([z, Xh, -y[:, None] * Xh], axis=1)
    A = jnp.concatenate([r1, r2], axis=0)                          # (12, 12)
    _, _, Vt = jnp.linalg.svd(A)
    P = Vt[-1].reshape(3, 4)
    # sign: most points in front of the camera
    depth = Xh @ P[2]
    P = P * jnp.where(jnp.sum(jnp.sign(depth)) >= 0, 1.0, -1.0)
    M = P[:, :3]
    U, S, Vt2 = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(U @ Vt2))
    R = U @ jnp.diag(jnp.ones(3).at[2].set(d)) @ Vt2
    scale = jnp.sum(S) / 3.0 * d
    t = P[:, 3] / jnp.maximum(jnp.abs(scale), 1e-12) * jnp.sign(scale)
    T = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)
    return T


@functools.partial(jax.jit, static_argnames=("n_hyp", "refine_rounds",
                                             "refine_iters"))
@robust.f32_matmuls
def pnp_ransac(K: cam.PinholeK, pts3d: jnp.ndarray, uv: jnp.ndarray,
               valid: jnp.ndarray, inv_sigma2: jnp.ndarray,
               key: jnp.ndarray, *, n_hyp: int = 256,
               inlier_px: float = 5.99 ** 0.5 * 2.0,
               min_inliers: int = 12, refine_rounds: int = 3,
               refine_iters: int = 8) -> PnPResult:
    """pts3d: (M, 3) landmark positions; uv: (M, 2) matched pixels;
    valid: (M,) correspondence mask. Returns the RANSAC+GN pose."""
    M = pts3d.shape[0]
    b = cam.unproject(K, uv)
    w = valid.astype(jnp.float32)
    idx = jax.vmap(
        lambda k: jax.random.choice(k, M, (6,), replace=False,
                                    p=w / jnp.maximum(jnp.sum(w), 1.0))
    )(jax.random.split(key, n_hyp))                                # (H, 6)
    Ts = jax.vmap(lambda i: _dlt_pose(pts3d[i], b[i]))(idx)        # (H,4,4)

    p_c = jnp.einsum("hij,mj->hmi", Ts[:, :3, :3], pts3d) + \
        Ts[:, None, :3, 3]                                         # (H, M, 3)
    uv_proj = cam.project(K, p_c)
    err2 = jnp.sum((uv_proj - uv[None]) ** 2, axis=-1)
    inl = (err2 < inlier_px ** 2) & (p_c[..., 2] > 1e-3) & valid[None]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    T0 = Ts[best]
    inliers0 = inl[best]

    res = pose_opt.pose_optimization(
        T0, K, pts3d, uv, inv_sigma2, inliers0,
        rounds=refine_rounds, iters=refine_iters)
    n_in = res.n_inliers
    return PnPResult(ok=n_in >= min_inliers, pose=res.pose,
                     inliers=res.inliers, n_inliers=n_in)
