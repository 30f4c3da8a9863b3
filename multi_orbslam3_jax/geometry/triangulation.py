"""Batched two-view triangulation + checks.

Replaces the DLT triangulation inside the reference's
TwoViewReconstruction.cc / LocalMapping::CreateNewMapPoints
(src/LocalMapping.cc:520). Everything is vmapped over N correspondences;
validity is returned as a mask instead of data-dependent branching.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

_EPS = 1e-8


def triangulate_dlt(T1: jnp.ndarray, T2: jnp.ndarray,
                    bearing1: jnp.ndarray, bearing2: jnp.ndarray) -> jnp.ndarray:
    """DLT triangulation from two camera-from-world poses and normalized
    bearings (x, y, 1). Batched: T* (..., 4, 4), bearing* (..., 3) -> (..., 3).

    Solves the 4x4 homogeneous system via the adjugate-based smallest
    singular vector (closed-form 4x4 eigen problem is overkill; we use the
    standard A^T A smallest-eigenvector via two inverse-power iterations,
    which is accurate to float32 for well-conditioned SLAM geometry).
    """
    def rows(T, b):
        # x * P3 - P1 ; y * P3 - P2 with P = T[:3, :4]
        P = T[..., :3, :4]
        r1 = b[..., 0, None] * P[..., 2, :] - P[..., 0, :]
        r2 = b[..., 1, None] * P[..., 2, :] - P[..., 1, :]
        return r1, r2

    a1, a2 = rows(T1, bearing1)
    a3, a4 = rows(T2, bearing2)
    A = jnp.stack([a1, a2, a3, a4], axis=-2)  # (..., 4, 4)
    AtA = jnp.swapaxes(A, -1, -2) @ A
    # smallest eigenvector by inverse power iteration with Tikhonov shift
    eye = jnp.eye(4, dtype=A.dtype)
    shift = 1e-6 * jnp.trace(AtA, axis1=-2, axis2=-1)[..., None, None] * eye
    M = AtA + shift
    x = jnp.ones(A.shape[:-2] + (4,), A.dtype)
    for _ in range(8):
        x = jnp.linalg.solve(M, x[..., None])[..., 0]
        x = x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + _EPS)
    w = x[..., 3]
    w_safe = jnp.where(jnp.abs(w) < _EPS, _EPS, w)
    return x[..., :3] / w_safe[..., None]


def depth_in(T: jnp.ndarray, p_world: jnp.ndarray) -> jnp.ndarray:
    """Depth of world points in camera T (camera-from-world)."""
    return (jnp.einsum("...ij,...j->...i", T[..., :3, :3], p_world)
            + T[..., :3, 3])[..., 2]


def parallax_cos(T1: jnp.ndarray, T2: jnp.ndarray,
                 p_world: jnp.ndarray) -> jnp.ndarray:
    """Cosine of the ray parallax angle (reference uses cos < 0.9998 gates)."""
    c1 = -jnp.einsum("...ji,...j->...i", T1[..., :3, :3], T1[..., :3, 3])
    c2 = -jnp.einsum("...ji,...j->...i", T2[..., :3, :3], T2[..., :3, 3])
    r1 = p_world - c1
    r2 = p_world - c2
    num = jnp.sum(r1 * r2, axis=-1)
    den = jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1) + _EPS
    return num / den


def triangulate_and_check(T1, T2, bearing1, bearing2, K, uv1, uv2,
                          max_reproj_err: float = 5.991,
                          min_parallax_cos: float = 0.9998,
                          K2=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Triangulate + the reference's validity cascade (positive depth in both
    views, reprojection chi2 within threshold, sufficient parallax),
    returned as a mask. max_reproj_err is in squared pixels (chi2 2-dof 95%).
    K2: view-2 intrinsics when the two views come from DIFFERENT cameras
    (heterogeneous agents); defaults to K.
    """
    from multi_orbslam3_jax.geometry import camera as cam

    p = triangulate_dlt(T1, T2, bearing1, bearing2)
    z1 = depth_in(T1, p)
    z2 = depth_in(T2, p)
    pc1 = jnp.einsum("...ij,...j->...i", T1[..., :3, :3], p) + T1[..., :3, 3]
    pc2 = jnp.einsum("...ij,...j->...i", T2[..., :3, :3], p) + T2[..., :3, 3]
    e1 = cam.project(K, pc1) - uv1
    e2 = cam.project(K if K2 is None else K2, pc2) - uv2
    err1 = jnp.sum(e1 * e1, axis=-1)
    err2 = jnp.sum(e2 * e2, axis=-1)
    cosp = parallax_cos(T1, T2, p)
    ok = ((z1 > _EPS) & (z2 > _EPS)
          & (err1 < max_reproj_err) & (err2 < max_reproj_err)
          & (cosp < min_parallax_cos) & jnp.isfinite(p).all(axis=-1))
    return p, ok
