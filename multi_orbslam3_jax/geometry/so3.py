"""SO(3) ops: hat/vee, exp/log, right Jacobian.

Replaces the reference's hand-rolled SO3 helpers (src/ImuTypes.cc
``ExpSO3/LogSO3/RightJacobianSO3``, include/ImuTypes.h:261-270) with
batchable closed forms. All functions broadcast over leading axes and are
float32-safe: Taylor fallbacks switch at theta ~ 1e-4.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8
_SMALL = 1e-4


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta < _SMALL
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallback
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 3) rotation vector.

    Autodiff-safe at the identity (pose-graph Jacobians are taken here):
    theta comes from atan2(|skew|, cos) with the double-where guard on the
    norm, and the small-angle branch is a polynomial in sin^2 only.
    """
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    c = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    s2 = jnp.sum(w_skew * w_skew, axis=-1)           # = sin^2(theta)
    small = s2 < 1e-10
    s_safe = jnp.sqrt(jnp.where(small, 1.0, s2))
    theta = jnp.arctan2(s_safe, c)
    # theta / sin(theta); near theta=0: 1 + theta^2/6 ~ 1 + s2/6
    scale = jnp.where(small, 1.0 + s2 / 6.0, theta / s_safe)
    w = scale[..., None] * w_skew

    # near pi (sin ~ 0, cos < 0): axis from the diagonal of (R + I)/2
    near_pi = small & (c < 0.0)
    diag = jnp.diagonal(R, axis1=-2, axis2=-1)
    axis2 = jnp.clip((diag + 1.0) * 0.5, 0.0, 1.0)
    axis = jnp.sqrt(axis2 + _EPS)
    k = jnp.argmax(axis2, axis=-1)
    signs = jnp.sign(jnp.take_along_axis(
        (R + jnp.swapaxes(R, -1, -2)) * 0.5, k[..., None, None].repeat(3, -2),
        axis=-1).squeeze(-1) + _EPS * jnp.ones_like(diag))
    axis_pi = axis * signs
    axis_pi = axis_pi / (jnp.linalg.norm(axis_pi, axis=-1, keepdims=True) + _EPS)
    theta_pi = jnp.arctan2(jnp.sqrt(s2 + 1e-20), c)  # ~ pi in this branch
    return jnp.where(near_pi[..., None], theta_pi[..., None] * axis_pi, w)


def right_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Jr(w): d exp(w + dw) = exp(w) exp(Jr dw). (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta < _SMALL
    W = hat(w)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS))
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / (theta2 * theta + _EPS))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - b[..., None, None] * W + c[..., None, None] * (W @ W)


def right_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Jr^{-1}(w) closed form."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta < _SMALL
    W = hat(w)
    # 1/theta^2 - (1+cos)/(2 theta sin)
    cot_term = jnp.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / (theta2 + _EPS)
        - (1.0 + jnp.cos(theta)) / (2.0 * theta * jnp.sin(theta) + _EPS))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + 0.5 * W + cot_term[..., None, None] * (W @ W)


def normalize_rotation(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation back onto SO(3) via symmetric orthogonalization.

    (Newton iteration of the polar decomposition: fixed-length
    elementwise work instead of a batched SVD.)
    """
    for _ in range(2):
        R = 1.5 * R - 0.5 * (R @ jnp.swapaxes(R, -1, -2)) @ R
    return R


def to_quaternion(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = 0.5 * jnp.sqrt(jnp.clip(1.0 + m00 + m11 + m22, _EPS, None))
    qx = 0.5 * jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, _EPS, None))
    qy = 0.5 * jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, _EPS, None))
    qz = 0.5 * jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, _EPS, None))
    qx = qx * jnp.sign(m21 - m12 + _EPS * jnp.sign(qx + _EPS))
    qy = qy * jnp.sign(m02 - m20 + _EPS * jnp.sign(qy + _EPS))
    qz = qz * jnp.sign(m10 - m01 + _EPS * jnp.sign(qz + _EPS))
    q = jnp.stack([qw, qx, qy, qz], axis=-1)
    return q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)


def from_quaternion(q: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) (w, x, y, z) -> (..., 3, 3)."""
    q = q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)
