"""SE(3) rigid transforms as (..., 4, 4) homogeneous matrices.

Canonical in-memory pose type of the whole engine (the reference stores
cv::Mat 4x4 ``Tcw`` camera-from-world poses, e.g. KeyFrame::SetPose
src/KeyFrame.cc:178-220; we keep the same Tcw convention).

Tangent convention: xi = (omega, v) with rotation first;
exp(xi) = [[exp(omega), Jl(omega) v], [0, 1]].
"""

from __future__ import annotations

import jax.numpy as jnp

from multi_orbslam3_jax.geometry import so3

_EPS = 1e-8


def make(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,))
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch_shape) + (4, 4))


def rotation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, :3]


def translation(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :3, 3]


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return A @ B


def apply(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Transform points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return jnp.einsum("...ij,...j->...i", rotation(T), p) + translation(T)


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """(..., 6) tangent (omega, v) -> (..., 4, 4)."""
    w = xi[..., :3]
    v = xi[..., 3:]
    R = so3.exp(w)
    # Left Jacobian of SO3: Jl(w) = Jr(-w)
    Jl = so3.right_jacobian(-w)
    t = jnp.einsum("...ij,...j->...i", Jl, v)
    return make(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6) tangent (omega, v)."""
    w = so3.log(rotation(T))
    Jl_inv = so3.right_jacobian_inv(-w)
    v = jnp.einsum("...ij,...j->...i", Jl_inv, translation(T))
    return jnp.concatenate([w, v], axis=-1)


def retract(T: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative retraction used by all optimizers: exp(xi) * T."""
    return compose(exp(xi), T)


def normalize(T: jnp.ndarray) -> jnp.ndarray:
    """Re-orthogonalize the rotation block (float32 drift control)."""
    return make(so3.normalize_rotation(rotation(T)), translation(T))


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6, 6) adjoint matrix for (omega, v) ordering."""
    R = rotation(T)
    t = translation(T)
    tx = so3.hat(t)
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, zero], axis=-1)
    bottom = jnp.concatenate([tx @ R, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def to_quat_trans(T: jnp.ndarray):
    """-> ((..., 4) wxyz quaternion, (..., 3) translation) for serialization."""
    return so3.to_quaternion(rotation(T)), translation(T)


def from_quat_trans(q: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return make(so3.from_quaternion(q), t)
