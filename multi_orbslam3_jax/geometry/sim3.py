"""Sim(3) similarity transforms, stored as (R: (...,3,3), t: (...,3), s: (...)).

Used by loop closing / map merging (reference g2o::Sim3 +
src/Sim3Solver.cc + Optimizer::OptimizeEssentialGraph). We keep the group
action  x -> s * R x + t  and the reference's convention that composition
S1 * S2 applies S2 first.

Tangent for pose-graph optimization: zeta = (omega, v, sigma) in R^7 with
retraction  exp(zeta) * S (left-multiplicative, like se3.retract).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from multi_orbslam3_jax.geometry import so3

_EPS = 1e-8
_SMALL = 1e-4


class Sim3(NamedTuple):
    R: jnp.ndarray  # (..., 3, 3)
    t: jnp.ndarray  # (..., 3)
    s: jnp.ndarray  # (...)


def identity(batch_shape=(), dtype=jnp.float32) -> Sim3:
    b = tuple(batch_shape)
    return Sim3(jnp.broadcast_to(jnp.eye(3, dtype=dtype), b + (3, 3)),
                jnp.zeros(b + (3,), dtype), jnp.ones(b, dtype))


def from_se3(T: jnp.ndarray, s=None) -> Sim3:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if s is None:
        s = jnp.ones(T.shape[:-2], T.dtype)
    return Sim3(R, t, s)


def to_se3_scaled(S: Sim3) -> jnp.ndarray:
    """Fold the scale into translation, return SE3 with R and t/s — the
    reference's trick when applying a Sim3 correction to an SE3 pose
    (LoopClosing::CorrectLoop: Tcw = [R, t/s])."""
    from multi_orbslam3_jax.geometry import se3
    return se3.make(S.R, S.t / S.s[..., None])


def apply(S: Sim3, p: jnp.ndarray) -> jnp.ndarray:
    return S.s[..., None] * jnp.einsum("...ij,...j->...i", S.R, p) + S.t


def compose(A: Sim3, B: Sim3) -> Sim3:
    """A * B: apply B first."""
    return Sim3(A.R @ B.R,
                A.s[..., None] * jnp.einsum("...ij,...j->...i", A.R, B.t) + A.t,
                A.s * B.s)


def inverse(S: Sim3) -> Sim3:
    Rt = jnp.swapaxes(S.R, -1, -2)
    inv_s = 1.0 / S.s
    return Sim3(Rt, -inv_s[..., None] * jnp.einsum("...ij,...j->...i", Rt, S.t),
                inv_s)


def exp(zeta: jnp.ndarray) -> Sim3:
    """(..., 7) (omega, v, sigma) -> Sim3. Uses the closed-form similarity
    'W' matrix (generalization of the SO3 left Jacobian with scale)."""
    w = zeta[..., :3]
    v = zeta[..., 3:6]
    sigma = zeta[..., 6]
    R = so3.exp(w)
    s = jnp.exp(sigma)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = so3.hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=zeta.dtype), W.shape)

    small_s = jnp.abs(sigma) < _SMALL
    small_t = theta < _SMALL
    # coefficients of W-matrix: A*I + B*W + C*W^2 (Strasdat's Sim3 exp)
    c0 = jnp.where(small_s, 1.0 - sigma / 2.0 + sigma * sigma / 6.0,
                   (s - 1.0) / jnp.where(small_s, 1.0, sigma))
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    denom = sigma * sigma + theta2
    a_coef = (s * sin_t) * sigma + (1.0 - s * cos_t) * theta
    B = jnp.where(small_t & small_s, 0.5,
                  a_coef / (theta * jnp.where(small_t & small_s, 1.0, denom) + _EPS))
    c_coef = jnp.where(small_s,
                       jnp.where(small_t, 1.0 / 6.0,
                                 (theta - sin_t) / (theta2 * theta + _EPS)),
                       (c0 - ((s * cos_t - 1.0) * sigma + s * sin_t * theta)
                        / (denom + _EPS)) / (theta2 + _EPS))
    Wmat = c0[..., None, None] * eye + B[..., None, None] * W \
        + c_coef[..., None, None] * (W @ W)
    t = jnp.einsum("...ij,...j->...i", Wmat, v)
    return Sim3(R, t, s)


def log(S: Sim3) -> jnp.ndarray:
    """Sim3 -> (..., 7). Inverse of exp via solving the 3x3 W system."""
    w = so3.log(S.R)
    sigma = jnp.log(S.s)
    # rebuild W matrix and solve W v = t
    zeta_ws = jnp.concatenate(
        [w, jnp.zeros_like(w), sigma[..., None]], axis=-1)
    # reuse exp's W computation by calling with v = e_i basis would be wasteful;
    # recompute coefficients directly:
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    Wskew = so3.hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), Wskew.shape)
    s = S.s
    small_s = jnp.abs(sigma) < _SMALL
    small_t = theta < _SMALL
    c0 = jnp.where(small_s, 1.0 - sigma / 2.0 + sigma * sigma / 6.0,
                   (s - 1.0) / jnp.where(small_s, 1.0, sigma))
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    denom = sigma * sigma + theta2
    a_coef = (s * sin_t) * sigma + (1.0 - s * cos_t) * theta
    B = jnp.where(small_t & small_s, 0.5,
                  a_coef / (theta * jnp.where(small_t & small_s, 1.0, denom) + _EPS))
    c_coef = jnp.where(small_s,
                       jnp.where(small_t, 1.0 / 6.0,
                                 (theta - sin_t) / (theta2 * theta + _EPS)),
                       (c0 - ((s * cos_t - 1.0) * sigma + s * sin_t * theta)
                        / (denom + _EPS)) / (theta2 + _EPS))
    Wmat = c0[..., None, None] * eye + B[..., None, None] * Wskew \
        + c_coef[..., None, None] * (Wskew @ Wskew)
    v = jnp.linalg.solve(Wmat, S.t[..., None])[..., 0]
    del zeta_ws
    return jnp.concatenate([w, v, sigma[..., None]], axis=-1)


def retract(S: Sim3, zeta: jnp.ndarray) -> Sim3:
    return compose(exp(zeta), S)


def stack(S: Sim3) -> jnp.ndarray:
    """Pack to (..., 13) flat array [R(9), t(3), s] for array storage."""
    return jnp.concatenate(
        [S.R.reshape(S.R.shape[:-2] + (9,)), S.t, S.s[..., None]], axis=-1)


def unstack(x: jnp.ndarray) -> Sim3:
    return Sim3(x[..., :9].reshape(x.shape[:-1] + (3, 3)),
                x[..., 9:12], x[..., 12])
