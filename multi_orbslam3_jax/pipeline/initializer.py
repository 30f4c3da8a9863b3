"""Monocular two-view bootstrap via batched essential-matrix RANSAC.

Replaces the reference's Initializer / TwoViewReconstruction
(src/TwoViewReconstruction.cc, invoked through
Pinhole::ReconstructWithTwoViews): instead of iterating H and F RANSAC in
two threads with data-dependent convergence, we evaluate a fixed batch of
8-point hypotheses in parallel (one SVD per hypothesis, vmapped), pick the
best by inlier count, refine on inliers, decompose E with the cheirality
test over the 4 (R, t) candidates, and triangulate. A pure-rotation /
planar degeneracy is reported through the result's quality fields and
handled by the caller (it simply waits for more parallax, which is also
what the reference's model-selection ends up doing on such frames).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3, triangulation


class InitResult(NamedTuple):
    ok: jnp.ndarray          # () bool — initialization accepted
    T_21: jnp.ndarray        # (4, 4) pose of view 2 in view-1 frame (unit baseline)
    points: jnp.ndarray      # (M, 3) triangulated landmarks in view-1 frame
    point_ok: jnp.ndarray    # (M,) bool valid triangulations
    inliers: jnp.ndarray     # (M,) bool epipolar inliers
    n_inliers: jnp.ndarray   # () int32


def _eight_point(b1: jnp.ndarray, b2: jnp.ndarray) -> jnp.ndarray:
    """Normalized 8-point algorithm on bearings: (8, 3) x (8, 3) -> E (3, 3).
    b are unit-plane bearings (x, y, 1) so the 'normalization' of pixel
    8-point is already done by K^-1."""
    x1, y1 = b1[:, 0], b1[:, 1]
    x2, y2 = b2[:, 0], b2[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=1)       # (8, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    E = Vt[-1].reshape(3, 3)
    # project onto the essential manifold: two equal singular values
    U, S, Vt2 = jnp.linalg.svd(E)
    s = (S[0] + S[1]) * 0.5
    return U @ jnp.diag(jnp.array([1.0, 1.0, 0.0]) * s) @ Vt2


def _sampson_err(E: jnp.ndarray, b1: jnp.ndarray, b2: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) error of b2^T E b1 on the unit plane."""
    Eb1 = b1 @ E.T           # (M, 3) = E b1
    Etb2 = b2 @ E            # (M, 3) = E^T b2
    num = jnp.sum(b2 * Eb1, axis=-1) ** 2
    den = Eb1[:, 0] ** 2 + Eb1[:, 1] ** 2 + Etb2[:, 0] ** 2 + Etb2[:, 1] ** 2
    return num / (den + 1e-12)


def _four_point_h(b1: jnp.ndarray, b2: jnp.ndarray) -> jnp.ndarray:
    """DLT homography from 4 correspondences on the unit plane:
    (4, 3) x (4, 3) -> H (3, 3) with b2 ~ H b1."""
    x1, y1 = b1[:, 0], b1[:, 1]
    x2, y2 = b2[:, 0], b2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    rows_a = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], axis=1)
    rows_b = jnp.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], axis=1)
    A = jnp.concatenate([rows_a, rows_b], axis=0)        # (8, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return Vt[-1].reshape(3, 3)


def _h_transfer_err(H: jnp.ndarray, b1: jnp.ndarray,
                    b2: jnp.ndarray) -> jnp.ndarray:
    """Symmetric transfer error of a homography on the unit plane."""
    Hb1 = b1 @ H.T
    p12 = Hb1[:, :2] / (Hb1[:, 2:3] + 1e-12)
    Hinv_b2 = b2 @ jnp.linalg.inv(H).T
    p21 = Hinv_b2[:, :2] / (Hinv_b2[:, 2:3] + 1e-12)
    e12 = jnp.sum((p12 - b2[:, :2]) ** 2, axis=-1)
    e21 = jnp.sum((p21 - b1[:, :2]) ** 2, axis=-1)
    return e12 + e21


def _decompose_H(H: jnp.ndarray):
    """Faugeras SVD decomposition of a calibrated homography into the 8
    candidate (R, t) motions (the same hypothesis set the reference's
    ReconstructH tests, src/TwoViewReconstruction.cc). |t| normalized to 1
    by the caller's cheirality stage."""
    U, d, Vt = jnp.linalg.svd(H)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom)
    aux3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom)
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])

    # case d' = +d2
    sin_t = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / \
        jnp.maximum((d1 + d3) * d2, 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)

    def rt_pos(x1, x3, eps):
        st, ct = eps * sin_t, cos_t
        Rp = jnp.array([[ct, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ct]])
        tp = (d1 - d3) * jnp.array([x1, 0.0, -x3])
        return s * (U @ Rp @ Vt), U @ tp

    # case d' = -d2
    sin_p = jnp.sqrt(jnp.maximum(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / \
        jnp.maximum((d1 - d3) * d2, 1e-12)
    cos_p = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)

    def rt_neg(x1, x3, eps):
        sp, cp = eps * sin_p, cos_p
        Rp = jnp.array([[cp, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cp]])
        tp = (d1 + d3) * jnp.array([x1, 0.0, x3])
        return s * (U @ Rp @ Vt), U @ tp

    Rs, ts = [], []
    for i, eps in zip(range(4), (1.0, -1.0, -1.0, 1.0)):
        R, t = rt_pos(x1s[i], x3s[i], eps)
        Rs.append(R)
        ts.append(t)
    for i, eps in zip(range(4), (1.0, -1.0, -1.0, 1.0)):
        R, t = rt_neg(x1s[i], x3s[i], eps)
        Rs.append(R)
        ts.append(t)
    Rs = jnp.stack(Rs)
    ts = jnp.stack(ts)
    ts = ts / (jnp.linalg.norm(ts, axis=-1, keepdims=True) + 1e-12)
    return Rs, ts


def _decompose_E(E: jnp.ndarray):
    """E -> 4 candidate (R, t) with |t| = 1."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


@functools.partial(jax.jit, static_argnames=("n_hyp",))
def initialize_two_view(K: cam.PinholeK, uv1: jnp.ndarray, uv2: jnp.ndarray,
                        match_valid: jnp.ndarray, key: jnp.ndarray,
                        n_hyp: int = 192, inlier_th_px: float = 1.5,
                        min_inliers: int = 50,
                        min_parallax_cos: float = 0.99995) -> InitResult:
    """uv1/uv2: (M, 2) matched undistorted pixel coordinates; match_valid:
    (M,) mask. Returns unit-baseline relative pose + triangulated points.
    """
    M = uv1.shape[0]
    b1 = cam.unproject(K, uv1)
    b2 = cam.unproject(K, uv2)
    # pixel threshold -> unit-plane threshold (approx via focal length)
    f = (K.fx + K.fy) * 0.5
    th = (inlier_th_px / f) ** 2

    # --- hypothesis batch: E (8-pt) and H (4-pt) evaluated in parallel,
    # the reference's dual H/F RANSAC with RH model selection
    # (TwoViewReconstruction::Reconstruct, RH > 0.4 -> homography) ---
    w = match_valid.astype(jnp.float32)
    idx = jax.vmap(
        lambda k: jax.random.choice(k, M, (8,), replace=False, p=w / jnp.sum(w))
    )(jax.random.split(key, n_hyp))                     # (n_hyp, 8)
    Es = jax.vmap(lambda i: _eight_point(b1[i], b2[i]))(idx)
    errs = jax.vmap(lambda E: _sampson_err(E, b1, b2))(Es)   # (n_hyp, M)
    inl = (errs < th) & match_valid[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    inliers = inl[best]

    Hs = jax.vmap(lambda i: _four_point_h(b1[i[:4]], b2[i[:4]]))(idx)
    errs_h = jax.vmap(lambda H: _h_transfer_err(H, b1, b2))(Hs)
    # symmetric transfer uses 2 squared distances -> threshold 2*th
    inl_h = (errs_h < 2.0 * th) & match_valid[None, :]
    scores_h = jnp.sum(inl_h, axis=1)
    best_h = jnp.argmax(scores_h)
    inliers_h = inl_h[best_h]

    # model selection: relative support of H vs E
    nH = jnp.sum(inliers_h.astype(jnp.float32))
    nE = jnp.sum(inliers.astype(jnp.float32))
    use_h = nH / jnp.maximum(nH + nE, 1.0) > 0.45

    # --- refine on inliers (weighted DLT over all M with inlier weights) ---
    x1, y1 = b1[:, 0], b1[:, 1]
    x2, y2 = b2[:, 0], b2[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=1)
    Aw = A * inliers[:, None]
    _, _, Vt = jnp.linalg.svd(Aw, full_matrices=False)
    E = Vt[-1].reshape(3, 3)
    U, S, Vt2 = jnp.linalg.svd(E)
    E = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0]) * (S[0] + S[1]) * 0.5) @ Vt2
    err_r = _sampson_err(E, b1, b2)
    inliers_e = (err_r < th) & match_valid

    # refine H on its inliers (weighted DLT)
    zz = jnp.zeros_like(x1)
    oo = jnp.ones_like(x1)
    rows_a = jnp.stack([x1, y1, oo, zz, zz, zz, -x2 * x1, -x2 * y1, -x2],
                       axis=1)
    rows_b = jnp.stack([zz, zz, zz, x1, y1, oo, -y2 * x1, -y2 * y1, -y2],
                       axis=1)
    Ah = jnp.concatenate([rows_a * inliers_h[:, None],
                          rows_b * inliers_h[:, None]], axis=0)
    _, _, Vth = jnp.linalg.svd(Ah, full_matrices=False)
    H = Vth[-1].reshape(3, 3)
    inliers_h = (_h_transfer_err(H, b1, b2) < 2.0 * th) & match_valid

    inliers = jnp.where(use_h, inliers_h, inliers_e)

    # --- cheirality over the candidate motions of the winning model:
    # 4 from E, 8 from H (padded into one fixed set of 8; the E set
    # repeats its last entry) ---
    Rs_e, ts_e = _decompose_E(E)
    Rs_h, ts_h = _decompose_H(H)
    Rs_e8 = jnp.concatenate([Rs_e, Rs_e], axis=0)
    ts_e8 = jnp.concatenate([ts_e, ts_e], axis=0)
    Rs = jnp.where(use_h, Rs_h, Rs_e8)
    ts = jnp.where(use_h, ts_h, ts_e8)
    T1 = jnp.broadcast_to(se3.identity(), (M, 4, 4))

    def count_front(R, t):
        T2 = se3.make(R, t)
        p = triangulation.triangulate_dlt(
            T1, jnp.broadcast_to(T2, (M, 4, 4)), b1, b2)
        z1 = p[:, 2]
        z2 = triangulation.depth_in(jnp.broadcast_to(T2, (M, 4, 4)), p)
        good = (z1 > 1e-3) & (z2 > 1e-3) & inliers
        return jnp.sum(good), p, good

    counts, ps, goods = jax.vmap(count_front)(Rs, ts)
    pick = jnp.argmax(counts)
    R, t = Rs[pick], ts[pick]
    points = ps[pick]
    front = goods[pick]
    T21 = se3.make(R, t)

    # --- parallax / quality gates (reference CheckRT parallax test) ---
    cosp = triangulation.parallax_cos(
        T1, jnp.broadcast_to(T21, (M, 4, 4)), points)
    enough_par = jnp.sum((cosp < min_parallax_cos) & front) >= (min_inliers // 2)
    n_in = jnp.sum(front.astype(jnp.int32))
    dominant = counts[pick] > 0.7 * jnp.maximum(jnp.sum(inliers), 1)
    ok = (n_in >= min_inliers) & enough_par & dominant
    point_ok = front & (cosp < min_parallax_cos)
    return InitResult(ok=ok, T_21=T21, points=points, point_ok=point_ok,
                      inliers=inliers, n_inliers=n_in)
