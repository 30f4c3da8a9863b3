"""Sim(3) estimation from 3D-3D correspondences: batched Horn + RANSAC.

Replaces the reference Sim3Solver (src/Sim3Solver.cc — RANSAC over
3-point Horn closed forms with reprojection inlier checks). Here all
hypotheses are evaluated in one vmapped batch (no sequential
early-exit; the fixed batch is the budget), followed by IRLS-weighted
Horn refinement on the inlier set.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import sim3
from multi_orbslam3_jax.geometry.sim3 import Sim3
from multi_orbslam3_jax.opt import robust


def horn_sim3(p: jnp.ndarray, q: jnp.ndarray,
              w: jnp.ndarray | None = None,
              fix_scale: bool = False) -> Sim3:
    """Closed-form similarity q ~ s R p + t (Horn/Umeyama).
    p, q: (..., M, 3); w: optional (..., M) weights. Batched over leading
    axes."""
    if w is None:
        w = jnp.ones(p.shape[:-1], p.dtype)
    wsum = jnp.sum(w, axis=-1, keepdims=True) + 1e-9
    wn = w / wsum
    mu_p = jnp.sum(wn[..., None] * p, axis=-2)
    mu_q = jnp.sum(wn[..., None] * q, axis=-2)
    pc = p - mu_p[..., None, :]
    qc = q - mu_q[..., None, :]
    cov = jnp.einsum("...m,...mi,...mj->...ij", wn, qc, pc)
    U, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    S = jnp.ones(cov.shape[:-2] + (3,)).at[..., 2].set(jnp.sign(det + 1e-12))
    R = U @ (S[..., :, None] * Vt)
    var_p = jnp.einsum("...m,...mi,...mi->...", wn, pc, pc)
    s = jnp.where(
        jnp.asarray(fix_scale),
        jnp.ones_like(var_p),
        jnp.sum(D * S, axis=-1) / (var_p + 1e-12))
    t = mu_q - s[..., None] * jnp.einsum("...ij,...j->...i", R, mu_p)
    return Sim3(R, t, s)


class Sim3RansacResult(NamedTuple):
    S: Sim3                 # best q <- p similarity
    inliers: jnp.ndarray    # (M,) bool
    n_inliers: jnp.ndarray  # () int32
    ok: jnp.ndarray         # () bool


@functools.partial(jax.jit,
                   static_argnames=("n_hyp", "min_inliers", "fix_scale",
                                    "refine_iters"))
@robust.f32_matmuls
def sim3_ransac(p: jnp.ndarray, q: jnp.ndarray, valid: jnp.ndarray,
                key: jnp.ndarray, n_hyp: int = 128,
                inlier_th: float = 0.1, min_inliers: int = 20,
                fix_scale: bool = False,
                refine_iters: int = 4) -> Sim3RansacResult:
    """p, q: (M, 3) corresponding 3D points (candidate-map and current-map
    coordinates); inlier_th is a 3D distance in q's scale (callers pass a
    fraction of the local scene depth)."""
    M = p.shape[0]
    w = valid.astype(jnp.float32)
    probs = w / jnp.maximum(jnp.sum(w), 1e-9)
    idx = jax.vmap(lambda k: jax.random.choice(k, M, (3,), replace=False,
                                               p=probs))(
        jax.random.split(key, n_hyp))                      # (n_hyp, 3)
    S_h = horn_sim3(p[idx], q[idx], fix_scale=fix_scale)    # batched Sim3
    err = jnp.linalg.norm(
        sim3.apply(Sim3(S_h.R[:, None], S_h.t[:, None], S_h.s[:, None]),
                   p[None, :, :]) - q[None, :, :], axis=-1)  # (n_hyp, M)
    inl = (err < inlier_th) & valid[None, :]
    scores = jnp.sum(inl, axis=-1)
    best = jnp.argmax(scores)
    inliers = inl[best]

    # IRLS refinement: weighted Horn on (soft) inliers
    def body(_, carry):
        S_cur, _ = carry
        e = jnp.linalg.norm(sim3.apply(S_cur, p) - q, axis=-1)
        wgt = jnp.where(valid & (e < inlier_th * 1.5), 1.0, 0.0)
        S_new = horn_sim3(p, q, wgt, fix_scale=fix_scale)
        return S_new, wgt > 0

    S0 = Sim3(S_h.R[best], S_h.t[best], S_h.s[best])
    S_f, inl_f = jax.lax.fori_loop(0, refine_iters, body, (S0, inliers))
    n_in = jnp.sum(inl_f.astype(jnp.int32))
    return Sim3RansacResult(S=S_f, inliers=inl_f, n_inliers=n_in,
                            ok=n_in >= min_inliers)


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale"))
@robust.f32_matmuls
def optimize_sim3_reprojection(S0: Sim3, K, T_cur: jnp.ndarray,
                               T_cand: jnp.ndarray,
                               p_cand: jnp.ndarray, uv_cur: jnp.ndarray,
                               has_cur: jnp.ndarray,
                               p_cur: jnp.ndarray, uv_cand: jnp.ndarray,
                               has_cand: jnp.ndarray,
                               inv_sigma2_cur: jnp.ndarray,
                               inv_sigma2_cand: jnp.ndarray,
                               iters: int = 10, fix_scale: bool = False,
                               chi2_th: float = 9.21, K_cand=None):
    """Reprojection-space Sim3 refinement (reference Optimizer::
    OptimizeSim3, src/Optimizer.cc:4031): given the 3D-3D RANSAC seed S
    with p_cur ~ S(p_cand), minimize the TWO-WAY pixel reprojection error

        r_fwd  = project(K, T_cur  . S(p_cand))   - uv_cur
        r_bwd  = project(K, T_cand . S^-1(p_cur)) - uv_cand

    over the 7-dim Sim3 tangent with Huber robustification (chi2 9.21 =
    the reference's th2 for 2-dof at 99%). Jacobians via forward-mode
    autodiff at delta = 0. Returns (S_refined, inlier_fwd, inlier_bwd).
    """
    from multi_orbslam3_jax.geometry import camera as cam
    from multi_orbslam3_jax.geometry import se3 as se3m

    if K_cand is None:      # heterogeneous agents: candidate-side camera
        K_cand = K
    S0_flat = sim3.stack(S0)
    zero = jnp.zeros(7)
    dof = jnp.ones(7)
    if fix_scale:
        dof = dof.at[6].set(0.0)

    def residuals(d, S_flat):
        S = sim3.retract(sim3.unstack(S_flat), d)
        pc_f = se3m.apply(T_cur[None], sim3.apply(S, p_cand))
        r_f = cam.project(K, pc_f) - uv_cur
        pc_b = se3m.apply(T_cand[None], sim3.apply(sim3.inverse(S), p_cur))
        r_b = cam.project(K_cand, pc_b) - uv_cand
        behind_f = pc_f[..., 2] <= 1e-3
        behind_b = pc_b[..., 2] <= 1e-3
        return r_f, r_b, behind_f, behind_b

    def gn(_, S_flat):
        r_f, r_b, bh_f, bh_b = residuals(zero, S_flat)
        J = jax.jacfwd(lambda d: residuals(d, S_flat)[:2])(zero)
        J_f, J_b = J                                  # (M, 2, 7)
        c2_f = jnp.sum(r_f * r_f, -1) * inv_sigma2_cur
        c2_b = jnp.sum(r_b * r_b, -1) * inv_sigma2_cand
        w_f = jnp.where(has_cur & ~bh_f,
                        _huber(c2_f, chi2_th) * inv_sigma2_cur, 0.0)
        w_b = jnp.where(has_cand & ~bh_b,
                        _huber(c2_b, chi2_th) * inv_sigma2_cand, 0.0)
        H = jnp.einsum("mri,m,mrj->ij", J_f, w_f, J_f) \
            + jnp.einsum("mri,m,mrj->ij", J_b, w_b, J_b)
        b = jnp.einsum("mri,m,mr->i", J_f, w_f, r_f) \
            + jnp.einsum("mri,m,mr->i", J_b, w_b, r_b)
        H = H * dof[:, None] * dof[None, :] \
            + jnp.diag(jnp.where(dof > 0, 0.0, 1.0)) \
            + 1e-3 * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(7)
        dx = jnp.linalg.solve(H, -b) * dof
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros(7))
        return sim3.stack(sim3.retract(sim3.unstack(S_flat), dx))

    S_flat = jax.lax.fori_loop(0, iters, gn, S0_flat)
    r_f, r_b, bh_f, bh_b = residuals(zero, S_flat)
    c2_f = jnp.sum(r_f * r_f, -1) * inv_sigma2_cur
    c2_b = jnp.sum(r_b * r_b, -1) * inv_sigma2_cand
    inl_f = has_cur & ~bh_f & (c2_f <= chi2_th)
    inl_b = has_cand & ~bh_b & (c2_b <= chi2_th)
    return sim3.unstack(S_flat), inl_f, inl_b


def _huber(chi2, delta2):
    return jnp.where(chi2 <= delta2, 1.0,
                     jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))
