"""Windowed bundle adjustment with a dense-E Schur complement.

Replaces Optimizer::LocalBundleAdjustment / BundleAdjustment (reference
src/Optimizer.cc:1810 / :42) — g2o's sparse block solver becomes three
dense contractions:

    Hcc (Kw,6,6)   camera diagonal blocks      (einsum over observations)
    Hpp (Pw,3,3)   landmark diagonal blocks    (scatter-add)
    E   (Kw,Pw,6,3) camera-landmark coupling   (scatter-add, dense)

    S = Hcc_blockdiag - E C^-1 E^T   (reduced camera system, dense (6Kw)^2)
    dc = solve(S, rhs);  dp = -C^-1 (b_p + E^T dc)

Dense E is deliberate: at local-BA scale (Kw<=32, Pw<=4096) it is ~10 MB
and turns the whole Schur reduction into large dense matmuls, which is the
fastest possible formulation on a systolic-array machine — no sparse
bookkeeping, no data-dependent shapes. (Global-scale BA uses the implicit
Schur + PCG solver in global_ba.py instead.)

Observations arrive as fixed-size COO arrays with weight masks; invalid
slots carry zero weight and vanish from every reduction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3, so3
from multi_orbslam3_jax.opt import robust


class BAObservations(NamedTuple):
    """Fixed-capacity observation list for one BA problem.

    kf:  (O,) int32 window-local keyframe index
    pt:  (O,) int32 window-local landmark index
    uv:  (O, 2) measured pixel position
    inv_sigma2: (O,) keypoint information
    valid: (O,) bool
    u_r: optional (O,) stereo right-image u coordinate (-1 = monocular
         observation). When present, stereo observations contribute a third
         residual row (u_L - bf/z) - u_r — the reference's EdgeStereoSE3
         (g2o EdgeStereoSE3ProjectXYZ, Optimizer.cc stereo edges), which
         pins metric scale continuously.
    """

    kf: jnp.ndarray
    pt: jnp.ndarray
    uv: jnp.ndarray
    inv_sigma2: jnp.ndarray
    valid: jnp.ndarray
    u_r: jnp.ndarray | None = None


class BAResult(NamedTuple):
    poses: jnp.ndarray     # (Kw, 4, 4)
    points: jnp.ndarray    # (Pw, 3)
    inliers: jnp.ndarray   # (O,) bool final classification
    chi2: jnp.ndarray      # () float32 mean inlier chi2


def _obs_terms(poses, points, obs: BAObservations, K: cam.PinholeK,
               bf=0.0):
    """Per-observation residual r (O,R), J_cam (O,R,6), J_pt (O,R,3) with
    R=2 (mono) or R=3 (stereo: third row is the right-u residual with
    weight zero on mono observations)."""
    T = poses[obs.kf]                       # (O, 4, 4)
    p_w = points[obs.pt]                    # (O, 3)
    p_c = se3.apply(T, p_w)
    r = cam.project(K, p_c) - obs.uv
    Jproj = cam.project_jacobian(K, p_c)    # (O, 2, 3)
    if obs.u_r is not None:
        # u_r_pred = fx x/z + cx - bf/z; d/dpc = [fx/z, 0, (bf - fx x)/z^2].
        # Mono observations (u_r < 0) get residual AND Jacobian row zeroed
        # so they contribute no phantom information to H.
        st = (obs.u_r >= 0).astype(p_c.dtype)
        z = jnp.maximum(p_c[..., 2], 1e-6)
        ur_pred = K.fx * p_c[..., 0] / z + K.cx - bf / z
        r = jnp.concatenate(
            [r, (st * (ur_pred - obs.u_r))[..., None]], axis=-1)
        J_ur = st[..., None] * jnp.stack(
            [K.fx / z, jnp.zeros_like(z),
             (bf - K.fx * p_c[..., 0]) / (z * z)], axis=-1)
        Jproj = jnp.concatenate([Jproj, J_ur[..., None, :]], axis=-2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p_c.dtype), p_c.shape[:-1] + (3, 3))
    Jpc = jnp.concatenate([-so3.hat(p_c), eye], axis=-1)  # (O, 3, 6)
    J_cam = Jproj @ Jpc
    J_pt = Jproj @ T[..., :3, :3]
    behind = p_c[..., 2] <= 1e-3
    return r, J_cam, J_pt, behind


def _chi2(r, inv_sigma2):
    return jnp.sum(r * r, axis=-1) * inv_sigma2


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / det). jnp.linalg.inv
    lowers to a pivoted LU per matrix; the adjugate is a few fused
    multiplies."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    adj = jnp.stack([
        jnp.stack([c00, c10, c20], -1),
        jnp.stack([c01, c11, c21], -1),
        jnp.stack([c02, c12, c22], -1)], -2)
    return adj * inv_det[..., None, None]


def _grouped_point_blocks(pt_k, prodE, prodH, prodb, Pw):
    """Assemble the landmark-side normal blocks with one-hot matmuls when
    observations are GROUPED by keyframe (obs row k*N+n belongs to window
    KF k — the layout every pipeline caller uses). A (N, Pw) one-hot per
    keyframe turns the scatter-adds into matmuls; zero-weight rows
    contribute zero products so index parking needs no masking.
    Returns E (Kw,Pw,6,3), Hpp (Pw,3,3), b_p (Pw,3)."""
    Kw, N = pt_k.shape

    def body(acc, x):
        p, pe, ph, pb = x
        oh = (p[:, None] == jnp.arange(Pw)[None, :]).astype(jnp.float32)
        E_k = jnp.einsum("np,nc->pc", oh, pe)
        return (acc[0] + jnp.einsum("np,nc->pc", oh, ph),
                acc[1] + jnp.einsum("np,nc->pc", oh, pb)), E_k

    (Hpp9, bp), E_all = jax.lax.scan(
        body, (jnp.zeros((Pw, 9)), jnp.zeros((Pw, 3))),
        (pt_k, prodE, prodH, prodb))
    return (E_all.reshape(Kw, Pw, 6, 3), Hpp9.reshape(Pw, 3, 3), bp)


@functools.partial(jax.jit, static_argnames=("iters", "structure_only",
                                             "grouped"))
@robust.f32_matmuls
def bundle_adjust(poses: jnp.ndarray, fixed: jnp.ndarray, points: jnp.ndarray,
                  obs: BAObservations, K: cam.PinholeK, iters: int = 10,
                  chi2_th: float = robust.CHI2_MONO,
                  structure_only: bool = False,
                  bf: float = 0.0, grouped: bool = False) -> BAResult:
    """poses: (Kw,4,4) T_cw; fixed: (Kw,) bool anchor mask; points: (Pw,3).

    Levenberg damping with step rejection (chi2 monitored each iteration,
    reverting bad steps) — the fixed-iteration analog of g2o's LM loop.
    bf = baseline * fx; only used when obs.u_r is present (stereo edges use
    the 3-dof chi2 threshold, reference Optimizer.cc thChi2Stereo=7.815).
    grouped=True asserts the caller's observation layout is (Kw, N)
    row-major (obs.kf == repeat(arange(Kw), N)) and switches the normal-
    equation assembly from scatter-adds to one-hot matmuls + block sums.
    """
    Kw = poses.shape[0]
    Pw = points.shape[0]
    free = ~fixed
    if obs.u_r is not None:
        chi2_th = jnp.where(obs.u_r >= 0, robust.CHI2_STEREO, chi2_th)

    def energy(poses_, points_):
        r, _, _, behind = _obs_terms(poses_, points_, obs, K, bf)
        c2 = _chi2(r, obs.inv_sigma2)
        # Huber rho(chi2): quadratic inside, linear outside
        rho = jnp.where(c2 <= chi2_th, c2,
                        2.0 * jnp.sqrt(chi2_th * jnp.maximum(c2, 0.0)) - chi2_th)
        w_valid = obs.valid & ~behind
        return jnp.sum(jnp.where(w_valid, rho, 0.0))

    def step(poses_, points_, lam):
        r, J_cam, J_pt, behind = _obs_terms(poses_, points_, obs, K, bf)
        c2 = _chi2(r, obs.inv_sigma2)
        w = robust.huber_weight(c2, chi2_th) * obs.inv_sigma2
        w = jnp.where(obs.valid & ~behind, w, 0.0)

        Jc_w = J_cam * w[:, None, None]
        Jp_w = J_pt * w[:, None, None]
        prod_Hcc = jnp.einsum("ori,orj->oij", J_cam, Jc_w)
        prod_bc = jnp.einsum("ori,or->oi", Jc_w, r)
        if grouped:
            N = obs.pt.shape[0] // Kw
            Hcc = prod_Hcc.reshape(Kw, N, 6, 6).sum(1)
            b_c = prod_bc.reshape(Kw, N, 6).sum(1)
            E, Hpp, b_p = _grouped_point_blocks(
                obs.pt.reshape(Kw, N),
                jnp.einsum("ori,orj->oij", Jc_w, J_pt).reshape(Kw, N, 18),
                jnp.einsum("ori,orj->oij", J_pt, Jp_w).reshape(Kw, N, 9),
                jnp.einsum("ori,or->oi", Jp_w, r).reshape(Kw, N, 3), Pw)
        else:
            Hcc = jnp.zeros((Kw, 6, 6)).at[obs.kf].add(prod_Hcc)
            b_c = jnp.zeros((Kw, 6)).at[obs.kf].add(prod_bc)
            Hpp = jnp.zeros((Pw, 3, 3)).at[obs.pt].add(
                jnp.einsum("ori,orj->oij", J_pt, Jp_w))
            b_p = jnp.zeros((Pw, 3)).at[obs.pt].add(
                jnp.einsum("ori,or->oi", Jp_w, r))
            E = jnp.zeros((Kw, Pw, 6, 3)).at[obs.kf, obs.pt].add(
                jnp.einsum("ori,orj->oij", Jc_w, J_pt))

        eye3 = jnp.eye(3)
        Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
            jnp.diagonal(Hpp, axis1=-2, axis2=-1).mean(-1), 1e-3)[:, None, None]
        # guard unobserved landmarks (zero blocks)
        pt_seen = jnp.diagonal(Hpp, axis1=-2, axis2=-1).sum(-1) > 1e-9
        Hpp_d = jnp.where(pt_seen[:, None, None], Hpp_d, eye3)
        C_inv = inv3x3(Hpp_d)

        if structure_only:
            dp = -jnp.einsum("pab,pb->pa", C_inv, b_p)
            dp = jnp.where(pt_seen[:, None], dp, 0.0)
            return poses_, points_ + dp

        EC = jnp.einsum("kpab,pbc->kpac", E, C_inv)          # (Kw,Pw,6,3)
        S = -jnp.einsum("kpac,lpbc->kalb", EC, E)            # (Kw,6,Kw,6)
        diag_damp = lam * jnp.eye(6) * jnp.maximum(
            jnp.diagonal(Hcc, axis1=-2, axis2=-1).mean(-1), 1e-3)[:, None, None]
        S = S.at[jnp.arange(Kw), :, jnp.arange(Kw), :].add(Hcc + diag_damp)
        rhs = b_c - jnp.einsum("kpac,pc->ka", EC, b_p)       # (Kw, 6)
        # clamp fixed cameras: identity rows/cols, zero rhs
        fm = free.astype(S.dtype)
        S = S * fm[:, None, None, None] * fm[None, None, :, None]
        S = S.at[jnp.arange(Kw), :, jnp.arange(Kw), :].add(
            (1.0 - fm)[:, None, None] * jnp.eye(6))
        rhs = rhs * fm[:, None]

        Sf = S.reshape(Kw * 6, Kw * 6)
        Sf = Sf + 1e-8 * jnp.eye(Kw * 6)
        dc = jnp.linalg.solve(Sf, -rhs.reshape(-1)).reshape(Kw, 6)
        dc = jnp.where(free[:, None], dc, 0.0)
        Et_dc = jnp.einsum("kpac,ka->pc", E, dc)
        dp = -jnp.einsum("pab,pb->pa", C_inv, b_p + Et_dc)
        dp = jnp.where(pt_seen[:, None], dp, 0.0)

        finite = jnp.all(jnp.isfinite(dc)) & jnp.all(jnp.isfinite(dp))
        dc = jnp.where(finite, dc, 0.0)
        dp = jnp.where(finite, dp, 0.0)
        new_poses = jax.vmap(se3.retract)(poses_, dc)
        new_poses = se3.normalize(new_poses)
        return new_poses, points_ + dp

    def body(_, carry):
        poses_, points_, lam, e_prev = carry
        p2, x2 = step(poses_, points_, lam)
        e_new = energy(p2, x2)
        accept = e_new < e_prev
        poses_ = jnp.where(accept, p2, poses_)
        points_ = jnp.where(accept, x2, points_)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-6),
                        jnp.minimum(lam * 4.0, 1e2))
        return poses_, points_, lam, jnp.where(accept, e_new, e_prev)

    e0 = energy(poses, points)
    poses_f, points_f, _, _ = jax.lax.fori_loop(
        0, iters, body, (poses, points, jnp.float32(1e-4), e0))

    r, _, _, behind = _obs_terms(poses_f, points_f, obs, K, bf)
    c2 = _chi2(r, obs.inv_sigma2)
    inliers = obs.valid & ~behind & (c2 <= chi2_th)
    n_in = jnp.maximum(jnp.sum(inliers.astype(jnp.int32)), 1)
    return BAResult(poses=poses_f, points=points_f, inliers=inliers,
                    chi2=jnp.sum(jnp.where(inliers, c2, 0.0)) / n_in)
