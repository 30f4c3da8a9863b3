"""Global bundle adjustment: implicit Schur complement + PCG.

Replaces Optimizer::GlobalBundleAdjustemnt / the reference's GBA thread
(src/Optimizer.cc:42-448, LoopClosing::RunGlobalBundleAdjustment
:2619) at full-map scale, where local_ba.py's dense-E formulation would
need O(K*P) memory. The reduced camera system S = Hcc - E C^-1 E^T is
never materialized: PCG iterates S@x through observation-level
gather/compute/scatter passes (each O(obs)), preconditioned by the
damped camera diagonal blocks.

Distribution: this is the "distributed Schur-complement reduction" of
BASELINE.json. Observations are sharded across devices; every
observation-level reduction ends in a psum over `axis_name` when given,
so the same code runs single-chip (axis_name=None) or under
shard_map across several devices with poses and landmarks replicated
(SURVEY.md §2.9 axis 5: server-global optimization across agents' KFs).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3
from multi_orbslam3_jax.opt import robust
from multi_orbslam3_jax.opt.local_ba import BAObservations, _obs_terms, _chi2


class GBAResult(NamedTuple):
    poses: jnp.ndarray
    points: jnp.ndarray
    chi2: jnp.ndarray           # mean inlier chi2 AFTER the solve
    chi2_in: jnp.ndarray = jnp.nan   # ... and BEFORE (divergence gate)
    lam: jnp.ndarray = jnp.nan  # final LM damping (carry across slices)


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


@functools.partial(jax.jit,
                   static_argnames=("iters", "cg_iters", "axis_name",
                                    "point_aligned"))
@robust.f32_matmuls
def global_bundle_adjust(poses: jnp.ndarray, fixed: jnp.ndarray,
                         points: jnp.ndarray, point_valid: jnp.ndarray,
                         obs: BAObservations, K: cam.PinholeK,
                         iters: int = 8, cg_iters: int = 40,
                         chi2_th: float = robust.CHI2_MONO,
                         axis_name: Optional[str] = None,
                         point_aligned: bool = False,
                         lam0=1e-3,
                         point_fixed: Optional[jnp.ndarray] = None
                         ) -> GBAResult:
    """poses: (Kc, 4, 4) replicated; points: (P, 3) replicated; obs: the
    LOCAL observation shard. fixed: (Kc,) bool gauge/lock mask.

    point_fixed: optional (P,) bool — landmarks held constant: their
    observations act as pose-only factors (J_pt zeroed, so Schur
    elimination treats them as constants and their step is zero). Used
    to keep METRIC (inertial-observed) structure authoritative during
    the visual pass — a scale-free agent's observations must align to
    the metric map, not drag it off its gauge (the reference keeps the
    inertial gauge through merges, LoopClosing.cc:95-118, and re-solves
    inertial structure only in FullInertialBA, Optimizer.cc:449).

    point_aligned=True asserts every landmark's observations live on ONE
    device (the sharded entry buckets them so). Then all landmark-side
    reductions (Hpp, b_p, E^T x — the large ones) are device-local and
    only the (Kc,6)-sized camera reductions ride the collective: the
    per-CG-iteration traffic drops from O(P) to O(Kc), the standard
    landmark-parallel decomposition of distributed Schur BA."""
    Kc = poses.shape[0]
    P = points.shape[0]
    free = (~fixed).astype(jnp.float32)

    def mean_chi2(po, pt):
        r, _, _, behind = _obs_terms(po, pt, obs, K)
        c2 = _chi2(r, obs.inv_sigma2)
        n = jnp.maximum(_psum(jnp.sum(
            (obs.valid & ~behind).astype(jnp.int32)), axis_name), 1)
        return _psum(jnp.sum(jnp.where(obs.valid & ~behind,
                                       jnp.minimum(c2, chi2_th), 0.0)),
                     axis_name) / n

    def gn_step(carry, _):
        poses_, points_, lam, c_cur = carry
        r, J_cam, J_pt, behind = _obs_terms(poses_, points_, obs, K)
        if point_fixed is not None:
            J_pt = J_pt * (~point_fixed)[obs.pt].astype(
                J_pt.dtype)[:, None, None]
        c2 = _chi2(r, obs.inv_sigma2)
        w = robust.huber_weight(c2, chi2_th) * obs.inv_sigma2
        w = jnp.where(obs.valid & ~behind, w, 0.0)
        Jc_w = J_cam * w[:, None, None]
        Jp_w = J_pt * w[:, None, None]

        pt_axis = None if point_aligned else axis_name
        Hcc = _psum(jnp.zeros((Kc, 6, 6)).at[obs.kf].add(
            jnp.einsum("ori,orj->oij", J_cam, Jc_w)), axis_name)
        b_c = _psum(jnp.zeros((Kc, 6)).at[obs.kf].add(
            jnp.einsum("ori,or->oi", Jc_w, r)), axis_name)
        Hpp = _psum(jnp.zeros((P, 3, 3)).at[obs.pt].add(
            jnp.einsum("ori,orj->oij", J_pt, Jp_w)), pt_axis)
        b_p = _psum(jnp.zeros((P, 3)).at[obs.pt].add(
            jnp.einsum("ori,or->oi", Jp_w, r)), pt_axis)

        eye3 = jnp.eye(3)
        pt_seen = (jnp.diagonal(Hpp, axis1=-2, axis2=-1).sum(-1) > 1e-9) \
            & point_valid
        Hpp_d = Hpp + lam * jnp.maximum(
            jnp.diagonal(Hpp, axis1=-2, axis2=-1).mean(-1),
            1e-3)[:, None, None] * eye3
        Hpp_d = jnp.where(pt_seen[:, None, None], Hpp_d, eye3)
        C_inv = jnp.linalg.inv(Hpp_d)

        diag_damp = lam * jnp.maximum(
            jnp.diagonal(Hcc, axis1=-2, axis2=-1).mean(-1),
            1e-3)[:, None, None] * jnp.eye(6)
        Hcc_d = Hcc + diag_damp

        def Et_x(x):        # (Kc, 6) -> (P, 3):  E^T x, E^T = sum w Jp^T Jc
            t = jnp.einsum("ori,oi->or", J_cam[..., :, :], x[obs.kf])  # (O,2)
            u = jnp.einsum("ori,or->oi", Jp_w, t)                      # (O,3)
            return _psum(jnp.zeros((P, 3)).at[obs.pt].add(u), pt_axis)

        def E_y(y):         # (P, 3) -> (Kc, 6)
            t = jnp.einsum("ori,oi->or", J_pt, y[obs.pt])              # (O,2)
            u = jnp.einsum("ori,or->oi", Jc_w, t)                      # (O,6)
            return _psum(jnp.zeros((Kc, 6)).at[obs.kf].add(u), axis_name)

        def S_mv(x):        # reduced-camera matvec with free-mask projection
            x = x * free[:, None]
            hx = jnp.einsum("kij,kj->ki", Hcc_d, x)
            ex = E_y(jnp.einsum("pab,pb->pa", C_inv, Et_x(x)))
            return (hx - ex) * free[:, None]

        rhs = (b_c - E_y(jnp.einsum("pab,pb->pa", C_inv, b_p)))
        rhs = -rhs * free[:, None]

        # block-Jacobi preconditioner from damped camera blocks
        M_inv = jnp.linalg.inv(Hcc_d + 1e-6 * jnp.eye(6))

        def prec(x):
            return jnp.einsum("kij,kj->ki", M_inv, x) * free[:, None]

        # PCG, fixed iteration count
        x0 = jnp.zeros((Kc, 6))
        r0 = rhs - S_mv(x0)
        z0 = prec(r0)
        p0 = z0

        def cg_body(_, st):
            x, rr, z, p = st
            Sp = S_mv(p)
            denom = jnp.sum(p * Sp)
            alpha = jnp.sum(rr * z) / jnp.where(
                jnp.abs(denom) < 1e-12, 1e-12, denom)
            x2 = x + alpha * p
            r2 = rr - alpha * Sp
            z2 = prec(r2)
            beta = jnp.sum(r2 * z2) / jnp.maximum(jnp.sum(rr * z), 1e-12)
            p2 = z2 + beta * p
            return x2, r2, z2, p2

        dc, _, _, _ = jax.lax.fori_loop(0, cg_iters, cg_body,
                                        (x0, r0, z0, p0))
        dp = -jnp.einsum("pab,pb->pa", C_inv, b_p + Et_x(dc))
        dp = jnp.where(pt_seen[:, None], dp, 0.0)
        if point_aligned:
            # each landmark's step is computed only on its owning device
            # (zeros elsewhere): one psum per GN step replicates it
            dp = _psum(dp, axis_name)
        finite = jnp.all(jnp.isfinite(dc)) & jnp.all(jnp.isfinite(dp))
        dc = jnp.where(finite, dc, 0.0)
        dp = jnp.where(finite, dp, 0.0)
        new_poses = se3.normalize(jax.vmap(se3.retract)(poses_, dc))
        new_points = points_ + dp
        # Levenberg-Marquardt step control: a raw GN step on a poorly
        # conditioned arena (wrong seam associations, fresh drifted
        # tail) can INCREASE the error — accept only improving steps,
        # raise damping on rejection (observed in the collab bench: GN
        # runs diverging 5.3 -> 7.5 and being adopted)
        c_new = mean_chi2(new_poses, new_points)
        accept = finite & (c_new <= c_cur)
        poses_out = jnp.where(accept, new_poses, poses_)
        points_out = jnp.where(accept, new_points, points_)
        lam_out = jnp.where(accept, jnp.maximum(lam * 0.4, 1e-6),
                            jnp.minimum(lam * 8.0, 1e3))
        c_out = jnp.where(accept, c_new, c_cur)
        return (poses_out, points_out, lam_out, c_out), c_out

    chi2_in = mean_chi2(poses, points)
    (poses_f, points_f, lam_f, chi2), _ = jax.lax.scan(
        gn_step, (poses, points, jnp.asarray(lam0, jnp.float32), chi2_in),
        None, length=iters)
    return GBAResult(poses=poses_f, points=points_f, chi2=chi2,
                     chi2_in=chi2_in, lam=lam_f)


def global_bundle_adjust_sharded(poses, fixed, points, point_valid,
                                 obs: BAObservations, K: cam.PinholeK,
                                 iters: int = 8, cg_iters: int = 40,
                                 devices=None,
                                 force_shard: bool = False,
                                 point_fixed=None) -> GBAResult:
    """Distributed entry — the distributed Schur-complement reduction of
    BASELINE.json (the reference's server-global FullInertialBA over all
    agents' KFs with namespaced vertex ids, Optimizer.h:104-112, is a
    single-process g2o solve; here the same factor graph spreads across
    chips).

    Observations are bucketed so each landmark's rows live on ONE device
    (landmark-parallel decomposition): landmark elimination (Hpp/C_inv/
    E^T x/dp — the O(P) tensors) is device-local and only (Kc,6)-sized
    camera reductions cross the mesh per CG iteration. Poses/landmarks
    are replicated. force_shard=True runs the shard_map path even on one
    device (for like-for-like scaling measurements)."""
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax import shard_map

    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n == 1 and not force_shard:
        return global_bundle_adjust(poses, fixed, points, point_valid,
                                    obs, K, iters=iters, cg_iters=cg_iters,
                                    point_fixed=point_fixed)
    # ---- host-side bucketing: owner(obs) = device of its landmark ----
    P_pts = points.shape[0]
    pt_np = np.asarray(obs.pt)
    valid_np = np.asarray(obs.valid)
    owner = (pt_np.astype(np.int64) * n) // max(P_pts, 1)
    owner = np.clip(owner, 0, n - 1)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n)
    M = int(counts.max()) if len(counts) else 1
    M = max(M, 1)
    idx = np.zeros((n, M), np.int64)
    slot_ok = np.zeros((n, M), bool)
    start = 0
    for d in range(n):
        rows = order[start:start + counts[d]]
        start += counts[d]
        idx[d, :len(rows)] = rows
        slot_ok[d, :len(rows)] = True
    flat = idx.reshape(-1)
    ok = slot_ok.reshape(-1)

    def take(a, fill=0):
        return jnp.asarray(np.asarray(a)[flat])

    obs_p = BAObservations(
        kf=take(obs.kf), pt=take(obs.pt),
        uv=take(obs.uv),
        inv_sigma2=take(obs.inv_sigma2),
        valid=jnp.asarray(np.asarray(obs.valid)[flat] & ok),
        u_r=None if obs.u_r is None else take(obs.u_r))
    # per-observation intrinsics (heterogeneous agents): K fields shaped
    # (O,) are reordered and sharded exactly like the observation rows
    batched_K = jnp.ndim(K.fx) > 0
    K_p = cam.PinholeK(*(take(f) for f in K)) if batched_K else K
    mesh = Mesh(np.array(devices), ("obs",))
    spec = BAObservations(
        kf=P("obs"), pt=P("obs"), uv=P("obs"), inv_sigma2=P("obs"),
        valid=P("obs"),
        u_r=None if obs.u_r is None else P("obs"))
    kspec = cam.PinholeK(*([P("obs")] * 4)) if batched_K \
        else cam.PinholeK(*([P()] * 4))

    pf = jnp.zeros(points.shape[0], bool) if point_fixed is None \
        else jnp.asarray(point_fixed)

    @jax.jit
    @robust.f32_matmuls
    def run(poses, fixed, points, point_valid, obs_in, K_in, pf_in):
        def inner(po, fx, pt, pv, o, k, pfx):
            return global_bundle_adjust(po, fx, pt, pv, o, k, iters=iters,
                                        cg_iters=cg_iters, axis_name="obs",
                                        point_aligned=True,
                                        point_fixed=pfx)
        return shard_map(
            inner, mesh=mesh,
            in_specs=(P(), P(), P(), P(), spec, kspec, P()),
            out_specs=GBAResult(poses=P(), points=P(), chi2=P(),
                                chi2_in=P(), lam=P()))(
            poses, fixed, points, point_valid, obs_in, K_in, pf_in)

    obs_dev = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), obs_p, spec)
    K_dev = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        K_p, kspec)
    return run(poses, fixed, points, point_valid, obs_dev, K_dev, pf)
