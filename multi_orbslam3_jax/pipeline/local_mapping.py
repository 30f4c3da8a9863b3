"""Local mapping: new-landmark triangulation + windowed BA + writeback.

Replaces LocalMapping::RunClient (reference src/LocalMapping.cc:140-379):
ProcessNewKeyFrame / CreateNewMapPoints (:396/:520) and the
LocalBundleAdjustment call (Optimizer.cc:1810) become two jitted stages
invoked by the host whenever tracking inserts a keyframe. Fixed caps
everywhere: the covisibility window is a static-size slot list, window
landmarks are compacted with size-bounded jnp.unique, and BA outliers are
erased by masked scatter instead of g2o edge removal.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.frontend import matcher
from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3, so3, triangulation
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.map.mapstate import NO_MP, MapState
from multi_orbslam3_jax.opt import local_ba
from multi_orbslam3_jax.pipeline.tracking import level_inv_sigma2


class TriangulationOut(NamedTuple):
    map: MapState
    n_created: jnp.ndarray


@jax.jit
def triangulate_with_neighbor(m: MapState, kf_new, kf_nbr,
                              K: cam.PinholeK) -> TriangulationOut:
    """Create landmarks from features unmatched in both keyframes
    (reference CreateNewMapPoints, src/LocalMapping.cc:520): mutual
    descriptor match restricted by the epipolar constraint of the known
    relative pose, then checked DLT triangulation."""
    return _triangulate_pair(m, kf_new, kf_nbr, K, jnp.bool_(True))


def _triangulate_pair(m: MapState, kf_new, kf_nbr, K: cam.PinholeK,
                      enable) -> TriangulationOut:
    """Triangulation body; `enable=False` makes it a no-op (used by the
    fused neighbor scan in process_new_keyframe)."""
    free_new = m.kf_feat_valid[kf_new] & (m.kf_mp[kf_new] == NO_MP)
    free_nbr = m.kf_feat_valid[kf_nbr] & (m.kf_mp[kf_nbr] == NO_MP)
    res = matcher.match_mutual(
        m.kf_desc[kf_new], free_new, m.kf_desc[kf_nbr], free_nbr,
        max_dist=matcher.TH_LOW, ratio=0.8,
        angle1=m.kf_angle[kf_new], angle2=m.kf_angle[kf_nbr])

    T_new = m.kf_pose[kf_new]
    T_nbr = m.kf_pose[kf_nbr]
    # per-KF intrinsics: heterogeneous agents' keyframes carry their own
    # rectified pinhole (reference per-client camera, ClientHandler.cc:26-66)
    K_new = ms.kf_intrinsics(m, kf_new, K)
    K_nbr = ms.kf_intrinsics(m, kf_nbr, K)
    # epipolar gate: essential matrix of the relative pose nbr->new
    T_rel = se3.compose(T_new, se3.inverse(T_nbr))   # nbr-cam -> new-cam
    E = so3.hat(se3.translation(T_rel)) @ se3.rotation(T_rel)
    idx_safe = jnp.where(res.idx >= 0, res.idx, 0)
    uv_new = m.kf_uv[kf_new]
    uv_nbr = m.kf_uv[kf_nbr][idx_safe]
    b_new = cam.unproject(K_new, uv_new)
    b_nbr = cam.unproject(K_nbr, uv_nbr)
    # Sampson error on the unit plane, threshold ~1.5 px
    Eb = b_nbr @ E.T
    Etb = b_new @ E
    num = jnp.sum(b_new * Eb, axis=-1) ** 2
    den = Eb[:, 0] ** 2 + Eb[:, 1] ** 2 + Etb[:, 0] ** 2 + Etb[:, 1] ** 2
    f = (K_new.fx + K_new.fy) * 0.5
    epi_ok = num / (den + 1e-12) < (1.5 / f) ** 2

    N = uv_new.shape[0]
    p, tri_ok = triangulation.triangulate_and_check(
        jnp.broadcast_to(T_new, (N, 4, 4)), jnp.broadcast_to(T_nbr, (N, 4, 4)),
        b_new, b_nbr, K_new, uv_new, uv_nbr, K2=K_nbr)
    ok = (res.idx >= 0) & epi_ok & tri_ok & enable
    m2, slots = ms.add_mappoints(
        m, p, ok, m.kf_desc[kf_new], kf_new, kf_new,
        jnp.arange(N, dtype=jnp.int32), kf_nbr, idx_safe)
    return TriangulationOut(map=m2, n_created=jnp.sum(ok.astype(jnp.int32)))


class KFProcessOut(NamedTuple):
    map: MapState
    n_created: jnp.ndarray
    n_fused: jnp.ndarray
    neighbors: jnp.ndarray   # (n_neighbors,) covisible KFs used
    neighbor_ok: jnp.ndarray


@functools.partial(jax.jit,
                   static_argnames=("n_neighbors", "width", "height",
                                    "scale_factor", "n_levels"))
def process_new_keyframe(m: MapState, kf_new, K: cam.PinholeK, *,
                         n_neighbors: int = 8, width: int, height: int,
                         scale_factor: float = 1.2, n_levels: int = 8,
                         min_covis: int = 10) -> KFProcessOut:
    """Fused per-keyframe mapping stage in ONE compiled program: neighbor
    selection (top-k covisibility) -> epipolar triangulation against each
    neighbor (lax.scan over the fixed neighbor budget) -> duplicate fusion
    -> landmark statistics refresh. Replaces the host loop that issued
    ~10 separate device programs (+ host syncs) per keyframe, whose
    dispatches and syncs dominated the mapping cost.
    (Reference: LocalMapping::CreateNewMapPoints + SearchInNeighbors +
    MapPoint stat updates, src/LocalMapping.cc:520,868.)"""
    covis = ms.covisibility_row(m, kf_new)
    covis = jnp.where(m.kf_valid, covis, -1)
    covis = covis.at[kf_new].set(-1)
    vals, nbrs = jax.lax.top_k(covis, n_neighbors)
    nbr_ok = vals >= min_covis

    def body(carry, x):
        m_c, total = carry
        nbr, ok = x
        out = _triangulate_pair(m_c, kf_new, nbr, K, ok)
        return (out.map, total + out.n_created), None

    (m, n_created), _ = jax.lax.scan(
        body, (m, jnp.int32(0)), (nbrs.astype(jnp.int32), nbr_ok))
    fuse = fuse_into_keyframe(m, kf_new, K, width=width, height=height,
                              scale_factor=scale_factor, n_levels=n_levels)
    m = fuse.map
    win = jnp.concatenate([jnp.asarray(kf_new, jnp.int32)[None],
                           nbrs.astype(jnp.int32)])
    win_ok = jnp.concatenate([jnp.ones(1, bool), nbr_ok])
    m = ms.refresh_point_stats(m, win, win_ok, scale_factor=scale_factor,
                               n_levels=n_levels)
    return KFProcessOut(map=m, n_created=n_created, n_fused=fuse.n_fused,
                        neighbors=nbrs.astype(jnp.int32), neighbor_ok=nbr_ok)


class FuseOut(NamedTuple):
    map: MapState
    n_fused: jnp.ndarray     # duplicate landmarks merged
    n_attached: jnp.ndarray  # new associations written


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "scale_factor",
                                    "n_levels"))
def fuse_into_keyframe(m: MapState, kf, K: cam.PinholeK, *,
                       width: int, height: int, scale_factor: float = 1.2,
                       n_levels: int = 8, radius: float = 3.0,
                       max_dist: int = matcher.TH_LOW) -> FuseOut:
    """Project map landmarks into keyframe `kf` and reconcile with its
    features (reference LocalMapping::SearchInNeighbors ->
    ORBmatcher::Fuse, src/LocalMapping.cc:868, src/ORBmatcher.cc:1395):

    - feature already bound to a DIFFERENT landmark -> merge duplicates,
      keeping the landmark with more observations (MapPoint::Replace);
    - unbound feature -> attach the projected landmark.
    """
    T = m.kf_pose[kf]
    K = ms.kf_intrinsics(m, kf, K)      # per-KF camera (heterogeneous agents)
    p_c = se3.apply(T[None], m.mp_pos)
    uv_proj = cam.project(K, p_c)
    cam_center = -jnp.einsum("ji,j->i", T[:3, :3], T[:3, 3])
    dist = jnp.linalg.norm(m.mp_pos - cam_center[None, :], axis=-1)
    # scale-invariance distance gate (Fuse checks dist within [min, max])
    d_ok = (dist >= 0.8 * m.mp_min_dist) & (dist <= 1.2 * m.mp_max_dist)
    # viewing angle gate: cos(normal, view) > 0.5 (Fuse's 60 degree test)
    view = (m.mp_pos - cam_center[None, :]) / jnp.maximum(dist, 1e-8)[:, None]
    angle_ok = jnp.sum(view * m.mp_normal, axis=-1) > 0.5
    proj_valid = (m.mp_valid & (m.mp_map_id == m.active_map)
                  & (p_c[..., 2] > 0.05) & d_ok & angle_ok
                  & cam.in_image(uv_proj, width, height))
    ratio = jnp.maximum(m.mp_max_dist, 1e-6) / jnp.maximum(dist, 1e-6)
    pred_lv = jnp.clip((jnp.log(jnp.maximum(ratio, 1e-6))
                        / jnp.log(scale_factor)).astype(jnp.int32),
                       0, n_levels - 1)
    r = radius * jnp.power(jnp.float32(scale_factor),
                           pred_lv.astype(jnp.float32))
    res = matcher.match_by_projection(
        uv_proj, proj_valid, m.mp_desc, m.kf_uv[kf], m.kf_feat_valid[kf],
        m.kf_desc[kf], m.kf_level[kf], r, pred_lv,
        max_dist=max_dist, ratio=1.0, level_slack=1)
    res = matcher.resolve_duplicate_targets(res, m.n_feat)

    # invert: per-feature candidate landmark
    P = m.max_mp
    tgt = jnp.where(res.idx >= 0, res.idx, m.n_feat)
    cand_ext = jnp.full((m.n_feat + 1,), NO_MP, jnp.int32).at[tgt].set(
        jnp.where(res.idx >= 0, jnp.arange(P, dtype=jnp.int32), NO_MP))
    cand = cand_ext[:m.n_feat]                           # (N,)
    existing = m.kf_mp[kf]                               # (N,)

    # observation counts decide the survivor on duplicate merges
    flat = m.kf_mp.reshape(-1)
    obs_w = ((flat >= 0) & m.kf_feat_valid.reshape(-1)
             & jnp.repeat(m.kf_valid, m.n_feat)).astype(jnp.int32)
    counts = jnp.zeros((P + 1,), jnp.int32).at[
        jnp.where(flat >= 0, flat, P)].add(obs_w)[:P]

    dup = (cand >= 0) & (existing >= 0) & (cand != existing)
    cand_safe = jnp.where(cand >= 0, cand, 0)
    exist_safe = jnp.where(existing >= 0, existing, 0)
    keep_cand = counts[cand_safe] >= counts[exist_safe]
    old = jnp.where(dup, jnp.where(keep_cand, exist_safe, cand_safe), -1)
    new = jnp.where(dup, jnp.where(keep_cand, cand_safe, exist_safe), -1)
    m = ms.replace_mappoint(m, old, new)

    attach = (cand >= 0) & (m.kf_mp[kf] == NO_MP)
    kf_row = jnp.where(attach, cand, m.kf_mp[kf])
    m = m._replace(kf_mp=m.kf_mp.at[kf].set(kf_row))
    return FuseOut(map=m, n_fused=jnp.sum(dup.astype(jnp.int32)),
                   n_attached=jnp.sum(attach.astype(jnp.int32)))


class MapKFOut(NamedTuple):
    map: MapState
    n_created: jnp.ndarray
    n_fused: jnp.ndarray
    chi2: jnp.ndarray


@functools.partial(jax.jit,
                   static_argnames=("n_neighbors", "width", "height",
                                    "scale_factor", "n_levels", "n_window",
                                    "n_fixed", "n_points", "iters",
                                    "covis_threshold"))
def map_keyframe(m: MapState, kf_new, K: cam.PinholeK, *,
                 n_neighbors: int, width: int, height: int,
                 scale_factor: float, n_levels: int,
                 n_window: int, n_fixed: int, n_points: int,
                 iters: int, covis_threshold: int = 15,
                 bf=0.0) -> MapKFOut:
    """The WHOLE per-keyframe mapping chain — triangulate/fuse/stats +
    windowed BA — as ONE compiled program: one dispatch, one jit-cache
    lookup per keyframe instead of two ~35-array pytree calls, whose
    host dispatch overhead repeats on every keyframe)."""
    proc = process_new_keyframe(
        m, kf_new, K, n_neighbors=n_neighbors, width=width, height=height,
        scale_factor=scale_factor, n_levels=n_levels)
    out = local_bundle_adjustment(
        proc.map, kf_new, K, n_window=n_window, n_fixed=n_fixed,
        n_points=n_points, scale_factor=scale_factor, iters=iters,
        covis_threshold=covis_threshold, bf=bf)
    return MapKFOut(map=out.map, n_created=proc.n_created,
                    n_fused=proc.n_fused, chi2=out.chi2)


class LocalBAOut(NamedTuple):
    map: MapState
    chi2: jnp.ndarray
    n_window: jnp.ndarray


@functools.partial(jax.jit,
                   static_argnames=("n_window", "n_fixed", "n_points",
                                    "scale_factor", "iters"))
def local_bundle_adjustment(m: MapState, kf_center, K: cam.PinholeK, *,
                            n_window: int = 16, n_fixed: int = 8,
                            n_points: int = 4096, scale_factor: float = 1.2,
                            iters: int = 8,
                            covis_threshold: int = 15,
                            bf=0.0) -> LocalBAOut:
    """Windowed BA around `kf_center` (reference LocalBundleAdjustment,
    Optimizer.cc:1810): the window is the top covisible keyframes; the next
    ring is fixed anchors; window landmarks are every point those KFs
    observe (capped). Results write back into the map; observations
    classified as outliers are detached (reference erases the g2o edges and
    the MapPoint observations)."""
    Kcap, N = m.kf_mp.shape
    covis = ms.covisibility_row(m, kf_center)            # (Kcap,)
    covis = jnp.where(m.kf_valid, covis, -1)
    covis = covis.at[kf_center].set(jnp.int32(1 << 20))  # center always first
    order = jnp.argsort(-covis)                          # descending
    win = order[:n_window]                               # optimized KFs
    anchors = order[n_window:n_window + n_fixed]
    win_ok = covis[win] >= covis_threshold
    win_ok = win_ok.at[0].set(True)
    anchor_ok = covis[anchors] >= 1
    # the oldest window KF is clamped if no anchors exist (gauge); locked
    # poses are always fixed (server-correction precedence)
    any_anchor = jnp.any(anchor_ok)
    slots = jnp.concatenate([win, anchors])              # (Kw,) global kf ids
    slot_ok = jnp.concatenate([win_ok, anchor_ok])
    fixed = jnp.concatenate([
        jnp.zeros(n_window, bool), jnp.ones(n_fixed, bool)])
    fixed = fixed | m.kf_pose_locked[slots] | ~slot_ok
    # gauge guard: fix the lowest-id valid window KF when no anchor is active
    oldest = jnp.argmin(jnp.where(win_ok, win, 1 << 20))
    fixed = fixed.at[oldest].set(jnp.where(any_anchor, fixed[oldest], True))

    Kw = n_window + n_fixed
    # window landmarks: everything observed by window KFs, capped at n_points
    obs_mp = jnp.where(slot_ok[:, None], m.kf_mp[slots], NO_MP)  # (Kw, N)
    uniq = jnp.unique(obs_mp, size=n_points, fill_value=NO_MP)
    pt_global = uniq                                      # (Pw,) sorted, -1 first
    pt_ok = pt_global >= 0
    # LUT global slot -> window-local index
    lut = jnp.full((m.max_mp + 1,), -1, jnp.int32)
    lut = lut.at[jnp.where(pt_ok, pt_global, m.max_mp)].set(
        jnp.where(pt_ok, jnp.arange(n_points, dtype=jnp.int32), -1))

    flat_mp = obs_mp.reshape(-1)
    local_pt = lut[jnp.where(flat_mp >= 0, flat_mp, m.max_mp)]
    obs_valid = (flat_mp >= 0) & (local_pt >= 0) & \
        m.kf_feat_valid[slots].reshape(-1)
    obs = local_ba.BAObservations(
        kf=jnp.repeat(jnp.arange(Kw, dtype=jnp.int32), N),
        pt=jnp.where(local_pt >= 0, local_pt, 0),
        uv=m.kf_uv[slots].reshape(-1, 2),
        inv_sigma2=level_inv_sigma2(m.kf_level[slots].reshape(-1),
                                    scale_factor),
        valid=obs_valid,
        u_r=m.kf_ur[slots].reshape(-1))

    poses0 = m.kf_pose[slots]
    points0 = m.mp_pos[jnp.where(pt_ok, pt_global, 0)]
    # per-observation intrinsics: window keyframes may belong to agents
    # with different (rectified) cameras
    K_slots = ms.kf_intrinsics(m, slots, K)
    K_obs = cam.PinholeK(*(jnp.repeat(f, N) for f in K_slots))
    res = local_ba.bundle_adjust(poses0, fixed, points0, obs, K_obs,
                                 iters=iters, bf=bf, grouped=True)

    # --- write back (parked scatters go to a padded scratch row so they can
    # never collide with genuine writes) ---
    write_kf = slot_ok & ~fixed
    kf_pose_ext = jnp.concatenate([m.kf_pose, jnp.zeros((1, 4, 4))], axis=0)
    kf_pose = kf_pose_ext.at[jnp.where(write_kf, slots, Kcap)].set(
        res.poses)[:Kcap]
    mp_pos_ext = jnp.concatenate([m.mp_pos, jnp.zeros((1, 3))], axis=0)
    mp_pos = mp_pos_ext.at[jnp.where(pt_ok, pt_global, m.max_mp)].set(
        res.points)[:m.max_mp]
    # detach outlier observations
    out_mask = obs_valid & ~res.inliers
    kf_flat = jnp.repeat(slots, N)
    feat_flat = jnp.tile(jnp.arange(N, dtype=jnp.int32), Kw)
    kf_mp_ext = jnp.concatenate(
        [m.kf_mp, jnp.zeros((1, N), jnp.int32)], axis=0)
    kf_mp = kf_mp_ext.at[jnp.where(out_mask, kf_flat, Kcap),
                         feat_flat].set(NO_MP)[:Kcap]
    m2 = m._replace(kf_pose=kf_pose, mp_pos=mp_pos, kf_mp=kf_mp)
    return LocalBAOut(map=m2, chi2=res.chi2,
                      n_window=jnp.sum(win_ok.astype(jnp.int32)))
