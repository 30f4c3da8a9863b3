"""Frame tracking: jitted projection-match + pose-opt steps.

Replaces the reference Tracking thread's per-frame pipeline
(Tracking::Track, src/Tracking.cc:1527-2061): TrackWithMotionModel
(:2590) and TrackLocalMap (:2689) become one fused jitted step that
matches the *entire* map against the frame with masked dense Hamming
matrices (no feature grid, no covisibility-local-map gathering — brute
force over the fixed-capacity map replaces sparse bookkeeping), runs two rounds of guided matching at shrinking radii with a
pose optimization after each, and returns the per-feature landmark
associations that the keyframe decision needs. TrackReferenceKeyFrame
(:2461) is a separate jitted fallback using mutual descriptor matching.

The LOST/RECENTLY_LOST state ladder and keyframe decision stay on the
host (system.py) — they are scalar control flow at frame rate.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.frontend import matcher
from multi_orbslam3_jax.frontend.extractor import FrameFeatures
from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3
from multi_orbslam3_jax.map.mapstate import NO_MP, MapState
from multi_orbslam3_jax.opt import pose_opt


class TrackResult(NamedTuple):
    pose: jnp.ndarray       # (4, 4) optimized T_cw
    feat_mp: jnp.ndarray    # (N,) int32 landmark slot per feature (NO_MP none)
    n_inliers: jnp.ndarray  # () int32
    n_matches: jnp.ndarray  # () int32 pre-optimization matches
    visible: jnp.ndarray    # (P,) bool landmarks in this frame's frustum
                            # (feeds MapPoint::IncreaseVisible statistics)
    # (18,) f32 [pose.ravel(), n_inliers, n_matches] — everything the
    # host state machine reads, in ONE device->host transfer: separate
    # int(n_inliers) + np.asarray(pose) fetches are a host sync each.
    packed: jnp.ndarray = None


def level_inv_sigma2(level: jnp.ndarray, scale_factor: float) -> jnp.ndarray:
    """Per-keypoint information: 1 / (scale^level)^2 (reference
    Frame::mvInvLevelSigma2)."""
    return jnp.power(jnp.float32(scale_factor),
                     -2.0 * level.astype(jnp.float32))


def _predict_levels(m: MapState, cam_center: jnp.ndarray,
                    scale_factor: float, n_levels: int) -> jnp.ndarray:
    """Predict the pyramid level a landmark should appear at from its
    distance (reference MapPoint::PredictScale, src/MapPoint.cc:545-662)."""
    dist = jnp.linalg.norm(m.mp_pos - cam_center[None, :], axis=-1)
    ratio = jnp.maximum(m.mp_max_dist, 1e-6) / jnp.maximum(dist, 1e-6)
    lv = jnp.log(jnp.maximum(ratio, 1e-6)) / jnp.log(scale_factor)
    return jnp.clip(lv.astype(jnp.int32), 0, n_levels - 1)


def _match_and_invert(m: MapState, T: jnp.ndarray, feats: FrameFeatures,
                      K: cam.PinholeK, radius: float, width: int, height: int,
                      scale_factor: float, n_levels: int, level_slack: int):
    """Project all landmarks into pose T, match to frame features, return
    per-feature landmark index (N,)."""
    p_c = se3.apply(T[None], m.mp_pos)
    uv_proj = cam.project(K, p_c)
    cam_center = -jnp.einsum("ji,j->i", T[:3, :3], T[:3, 3])
    proj_valid = (m.mp_valid & (m.mp_map_id == m.active_map)
                  & (p_c[..., 2] > 0.1)
                  & cam.in_image(uv_proj, width, height))
    # scale the search radius with the predicted level (reference does the
    # same through mvScaleFactors[nPredictedLevel])
    pred_lv = _predict_levels(m, cam_center, scale_factor, n_levels)
    r = radius * jnp.power(jnp.float32(scale_factor),
                           pred_lv.astype(jnp.float32))
    res = matcher.match_by_projection(
        uv_proj, proj_valid, m.mp_desc, feats.uv_und, feats.valid, feats.desc,
        feats.level, r, pred_lv, max_dist=matcher.TH_HIGH, ratio=0.9,
        level_slack=level_slack)
    res = matcher.resolve_duplicate_targets(res, feats.uv_und.shape[0])
    # invert MP->feature into feature->MP (invalid rows park at slot N)
    n_feat = feats.uv_und.shape[0]
    tgt = jnp.where(res.idx >= 0, res.idx, n_feat)
    feat_mp_ext = jnp.full((n_feat + 1,), NO_MP, jnp.int32).at[tgt].set(
        jnp.where(res.idx >= 0,
                  jnp.arange(m.mp_pos.shape[0], dtype=jnp.int32), NO_MP))
    return feat_mp_ext[:n_feat], proj_valid


def _pose_from_assoc(m: MapState, feats: FrameFeatures, feat_mp: jnp.ndarray,
                     T_init: jnp.ndarray, K: cam.PinholeK,
                     scale_factor: float, rounds: int = 4, iters: int = 10,
                     u_r=None, bf=0.0):
    mp_safe = jnp.where(feat_mp >= 0, feat_mp, 0)
    p_world = m.mp_pos[mp_safe]
    inv_s2 = level_inv_sigma2(feats.level, scale_factor)
    mask = (feat_mp >= 0) & feats.valid
    res = pose_opt.pose_optimization(T_init, K, p_world, feats.uv_und,
                                     inv_s2, mask, rounds=rounds,
                                     iters=iters, u_r=u_r, bf=bf)
    feat_mp_in = jnp.where(res.inliers, feat_mp, NO_MP)
    return res.pose, feat_mp_in, res.n_inliers


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "scale_factor", "n_levels",
                     "opt_rounds", "opt_iters"))
def track_frame(m: MapState, feats: FrameFeatures, T_pred: jnp.ndarray,
                K: cam.PinholeK, *, width: int, height: int,
                scale_factor: float, n_levels: int,
                radius_coarse: float = 15.0,
                radius_fine: float = 4.0,
                opt_rounds: int = 2, opt_iters: int = 7,
                u_r=None, bf=0.0) -> TrackResult:
    """Two-round guided tracking: coarse match at the predicted pose,
    optimize, re-match finely at the optimized pose, optimize again.

    opt_rounds/opt_iters trade accuracy for latency: the reference runs
    4x10 LM iterations (Optimizer.cc:964) from colder inits; with the
    motion-model seed and the re-match between stages, 2x7 converges to
    the same inlier set and halves the sequential-iteration latency of
    the step.

    u_r/bf: optional per-feature stereo right-u + baseline*fx — adds the
    reference's stereo pose edges (PoseOptimization stereo branch).
    """
    feat_mp, _ = _match_and_invert(m, T_pred, feats, K, radius_coarse,
                                   width, height, scale_factor, n_levels,
                                   level_slack=2)
    n_matches = jnp.sum((feat_mp >= 0).astype(jnp.int32))
    T1, feat_mp1, n1 = _pose_from_assoc(m, feats, feat_mp, T_pred, K,
                                        scale_factor, opt_rounds, opt_iters,
                                        u_r, bf)
    # round 2: tighter radius around the refined pose picks up more points
    feat_mp2, visible = _match_and_invert(m, T1, feats, K, radius_fine,
                                          width, height, scale_factor,
                                          n_levels, level_slack=1)
    # keep round-1 inlier associations where round 2 found nothing
    feat_mp2 = jnp.where(feat_mp2 >= 0, feat_mp2, feat_mp1)
    T2, feat_mp_f, n2 = _pose_from_assoc(m, feats, feat_mp2, T1, K,
                                         scale_factor, opt_rounds, opt_iters,
                                         u_r, bf)
    return TrackResult(pose=T2, feat_mp=feat_mp_f, n_inliers=n2,
                       n_matches=n_matches, visible=visible)


@functools.lru_cache(maxsize=8)
def _fused_step(config):
    """Build (and cache) the fused extract+track program for a config."""
    from multi_orbslam3_jax.frontend import extractor as _ex
    from multi_orbslam3_jax.map import mapstate as _ms

    c = config

    @jax.jit
    def step(m, img, T_pred):
        feats = _ex.extract_features(img, c)
        K = cam.intrinsics_from_config(c.camera)
        res = track_frame(
            m, feats, T_pred, K, width=c.camera.width, height=c.camera.height,
            scale_factor=c.orb.scale_factor, n_levels=c.orb.n_levels,
            radius_coarse=c.tracking.search_radius)
        # landmark found/visible statistics folded into the same program
        # (MapPoint::IncreaseFound/IncreaseVisible) — applied only when
        # the track looks healthy, like the host decision would
        m2 = _ms.update_found_visible(m, res.feat_mp, res.visible)
        ok = res.n_inliers >= c.tracking.min_matches_refkf
        m2 = m._replace(
            mp_found=jnp.where(ok, m2.mp_found, m.mp_found),
            mp_visible=jnp.where(ok, m2.mp_visible, m.mp_visible))
        res = res._replace(packed=jnp.concatenate([
            res.pose.reshape(-1).astype(jnp.float32),
            jnp.stack([res.n_inliers.astype(jnp.float32),
                       res.n_matches.astype(jnp.float32)])]))
        return feats, res, m2

    return step


@functools.lru_cache(maxsize=8)
def _fused_step_chained(config):
    """Fused extract+track with the prediction chain ON DEVICE.

    The pipelined frame loop (system.process_frame_pipelined) dispatches
    frame i and finalizes frame i-1's host state machine while i
    computes, hiding the device->host fetch behind device work. That requires the next frame's T_pred to come from the
    device-resident chain, not from host state: this step takes
    (T_cur, T_vel), forms T_pred = T_vel @ T_cur, tracks, and returns
    the guarded next chain state (pose falls back to T_pred and T_vel
    holds when the track is weak — mirroring the host RECENTLY_LOST
    prediction behavior, reference Tracking.cc:1691-1766).

    packed layout: [pose(16), n_inliers, n_matches, T_pred(16)] — the
    first 18 match _fused_step so _track_decide reads both."""
    from multi_orbslam3_jax.frontend import extractor as _ex
    from multi_orbslam3_jax.map import mapstate as _ms

    c = config

    @jax.jit
    def step(m, img, T_cur, T_vel):
        T_pred = (T_vel @ T_cur).astype(jnp.float32)
        feats = _ex.extract_features(img.astype(jnp.float32), c)
        K = cam.intrinsics_from_config(c.camera)
        res = track_frame(
            m, feats, T_pred, K, width=c.camera.width,
            height=c.camera.height, scale_factor=c.orb.scale_factor,
            n_levels=c.orb.n_levels,
            radius_coarse=c.tracking.search_radius)
        ok = res.n_inliers >= c.tracking.min_matches_refkf
        pose = jnp.where(ok, res.pose, T_pred)
        T_vel_new = jnp.where(ok, res.pose @ jnp.linalg.inv(T_cur), T_vel)
        packed = jnp.concatenate([
            pose.reshape(-1).astype(jnp.float32),
            jnp.stack([res.n_inliers.astype(jnp.float32),
                       res.n_matches.astype(jnp.float32)]),
            T_pred.reshape(-1).astype(jnp.float32)])
        res = res._replace(pose=pose, packed=packed)
        return feats, res, pose, T_vel_new

    return step


@functools.lru_cache(maxsize=8)
def _fused_step_stereo_chained(config):
    """Stereo twin of _fused_step_chained: both extractions + the
    per-feature stereo match + guided tracking with stereo residuals in
    ONE program, prediction chain on device (reference GrabImageStereo →
    Track, src/Tracking.cc:1014)."""
    from multi_orbslam3_jax.frontend import extractor as _ex
    from multi_orbslam3_jax.frontend import stereo as _st

    c = config
    bf = jnp.float32(c.camera.baseline * c.camera.fx)

    @jax.jit
    def step(m, img_l, img_r, T_cur, T_vel):
        T_pred = (T_vel @ T_cur).astype(jnp.float32)
        feats = _ex.extract_features(img_l.astype(jnp.float32), c)
        feats_r = _ex.extract_features(img_r.astype(jnp.float32), c)
        sd = _st.stereo_match(feats, feats_r, bf)
        K = cam.intrinsics_from_config(c.camera)
        res = track_frame(
            m, feats, T_pred, K, width=c.camera.width,
            height=c.camera.height, scale_factor=c.orb.scale_factor,
            n_levels=c.orb.n_levels,
            radius_coarse=c.tracking.search_radius,
            u_r=sd.u_right, bf=bf)
        ok = res.n_inliers >= c.tracking.min_matches_refkf
        pose = jnp.where(ok, res.pose, T_pred)
        T_vel_new = jnp.where(ok, res.pose @ jnp.linalg.inv(T_cur), T_vel)
        packed = jnp.concatenate([
            pose.reshape(-1).astype(jnp.float32),
            jnp.stack([res.n_inliers.astype(jnp.float32),
                       res.n_matches.astype(jnp.float32)]),
            T_pred.reshape(-1).astype(jnp.float32)])
        res = res._replace(pose=pose, packed=packed)
        return feats, sd, res, pose, T_vel_new

    return step


def extract_and_track(m: MapState, img: jnp.ndarray, T_pred: jnp.ndarray,
                      config) -> tuple:
    """Fused per-frame step: ORB extraction + two-round guided tracking +
    landmark statistics refresh in ONE compiled program — no host
    roundtrip between the stages (the host-side state machine only
    consumes the scalar outputs). Returns (feats, result, updated map)."""
    return _fused_step(config)(m, img, T_pred)


@functools.partial(jax.jit, static_argnames=("scale_factor",))
def relocalize_candidate(m: MapState, cand_kf: jnp.ndarray,
                         feats: FrameFeatures, K: cam.PinholeK,
                         key: jnp.ndarray,
                         scale_factor: float = 1.2) -> TrackResult:
    """Relocalization against a BoW candidate keyframe (reference
    Tracking::Relocalization, src/Tracking.cc:3353): descriptor-match the
    frame to the candidate's landmark-bearing features, solve the pose
    from scratch with batched RANSAC PnP (PnPsolver/MLPnPsolver analog —
    no motion-model or candidate-pose seed), then refine."""
    from multi_orbslam3_jax.opt import pnp

    kf_desc = m.kf_desc[cand_kf]
    kf_feat_valid = m.kf_feat_valid[cand_kf] & (m.kf_mp[cand_kf] >= 0)
    res = matcher.match_mutual(feats.desc, feats.valid, kf_desc,
                               kf_feat_valid, max_dist=matcher.TH_LOW,
                               ratio=0.85, angle1=feats.angle,
                               angle2=m.kf_angle[cand_kf])
    kf_mp_row = m.kf_mp[cand_kf]
    feat_mp = jnp.where(res.idx >= 0,
                        kf_mp_row[jnp.where(res.idx >= 0, res.idx, 0)], NO_MP)
    n_matches = jnp.sum((feat_mp >= 0).astype(jnp.int32))
    mp_safe = jnp.where(feat_mp >= 0, feat_mp, 0)
    sol = pnp.pnp_ransac(
        K, m.mp_pos[mp_safe], feats.uv_und, (feat_mp >= 0) & feats.valid,
        level_inv_sigma2(feats.level, scale_factor), key)
    feat_mp_in = jnp.where(sol.inliers, feat_mp, NO_MP)
    visible = jnp.zeros(m.mp_pos.shape[0], bool).at[
        jnp.where(kf_mp_row >= 0, kf_mp_row, 0)].max(kf_mp_row >= 0)
    return TrackResult(pose=sol.pose, feat_mp=feat_mp_in,
                       n_inliers=jnp.where(sol.ok, sol.n_inliers, 0),
                       n_matches=n_matches, visible=visible)


@functools.partial(jax.jit, static_argnames=("scale_factor",))
def track_reference_kf(m: MapState, ref_kf: jnp.ndarray, feats: FrameFeatures,
                       T_init: jnp.ndarray, K: cam.PinholeK,
                       scale_factor: float = 1.2) -> TrackResult:
    """Fallback when motion-model tracking fails (reference
    TrackReferenceKeyFrame, src/Tracking.cc:2461): mutual-match the frame
    against the reference keyframe's features, inherit its landmark
    associations, optimize from the last pose."""
    kf_desc = m.kf_desc[ref_kf]
    kf_feat_valid = m.kf_feat_valid[ref_kf] & (m.kf_mp[ref_kf] >= 0)
    res = matcher.match_mutual(feats.desc, feats.valid, kf_desc,
                               kf_feat_valid, max_dist=matcher.TH_LOW,
                               ratio=0.8, angle1=feats.angle,
                               angle2=m.kf_angle[ref_kf])
    kf_mp_row = m.kf_mp[ref_kf]
    feat_mp = jnp.where(res.idx >= 0, kf_mp_row[jnp.where(
        res.idx >= 0, res.idx, 0)], NO_MP)
    n_matches = jnp.sum((feat_mp >= 0).astype(jnp.int32))
    T, feat_mp_in, n_in = _pose_from_assoc(m, feats, feat_mp, T_init, K,
                                           scale_factor)
    # visible = the landmarks this KF already associates (conservative)
    visible = jnp.zeros(m.mp_pos.shape[0], bool).at[
        jnp.where(kf_mp_row >= 0, kf_mp_row, 0)].max(kf_mp_row >= 0)
    return TrackResult(pose=T, feat_mp=feat_mp_in, n_inliers=n_in,
                       n_matches=n_matches, visible=visible)
