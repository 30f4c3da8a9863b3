"""Loop detection + correction (single-map).

Replaces the loop half of the reference LoopClosing thread
(src/LoopClosing.cc: NewDetectCommonRegions :270, CorrectLoop :1054):

- detection: shared-database BoW query (one matvec) -> best candidate ->
  host-side temporal consistency counter (3 consecutive hits like the
  reference) -> geometric verification by 3D-3D Sim3 Horn RANSAC over
  descriptor-matched landmark pairs (the reference's Sim3Solver +
  OptimizeSim3 + guided projection cascade collapses into RANSAC + IRLS
  refinement over fixed-size hypothesis batches);
- correction: a Sim3 essential-graph optimization over all keyframes
  (spanning tree + strong covisibility + the loop edge), landmark
  correction through each point's reference keyframe, and duplicate
  fusion by replacing matched current-side landmarks with their
  loop-side counterparts (MapPoint::Replace analog).

The inter-agent merge variant lives in collab/server.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.bow import database as dbm
from multi_orbslam3_jax.bow.vocabulary import Vocabulary
from multi_orbslam3_jax.frontend import matcher
from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3, sim3
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.map.mapstate import NO_MP, MapState
from multi_orbslam3_jax.opt import pose_graph, sim3_solve


class LoopMatch(NamedTuple):
    """Landmark correspondences between the current KF region and the
    candidate KF region."""
    cur_mp: jnp.ndarray      # (N,) current-side landmark slots (-1 invalid)
    cand_mp: jnp.ndarray     # (N,) candidate-side landmark slots
    valid: jnp.ndarray       # (N,) bool
    cur_region: jnp.ndarray  # (P,) bool current-side region landmark mask
    cand_region: jnp.ndarray  # (P,) bool candidate-side region mask


@jax.jit
def match_loop_landmarks(m: MapState, kf_cur, kf_cand) -> LoopMatch:
    """Descriptor-match the landmarks of the two keyframes' covisible
    REGIONS (the reference matches the candidate's covisible-group
    map points, not just the single KF — LoopClosing's
    DetectCommonRegionsFromBoW gathers vpCovKFi landmarks). Region-level
    sets give the Sim3 RANSAC 5-10x more correspondences than per-KF
    feature matching."""
    obs = ms.kf_mp_mask(m)                        # (K, P)
    K = m.max_kf
    covis_cur = ms.covisibility_row(m, kf_cur)
    covis_cand = ms.covisibility_row(m, kf_cand)
    grp_cur = (covis_cur > 0) | (jnp.arange(K) == kf_cur)
    grp_cand = (covis_cand > 0) | (jnp.arange(K) == kf_cand)
    mp_cur = jnp.any(obs & grp_cur[:, None], axis=0)     # (P,)
    mp_cand = jnp.any(obs & grp_cand[:, None], axis=0)
    # drop landmarks shared by both regions (already-fused overlap)
    both = mp_cur & mp_cand
    mp_cur = mp_cur & ~both
    mp_cand = mp_cand & ~both
    # ratio 0.95: across heterogeneous cameras the descriptor gap widens
    # and the ratio test starves the RANSAC of seeds; the downstream
    # Sim3 refinement + guided-projection gate carry the verification
    res = matcher.match_mutual(m.mp_desc, mp_cur, m.mp_desc, mp_cand,
                               max_dist=matcher.TH_LOW, ratio=0.95)
    P = m.max_mp
    valid = res.idx >= 0
    return LoopMatch(
        cur_mp=jnp.where(valid, jnp.arange(P, dtype=jnp.int32), -1),
        cand_mp=jnp.where(valid, res.idx, -1), valid=valid,
        cur_region=mp_cur, cand_region=mp_cand)


@functools.partial(jax.jit, static_argnames=("fix_scale",))
def verify_loop(m: MapState, lm: LoopMatch, key,
                fix_scale: bool = False) -> sim3_solve.Sim3RansacResult:
    """Sim3 RANSAC on the matched landmark pairs: finds S with
    p_cur ~ S(p_cand). The inlier threshold scales with the current
    region's median depth spread."""
    p_cand = m.mp_pos[jnp.where(lm.valid, lm.cand_mp, 0)]
    p_cur = m.mp_pos[jnp.where(lm.valid, lm.cur_mp, 0)]
    # masked spread of the current-side points (ignore padding rows)
    n = jnp.maximum(jnp.sum(lm.valid), 1)
    mean = jnp.sum(jnp.where(lm.valid[:, None], p_cur, 0.0), axis=0) / n
    var = jnp.sum(jnp.where(lm.valid[:, None],
                            (p_cur - mean) ** 2, 0.0), axis=0) / n
    spread = jnp.sqrt(jnp.sum(var))
    # coarse gate: triangulation noise across two independently-built maps
    # is large; the post-correction pose graph / welding BA refines
    # (reference runs SearchAndFuse + MergeInertialBA after Sim3 accept)
    th = jnp.maximum(0.1 * spread, 1e-3)
    # min_inliers is the SEED gate only: acceptance is decided by the
    # reprojection-space Sim3 refinement + guided-projection count
    # (min_proj_matches), so a small consistent seed set suffices — the
    # reference likewise seeds Sim3Solver with few correspondences and
    # lets SearchByProjection grow them (LoopClosing.cc:580+)
    return sim3_solve.sim3_ransac(p_cand, p_cur, lm.valid, key,
                                  n_hyp=192, inlier_th=th,
                                  min_inliers=8, fix_scale=fix_scale)


@jax.jit
def _pair_observations(m: MapState, kf, mp_idx: jnp.ndarray):
    """Per-pair 2D observation of landmark mp_idx in keyframe kf:
    (uv (N,2), inv_sigma2 (N,), has (N,)). Landmarks not associated to a
    feature of kf get has=False."""
    row = m.kf_mp[kf]                                  # (N,) mp per feature
    N = row.shape[0]
    lut = jnp.full((m.max_mp + 1,), -1, jnp.int32)
    lut = lut.at[jnp.where(row >= 0, row, m.max_mp)].set(
        jnp.arange(N, dtype=jnp.int32))
    fi = lut[jnp.where(mp_idx >= 0, mp_idx, m.max_mp)]
    has = (fi >= 0) & (mp_idx >= 0)
    fi_s = jnp.where(has, fi, 0)
    uv = m.kf_uv[kf, fi_s]
    lv = m.kf_level[kf, fi_s].astype(jnp.float32)
    inv_s2 = jnp.power(jnp.float32(1.2), -2.0 * lv)
    return uv, inv_s2, has


@functools.partial(jax.jit, static_argnames=("width", "height",
                                             "scale_factor", "n_levels"))
def guided_projection_count(m: MapState, kf_cur, S: sim3.Sim3,
                            cand_region: jnp.ndarray, K: cam.PinholeK,
                            *, width: int, height: int,
                            scale_factor: float = 1.2, n_levels: int = 8,
                            radius: float = 8.0):
    """Guided re-verification (reference LoopClosing::
    FindMatchesByProjection + SearchByProjection re-check, LoopClosing.cc:
    999): project the candidate region's landmarks into the current KF at
    its Sim3-CORRECTED pose and count descriptor matches."""
    from multi_orbslam3_jax.pipeline.tracking import _predict_levels
    S_cur = sim3.from_se3(m.kf_pose[kf_cur])
    S_corr = sim3.compose(S_cur, S)
    T = se3.make(S_corr.R, S_corr.t / S_corr.s)
    K = ms.kf_intrinsics(m, kf_cur, K)      # current KF's own camera
    p_c = se3.apply(T[None], m.mp_pos)
    uv_proj = cam.project(K, p_c)
    ok = cand_region & m.mp_valid & (p_c[..., 2] > 0.05) & \
        cam.in_image(uv_proj, width, height)
    cam_center = -jnp.einsum("ji,j->i", T[:3, :3], T[:3, 3])
    pred_lv = _predict_levels(m, cam_center, scale_factor, n_levels)
    r = radius * jnp.power(jnp.float32(scale_factor),
                           pred_lv.astype(jnp.float32))
    # level gating is disabled (slack = n_levels): across a loop the map
    # carries accumulated scale drift, so scale predictions are unreliable
    # — the descriptor distance + radius carry the verification
    res = matcher.match_by_projection(
        uv_proj, ok, m.mp_desc, m.kf_uv[kf_cur], m.kf_feat_valid[kf_cur],
        m.kf_desc[kf_cur], m.kf_level[kf_cur], r, pred_lv,
        max_dist=matcher.TH_HIGH, ratio=0.9, level_slack=n_levels)
    res = matcher.resolve_duplicate_targets(res, m.kf_uv.shape[1])
    return jnp.sum((res.idx >= 0).astype(jnp.int32))


class CascadeResult(NamedTuple):
    ok: bool
    S: Optional[sim3.Sim3]      # p_cur ~ S(p_cand)
    lm: Optional[LoopMatch]
    inliers: Optional[jnp.ndarray]
    n_proj: int


def verify_candidate_cascade(m: MapState, kf_cur: int, kf_cand: int,
                             key, K: cam.PinholeK, *, width: int,
                             height: int, scale_factor: float = 1.2,
                             n_levels: int = 8, fix_scale: bool = False,
                             min_proj_matches: int = 25) -> CascadeResult:
    """Full geometric verification cascade (reference
    DetectCommonRegionsFromBoW, src/LoopClosing.cc:580): 3D-3D Sim3 RANSAC
    seed -> reprojection-space OptimizeSim3 refinement (Optimizer.cc:4031)
    -> guided projection re-check against the current KF's features. Host
    decisions between jitted stages (loop-rate, not frame-rate)."""
    lm = match_loop_landmarks(m, jnp.int32(kf_cur), jnp.int32(kf_cand))
    res = verify_loop(m, lm, key, fix_scale=fix_scale)
    if not bool(res.ok):
        return CascadeResult(False, None, lm, None, 0)
    # reprojection refinement over pairs with a 2D observation in either KF
    pair_ok = lm.valid & res.inliers
    cur_safe = jnp.where(pair_ok, lm.cur_mp, 0)
    cand_safe = jnp.where(pair_ok, lm.cand_mp, 0)
    p_cand = m.mp_pos[cand_safe]
    p_cur = m.mp_pos[cur_safe]
    uv_cur, is2_cur, has_cur = _pair_observations(
        m, jnp.int32(kf_cur), jnp.where(pair_ok, lm.cur_mp, -1))
    uv_cand, is2_cand, has_cand = _pair_observations(
        m, jnp.int32(kf_cand), jnp.where(pair_ok, lm.cand_mp, -1))
    S_ref, inl_f, inl_b = sim3_solve.optimize_sim3_reprojection(
        res.S, ms.kf_intrinsics(m, jnp.int32(kf_cur), K),
        m.kf_pose[jnp.int32(kf_cur)],
        m.kf_pose[jnp.int32(kf_cand)], p_cand, uv_cur, has_cur,
        p_cur, uv_cand, has_cand, is2_cur, is2_cand,
        fix_scale=fix_scale,
        K_cand=ms.kf_intrinsics(m, jnp.int32(kf_cand), K))
    # fall back to the 3D-3D estimate when too few pairs have 2D obs
    n_2d = int(jnp.sum(has_cur | has_cand))
    S_final = S_ref if n_2d >= 10 else res.S
    # guided projection re-check at the refined Sim3
    n_proj = int(guided_projection_count(
        m, jnp.int32(kf_cur), S_final, lm.cand_region, K,
        width=width, height=height, scale_factor=scale_factor,
        n_levels=n_levels))
    if n_proj < min_proj_matches:
        return CascadeResult(False, S_final, lm, res.inliers, n_proj)
    return CascadeResult(True, S_final, lm, res.inliers, n_proj)


def nbest_candidates(m: MapState, scores_np: np.ndarray,
                     n_best: int = 3, min_score: float = 0.03):
    """Covisibility-group accumulated N-best candidate selection
    (reference KeyFrameDatabase::DetectNBestCandidates,
    src/KeyFrameDatabase.cc:594-763): each raw candidate's score is
    summed over its covisible group; groups are deduped greedily and each
    contributes its best-scoring member."""
    order = np.argsort(-scores_np)[:8]
    cands = []
    used = np.zeros(scores_np.shape[0], bool)
    for k in order:
        if scores_np[k] < min_score or used[k]:
            continue
        covis = np.array(ms.covisibility_row(m, jnp.int32(int(k))))
        grp = (covis > 0)
        grp[k] = True
        acc = float(scores_np[grp].sum())
        rep = int(np.argmax(np.where(grp, scores_np, -1.0)))
        cands.append((rep, acc, grp))
        used |= grp
        if len(cands) >= n_best:
            break
    cands.sort(key=lambda c: -c[1])
    return cands


def weld_after_merge(m: MapState, kf_cur: int, K: cam.PinholeK, *,
                     width: int, height: int, scale_factor: float = 1.2,
                     n_levels: int = 8, n_points: int = 4096,
                     bf: float = 0.0) -> MapState:
    """Welding BA after a loop/merge correction (reference MergeInertialBA
    / MergeBundleAdjustmentVisual + windowed SearchAndFuse,
    src/LoopClosing.cc:2391,2477, src/Optimizer.cc:6986,5961): fuse
    duplicate landmarks into the seam keyframe, then run a local BA
    centered on it — post-fusion covisibility spans both sides of the
    seam, so the window covers the weld."""
    from multi_orbslam3_jax.pipeline import local_mapping
    fuse = local_mapping.fuse_into_keyframe(
        m, jnp.int32(kf_cur), K, width=width, height=height,
        scale_factor=scale_factor, n_levels=n_levels)
    m = fuse.map
    out = local_mapping.local_bundle_adjustment(
        m, jnp.int32(kf_cur), K, n_window=16, n_fixed=8,
        n_points=min(n_points, m.max_mp), scale_factor=scale_factor,
        iters=8, bf=bf)
    return out.map


@functools.partial(jax.jit, static_argnames=("max_covis_edges", "iters",
                                             "fix_scale", "yaw_only"))
def correct_loop(m: MapState, kf_cur, kf_cand, S_loop: sim3.Sim3,
                 max_covis_edges: int = 256, iters: int = 10,
                 fix_scale: bool = False, yaw_only: bool = False,
                 covis_strong: int = 30) -> MapState:
    """Essential-graph correction. S_loop: p_cur ~ S_loop(p_cand) — the
    accumulated drift of the current region relative to the loop region.

    Pose-graph nodes are world-to-camera Sim3s; the loop edge pins the
    corrected current KF at S_cur_corr = S_cur o S_loop (the camera sees
    the same pixels after the world is pulled back through S_loop^-1).

    yaw_only selects the reference's 4-DoF inertial essential graph
    (Optimizer::OptimizeEssentialGraph4DoF, Optimizer.cc:8430, invoked for
    inertial maps at LoopClosing.cc:1264-1273): a gravity-aligned map must
    only float yaw + translation, else the correction tilts the gauge.
    """
    K = m.max_kf
    S_nodes = sim3.stack(sim3.from_se3(m.kf_pose))            # (K, 13)

    # --- edges: spanning tree ---
    child = jnp.arange(K, dtype=jnp.int32)
    parent = m.kf_parent
    tree_ok = (parent >= 0) & m.kf_valid & m.kf_valid[jnp.maximum(parent, 0)]
    tree_i = child
    tree_j = jnp.maximum(parent, 0)

    # --- edges: strong covisibility pairs (top max_covis_edges) ---
    W = ms.covisibility_matrix(m)
    Wu = jnp.triu(W, k=1)
    flat = Wu.reshape(-1)
    vals, idxs = jax.lax.top_k(flat, max_covis_edges)
    cov_i = (idxs // K).astype(jnp.int32)
    cov_j = (idxs % K).astype(jnp.int32)
    cov_ok = vals >= covis_strong

    # --- loop edge ---
    S_cur = sim3.from_se3(m.kf_pose[kf_cur])
    S_cand = sim3.from_se3(m.kf_pose[kf_cand])
    S_cur_corr = sim3.compose(S_cur, S_loop)
    loop_meas = sim3.compose(S_cur_corr, sim3.inverse(S_cand))

    ei = jnp.concatenate([tree_i, cov_i, jnp.asarray(kf_cur)[None]])
    ej = jnp.concatenate([tree_j, cov_j, jnp.asarray(kf_cand)[None]])
    evalid = jnp.concatenate([tree_ok, cov_ok, jnp.ones(1, bool)])
    eweight = jnp.concatenate([
        jnp.ones(K), jnp.ones(max_covis_edges),
        jnp.asarray([100.0])]).astype(jnp.float32)

    edges = pose_graph.make_edges(S_nodes, ei, ej, eweight, evalid)
    # overwrite the loop edge with the *corrected* measurement
    edges = edges._replace(
        S_ij=edges.S_ij.at[-1].set(sim3.stack(loop_meas)))

    fixed = ~m.kf_valid
    fixed = fixed.at[kf_cand].set(True)   # loop region anchors the gauge
    S_opt = pose_graph.optimize_pose_graph(S_nodes, fixed, edges,
                                           iters=iters, fix_scale=fix_scale,
                                           yaw_only=yaw_only)

    # --- write corrected keyframe poses (scale folded into translation) ---
    S_new = sim3.unstack(S_opt)
    new_poses = se3.make(S_new.R, S_new.t / S_new.s[..., None])
    kf_pose = jnp.where(m.kf_valid[:, None, None], new_poses, m.kf_pose)

    # --- correct landmarks through their reference KF:
    # p' = S_new_ref^-1 ( S_old_ref (p) )  (reference CorrectLoop MP update)
    ref = jnp.clip(m.mp_ref_kf, 0, K - 1)
    S_old_ref = sim3.unstack(sim3.stack(sim3.from_se3(m.kf_pose))[ref])
    S_new_ref = sim3.unstack(S_opt[ref])
    p_cam = sim3.apply(S_old_ref, m.mp_pos)
    p_corr = sim3.apply(sim3.inverse(S_new_ref), p_cam)
    mp_pos = jnp.where((m.mp_valid & (m.mp_ref_kf >= 0))[:, None],
                       p_corr, m.mp_pos)
    return m._replace(kf_pose=kf_pose, mp_pos=mp_pos)


@jax.jit
def _pr_step(db, voc, m: MapState, kf):
    """Fused per-keyframe place-recognition step: covisibility exclusion +
    shared-db BoW query + db insert in ONE program (one dispatch per
    keyframe instead of three)."""
    desc = m.kf_desc[kf]
    fvalid = m.kf_feat_valid[kf]
    covis = ms.covisibility_row(m, kf)
    # exclusion matches the reference's CONNECTED group (weight >= 15,
    # KeyFrame::GetConnectedKeyFrames / DetectNBestCandidates) — an
    # any-shared-landmark exclusion suppressed every revisit candidate,
    # because whole-map guided tracking re-associates a few old
    # landmarks the moment a revisit begins. The threshold scales with
    # the feature budget (15 assumes ~1000 features/KF).
    n_feat = m.kf_desc.shape[1]
    thr = max(3, round(15 * n_feat / 1024))
    exclude = (covis >= thr) | (jnp.arange(m.max_kf) == kf)
    scores = dbm.query(db, voc, desc, fvalid, exclude)
    db2, _ = dbm.add_keyframe_bow(db, voc, kf, desc, fvalid)
    return scores, db2


class LoopCloser:
    """Host-side loop-closing controller (detection bookkeeping +
    correction dispatch). One instance per map."""

    def __init__(self, voc: Vocabulary, max_kf: int,
                 consistency_hits: int = 3, min_score: float = 0.03,
                 min_interval_kfs: int = 10):
        self.voc = voc
        self.db = dbm.KeyframeDatabase.empty(max_kf, voc.n_words)
        self.consistency_hits = consistency_hits
        self.min_score = min_score
        self.min_interval_kfs = min_interval_kfs
        self._streak_cand = -1
        self._streak = 0
        self._last_loop_kf = -10**9
        self._key = jax.random.PRNGKey(1234)
        self.loops_closed = 0
        # Sim3 continuity (reference DetectAndReffineSim3FromLastKF /
        # DetectCommonRegionsFromLastKF, src/LoopClosing.cc:523,856): a
        # candidate that survived Sim3 RANSAC but missed the projection
        # gate is retried DIRECTLY on the next keyframes — closer to the
        # revisit the projection count grows — instead of restarting the
        # BoW streak from zero every keyframe.
        self._pending_cand = -1
        self._pending_tries = 0

    def on_keyframe(self, m: MapState, kf: int,
                    fix_scale: bool = False, yaw_only: bool = False,
                    K: Optional[cam.PinholeK] = None,
                    width: int = 0, height: int = 0,
                    scale_factor: float = 1.2, n_levels: int = 8,
                    min_proj_matches: int = 25,
                    active_map_kfs: Optional[int] = None) -> MapState:
        """Process a freshly inserted keyframe: N-best grouped candidates,
        temporal consistency, full verification cascade, correction +
        welding BA. Returns the (possibly corrected) map.

        active_map_kfs: keyframe count of the ACTIVE map, when the
        caller tracks it — maps below 12 KFs only register in the
        database, they never hunt (the reference skips detection for
        <12-KF maps, src/LoopClosing.cc:270+; an immature-map merge
        fits its Sim3 on a handful of noisy landmarks and welds the
        Atlas at a permanently bent seam)."""
        kf_j = jnp.int32(kf)
        # fused: covisibility exclusion + shared-db query + insert
        # (reference excludes the connected group,
        # KeyFrameDatabase::DetectNBestCandidates)
        scores, self.db = _pr_step(self.db, self.voc, m, kf_j)
        if active_map_kfs is not None and active_map_kfs < 12:
            self._streak = 0
            self._streak_cand = -1
            return m
        scores_np = np.array(scores)
        # temporal-adjacency guard (slots are insertion-ordered for a
        # single client): the most recent keyframes always score high
        # and are never loops (the server path excludes own-recent too)
        scores_np[max(0, kf - 10):kf + 1] = 0.0
        best = int(np.argmax(scores_np))
        best_score = float(scores_np[best])

        # continuity retry: re-verify last KF's near-miss candidate
        # without waiting for a fresh BoW streak
        if self._pending_cand >= 0 and K is not None and \
                kf - self._last_loop_kf >= self.min_interval_kfs:
            cand_kf = self._pending_cand
            self._key, sub = jax.random.split(self._key)
            casc = verify_candidate_cascade(
                m, kf, cand_kf, sub, K, width=width, height=height,
                scale_factor=scale_factor, n_levels=n_levels,
                fix_scale=fix_scale, min_proj_matches=min_proj_matches)
            if casc.ok:
                self._pending_cand = -1
                return self._accept(m, kf, cand_kf, casc.S, casc.lm,
                                    casc.inliers, True, K, width, height,
                                    scale_factor, n_levels, fix_scale,
                                    yaw_only)
            self._pending_tries -= 1
            if self._pending_tries <= 0:
                self._pending_cand = -1

        if kf - self._last_loop_kf < self.min_interval_kfs or \
                best_score < self.min_score:
            self._streak = 0
            self._streak_cand = -1
            return m

        # temporal consistency: same candidate region on consecutive KFs
        if self._streak_cand >= 0 and (
                best == self._streak_cand
                or int(ms.covisibility_row(m, jnp.int32(best))[
                    self._streak_cand]) > 0):
            self._streak += 1
        else:
            self._streak = 1
        self._streak_cand = best
        if self._streak < self.consistency_hits:
            return m

        # geometric verification cascade over the N best candidate groups
        if K is None:
            # minimal path for callers without camera context: 3D-3D only
            cands = [(best, best_score, None)]
            use_cascade = False
        else:
            cands = nbest_candidates(m, scores_np, n_best=3,
                                     min_score=self.min_score)
            use_cascade = True
        for cand_kf, _, _ in cands:
            # same-map candidates must be a real revisit (seconds of
            # separation) — a temporally-adjacent pair carries no drift
            # signal, only Sim3 noise (see the server-side twin gate)
            if int(m.kf_map_id[cand_kf]) == int(m.active_map) and \
                    abs(float(m.kf_timestamp[kf])
                        - float(m.kf_timestamp[cand_kf])) < 5.0:
                continue
            self._key, sub = jax.random.split(self._key)
            if use_cascade:
                casc = verify_candidate_cascade(
                    m, kf, cand_kf, sub, K, width=width, height=height,
                    scale_factor=scale_factor, n_levels=n_levels,
                    fix_scale=fix_scale,
                    min_proj_matches=min_proj_matches)
                if not casc.ok:
                    if casc.S is not None and self._pending_cand < 0:
                        # Sim3 RANSAC passed, projection count short:
                        # retry this candidate on the next keyframes
                        self._pending_cand = cand_kf
                        self._pending_tries = 3
                    continue
                S_corr, lm, inliers = casc.S, casc.lm, casc.inliers
            else:
                lm = match_loop_landmarks(m, kf_j, jnp.int32(cand_kf))
                res = verify_loop(m, lm, sub, fix_scale=fix_scale)
                if not bool(res.ok):
                    continue
                S_corr, inliers = res.S, res.inliers
            self._pending_cand = -1
            return self._accept(m, kf, cand_kf, S_corr, lm, inliers,
                                use_cascade, K, width, height,
                                scale_factor, n_levels, fix_scale,
                                yaw_only)
        return m

    def _accept(self, m: MapState, kf: int, cand_kf: int, S_corr, lm,
                inliers, use_cascade: bool, K, width: int, height: int,
                scale_factor: float, n_levels: int, fix_scale: bool,
                yaw_only: bool) -> MapState:
        """Accepted loop/merge: Atlas merge if cross-map, essential-graph
        correction, duplicate fusion, welding BA."""
        kf_j = jnp.int32(kf)
        # candidate in another sub-map => Atlas merge: weld the active
        # sub-map into the candidate's map before distributing the
        # correction (reference LoopClosing::MergeLocal,
        # LoopClosing.cc:1316)
        cand_map = int(m.kf_map_id[cand_kf])
        cand_j = jnp.int32(cand_kf)
        if cand_map != int(m.active_map):
            m = ms.merge_active_into(m, cand_map, S_corr)
            self.merges = getattr(self, "merges", 0) + 1
            # residual error is distributed by the pose graph below
            # with an identity loop constraint (maps already aligned)
            m = correct_loop(m, kf_j, cand_j, sim3.identity(),
                             fix_scale=fix_scale, yaw_only=yaw_only)
        else:
            m = correct_loop(m, kf_j, cand_j, S_corr,
                             fix_scale=fix_scale, yaw_only=yaw_only)
        # fuse duplicate landmarks along the verified correspondences
        cur = jnp.where(lm.valid & inliers, lm.cur_mp, -1)
        cand = jnp.where(lm.valid & inliers, lm.cand_mp, -1)
        m = ms.replace_mappoint(m, cur, cand)
        if use_cascade:
            # welding BA over the seam (Merge*BA analog)
            m = weld_after_merge(m, kf, K, width=width, height=height,
                                 scale_factor=scale_factor,
                                 n_levels=n_levels)
        self._last_loop_kf = kf
        self._streak = 0
        self._streak_cand = -1
        self.loops_closed += 1
        return m
