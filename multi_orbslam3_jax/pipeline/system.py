"""Monocular SLAM system: host state machine over the jitted stages.

Replaces ClientSystem + the Tracking thread's state ladder (reference
src/ClientSystem.cc, Tracking::Track states NOT_INITIALIZED / OK /
RECENTLY_LOST / LOST, src/Tracking.cc:1527-2061) and the LocalMapping
thread (keyframes are processed synchronously after insertion — the
pipeline-parallel analog of the reference's mapping queue is round-2 work
once the collaborative scheduler lands).

Device work is all in jitted stages (extract / track / triangulate / BA);
this class only makes scalar decisions per frame.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.config import SystemConfig
from multi_orbslam3_jax.frontend import extractor, matcher
from multi_orbslam3_jax.frontend.extractor import FrameFeatures
from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.geometry import se3
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.pipeline import initializer, local_mapping, tracking


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    RECENTLY_LOST = 2
    LOST = 3


class MonoSlam:
    """Single-agent monocular SLAM (the reference client with loop closing
    disabled — exactly how its clients run, src/LocalMapping.cc:40-45)."""

    def __init__(self, config: SystemConfig, agent_id: int = 0,
                 enable_loop_closing: bool = True, vocabulary=None):
        self.cfg = config
        self.agent = agent_id
        self.K = cam.intrinsics_from_config(config.camera)
        # this agent's (rectified) pinhole row for per-KF intrinsics —
        # heterogeneous collaboration ships it with every keyframe
        self._cam4 = jnp.asarray([config.camera.fx, config.camera.fy,
                                  config.camera.cx, config.camera.cy],
                                 jnp.float32)
        self.m = ms.empty_map(config.map.max_keyframes, config.map.max_mappoints,
                              config.orb.n_features)
        # loop closing runs in standalone mode; collaborative clients turn it
        # off (the server owns place recognition — reference mbNoLP=true,
        # src/LocalMapping.cc:40-45)
        self.loop_closer = None
        self.reloc_voc = None
        self.reloc_db = None
        from multi_orbslam3_jax.bow import vocabulary as vocm
        voc = vocabulary if vocabulary is not None else \
            vocm.default_vocabulary(config.bow.branching, config.bow.levels)
        if enable_loop_closing:
            from multi_orbslam3_jax.pipeline.loop_closing import LoopCloser
            self.loop_closer = LoopCloser(
                voc, config.map.max_keyframes,
                consistency_hits=config.loop.consistency_hits,
                min_score=config.loop.min_bow_score)
        else:
            # the reference's clients keep their KeyFrameDatabase for
            # relocalization even with loop closing disabled
            # (mbNoLP=true, src/LocalMapping.cc:40-45) — without it a
            # collaborative client could never relocalize
            from multi_orbslam3_jax.bow import database as dbm
            self.reloc_voc = voc
            self.reloc_db = dbm.KeyframeDatabase.empty(
                config.map.max_keyframes, voc.n_words)
        self.state = TrackState.NOT_INITIALIZED
        # localization-only: track against a frozen map, never mutate it
        # (reference ClientSystem::ActivateLocalizationMode,
        # src/ClientSystem.cc:146-157 — LocalMapping paused, tracking
        # VO-only)
        self.localization_only = False
        self.T_cur = np.eye(4, dtype=np.float32)
        self.T_vel = np.eye(4, dtype=np.float32)
        # deferred mapping (tracking || mapping overlap, SURVEY §2.9 axis
        # 2): the per-KF mapping chain is DISPATCHED on insertion but its
        # result is adopted at a later frame once device-ready — the
        # frame loop never host-blocks on triangulation/fuse/BA (the
        # reference runs LocalMapping as a free thread; here JAX's async
        # dispatch plays that role and the host state machine polls)
        self._pending_map = None     # (future MapState, kf slot, scalars)
        # False forces synchronous mapping adoption everywhere —
        # deterministic behavior for drills/tests (async adoption timing
        # otherwise shapes which landmarks exist when)
        self.defer_mapping = True
        # pipelined frame loop (process_frame_pipelined): in-flight
        # (feats, res, ts) + the device-resident prediction chain
        self._pipe: List[tuple] = []
        # frames in flight before the host state machine consumes one.
        # Depth 1 hides the fetch behind one frame of device work; depth
        # 2 measured FASTER raw fps but the 2-frame-stale fallback
        # ladder lost ~25% of frames on the bench sequence — stability
        # wins (the reference's LocalMapping lag is ~1 KF too)
        self.pipeline_depth = 1
        self._T_cur_dev = None
        self._T_vel_dev = None
        self.frame_log: List[Tuple[float, "TrackState"]] = []
        self.ref_kf = 0
        self.frames_since_kf = 0
        self.lost_count = 0
        self.frame_id = -1
        self._init_feats: Optional[FrameFeatures] = None
        self._init_ts = 0.0
        self._rng_key = jnp.asarray(np.array([0, agent_id + 7], np.uint32))
        # timestamp gauge: dataset clocks can be epoch-scale (EuRoC is
        # ~1.4e9 s) where float32 — the on-device kf_timestamp dtype —
        # has 128 s spacing. All internal time is SEQUENCE-RELATIVE
        # float (origin = first frame); exports re-add the origin.
        self.ts_origin: Optional[float] = None
        # per-frame trajectory log: (relative timestamp, T_cw 4x4)
        self.trajectory: List[Tuple[float, np.ndarray]] = []
        self.stats = {"kf_inserted": 0, "mp_created": 0, "frames_tracked": 0,
                      "frames_lost": 0}

    # ------------------------------------------------------------------
    def _rel_ts(self, timestamp: float) -> float:
        """Sequence-relative time (origin fixed at the first frame seen).
        Double-precision on the host; small enough for float32 on device."""
        if self.ts_origin is None:
            self.ts_origin = float(timestamp)
        return float(timestamp) - self.ts_origin

    def process_frame(self, img: np.ndarray, timestamp: float) -> TrackState:
        return self._process_frame(img, self._rel_ts(timestamp))

    def to_device(self, img) -> jnp.ndarray:
        """Start the async host->device transfer of a frame (uint8 wire
        format — 1 byte/px crosses to the device instead of 4). Callers that
        know the next frame can prefetch it while the current one
        computes; process_frame accepts the returned device array."""
        if isinstance(img, jnp.ndarray):
            return img
        a = np.asarray(img)
        if a.dtype != np.uint8:
            a = np.clip(np.round(a), 0.0, 255.0).astype(np.uint8)
        return jnp.asarray(a)

    def _process_frame(self, img, timestamp: float) -> TrackState:
        img = self.to_device(img)
        self.frame_id += 1
        # dataset-change detection: a >4 s timestamp jump starts a new
        # sub-map (reference ClientNode ChangeDataset, ros/src/
        # ClientNode.cc:81-138 + Tracking.cc:1555-1587)
        if self.trajectory and timestamp - self.trajectory[-1][0] > 4.0 \
                and self.state != TrackState.NOT_INITIALIZED:
            self._create_new_map(reason="timestamp_jump")
        self._adopt_pending()
        if self.state == TrackState.NOT_INITIALIZED:
            feats = extractor.extract_features(
                jnp.asarray(img, jnp.float32), self.cfg)
            self._try_initialize(feats, timestamp)
        else:
            # fused extract+track: one compiled program per frame
            self._pre_track(timestamp)
            T_pred = (self.T_vel @ self.T_cur).astype(np.float32)
            feats, res, m_stats = tracking.extract_and_track(
                self.m, img, jnp.asarray(T_pred), self.cfg)
            self._m_stats = m_stats
            self._track_decide(feats, res, T_pred, timestamp)
            self._m_stats = None
            self._post_track(timestamp)
        self.trajectory.append((timestamp, np.asarray(self.T_cur)))
        self.frame_log.append((timestamp, self.state))
        return self.state

    # ------------------------------------------------------------------
    # Pipelined frame loop: dispatch frame i, finalize frame i-1. The
    # device->host fetch of a frame's results would otherwise
    # serialize with device compute every frame; here the fetch of frame
    # i-1's packed scalars overlaps frame i's extract+track program. The
    # prediction chain lives on device (_fused_step_chained); the host
    # state machine (KF decision, fallbacks, state ladder) runs one
    # frame behind, exactly like the reference's tracking thread
    # consuming LocalMapping output asynchronously.
    # ------------------------------------------------------------------
    def process_frame_pipelined(self, img, timestamp: float) -> TrackState:
        if self.state != TrackState.OK and not self._pipe:
            # bootstrap / relost path: synchronous until tracking is OK
            st = self.process_frame(img, timestamp)
            self._T_cur_dev = None
            return st
        ts = self._rel_ts(timestamp)
        img = self.to_device(img)
        self.frame_id += 1
        self._adopt_pending()
        if self._T_cur_dev is None:
            self._T_cur_dev = jnp.asarray(self.T_cur)
            self._T_vel_dev = jnp.asarray(self.T_vel)
        step = tracking._fused_step_chained(self.cfg)
        feats, res, pose_dev, tvel_dev = step(
            self.m, img, self._T_cur_dev, self._T_vel_dev)
        try:
            res.packed.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        self._pipe.append((feats, res, ts))
        self._T_cur_dev, self._T_vel_dev = pose_dev, tvel_dev
        while len(self._pipe) > self.pipeline_depth:
            self._finalize_frame(*self._pipe.pop(0))
        return self.state

    def finish(self) -> None:
        """Drain the pipelined loop (finalize all in-flight frames)."""
        while self._pipe:
            self._finalize_frame(*self._pipe.pop(0))
        self._T_cur_dev = None

    def _finalize_frame(self, feats: FrameFeatures, res, ts: float) -> None:
        arr = np.asarray(res.packed)
        T_pred = arr[18:34].reshape(4, 4).astype(np.float32)
        # found/visible statistics on the CURRENT map (the fused step's
        # m2 was computed against a map snapshot that may predate a KF
        # insert finalized since) — dispatch, no fetch
        if int(arr[16]) >= self.cfg.tracking.min_matches_refkf:
            self.m = ms.update_found_visible(self.m, res.feat_mp,
                                             res.visible)
        self._m_stats = self.m
        self._track_decide(feats, res, T_pred, ts)
        self._m_stats = None
        expected = arr[:16].reshape(4, 4)
        if self.state not in (TrackState.OK, TrackState.RECENTLY_LOST):
            # reset/new-map path: the in-flight frames tracked a dead
            # gauge — drop them and fall back to the synchronous loop
            self._pipe = []
            self._T_cur_dev = None
        elif not (np.allclose(self.T_cur, expected, atol=1e-5)
                  or np.allclose(self.T_cur, T_pred, atol=1e-5)):
            # a fallback/reloc moved the host pose off the device chain:
            # resync (uploads are cheap; only the fetch round-trip isn't)
            self._T_cur_dev = jnp.asarray(self.T_cur)
            self._T_vel_dev = jnp.asarray(self.T_vel)
        self.trajectory.append((ts, np.asarray(self.T_cur)))
        self.frame_log.append((ts, self.state))

    def _pre_track(self, ts: float) -> None:
        """Hook: update the motion model before prediction (the inertial
        subclass injects IMU state propagation here)."""

    def _post_track(self, ts: float) -> None:
        """Hook: after the tracking decision (velocity re-anchoring)."""

    def _refine_pose(self, feats: FrameFeatures, res):
        """Hook: refine the visually-optimized frame pose (the inertial
        subclass runs the visual-inertial pose optimization here)."""
        return res

    # ------------------------------------------------------------------
    def _try_initialize(self, feats: FrameFeatures, ts: float) -> None:
        if self._init_feats is None:
            self._init_feats = feats
            self._init_ts = ts
            return
        f0 = self._init_feats
        res = matcher.match_mutual(f0.desc, f0.valid, feats.desc, feats.valid,
                                   max_dist=matcher.TH_LOW, ratio=0.9,
                                   angle1=f0.angle, angle2=feats.angle)
        n_matches = int(res.count)
        if n_matches < self.cfg.tracking.init_min_matches:
            self._init_feats = feats   # restart from the newer frame
            self._init_ts = ts
            return
        idx_safe = jnp.where(res.idx >= 0, res.idx, 0)
        uv2 = feats.uv_und[idx_safe]
        init = initializer.initialize_two_view(
            self.K, f0.uv_und, uv2, res.idx >= 0, self._rng_key)
        if not bool(init.ok):
            return

        # scale gauge: median scene depth -> 1 (reference
        # CreateInitialMapMonocular, src/Tracking.cc:2257)
        pts = np.asarray(init.points)
        ok = np.asarray(init.point_ok)
        med = float(np.median(pts[ok, 2])) if ok.any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        pts_s = jnp.asarray(pts * scale)
        T1 = np.array(init.T_21)
        T1[:3, 3] *= scale

        n = self.cfg.orb.n_features
        no_assoc = jnp.full((n,), ms.NO_MP, jnp.int32)
        self.m, k0 = ms.add_keyframe(self.m, f0, jnp.eye(4), self._init_ts,
                                     no_assoc, -1, self.agent,
                                     cam4=self._cam4)
        self.m, k1 = ms.add_keyframe(self.m, feats, jnp.asarray(T1), ts,
                                     no_assoc, k0, self.agent,
                                     cam4=self._cam4)
        self.m, slots = ms.add_mappoints(
            self.m, pts_s, init.point_ok & (res.idx >= 0), f0.desc,
            k0, k0, jnp.arange(n, dtype=jnp.int32), k1, idx_safe,
            self.agent)
        # polish with a 2-KF BA (reference runs GlobalBA(20) on the init map)
        out = local_mapping.local_bundle_adjustment(
            self.m, k1, self.K, n_window=2, n_fixed=0,
            n_points=self._ba_points(), scale_factor=self.cfg.orb.scale_factor,
            iters=10)
        self.m = out.map
        if self.loop_closer is not None:
            self.m = self._loop_close(int(k0))
            self.m = self._loop_close(int(k1))
        else:
            self.add_to_reloc_db(self.m, int(k0))
            self.add_to_reloc_db(self.m, int(k1))
        self.T_cur = np.asarray(self.m.kf_pose[int(k1)])
        self.T_vel = np.eye(4, dtype=np.float32)
        self.ref_kf = int(k1)
        self.frames_since_kf = 0
        self._active_map_kfs = 2
        self.state = TrackState.OK
        self.stats["kf_inserted"] += 2
        self.stats["mp_created"] += int(jnp.sum(slots >= 0))

    # ------------------------------------------------------------------
    def _ba_points(self) -> int:
        return min(self.cfg.local_mapping.local_ba_points,
                   self.cfg.map.max_mappoints)

    def _frame_ur(self):
        """Hook: per-feature stereo right-u of the CURRENT frame (None for
        monocular systems; StereoSlam/RGBDSlam supply mvuRight)."""
        return None

    def _bf(self) -> float:
        """Hook: baseline * fx (0 disables stereo residuals)."""
        return 0.0

    def _track(self, feats: FrameFeatures, ts: float) -> None:
        """Non-fused tracking path (kept for callers that already extracted
        features)."""
        c = self.cfg
        T_pred = (self.T_vel @ self.T_cur).astype(np.float32)
        res = tracking.track_frame(
            self.m, feats, jnp.asarray(T_pred), self.K,
            width=c.camera.width, height=c.camera.height,
            scale_factor=c.orb.scale_factor, n_levels=c.orb.n_levels,
            radius_coarse=c.tracking.search_radius,
            u_r=self._frame_ur(), bf=self._bf())
        self._track_decide(feats, res, T_pred, ts)

    def _track_decide(self, feats: FrameFeatures, res, T_pred: np.ndarray,
                      ts: float) -> None:
        c = self.cfg
        # ONE device->host transfer for everything the ladder reads
        # (pose + counts): fetching n_inliers and pose separately costs
        # two host syncs per frame instead of one.
        pose_np = None
        if getattr(res, "packed", None) is not None:
            arr = np.asarray(res.packed)
            n_in = int(arr[16])
            pose_np = arr[:16].reshape(4, 4).astype(np.float32)
        else:
            n_in = int(res.n_inliers)

        if n_in < c.tracking.min_matches_localmap:
            # fallback: descriptor tracking against the reference keyframe
            res2 = tracking.track_reference_kf(
                self.m, jnp.int32(self.ref_kf), feats,
                jnp.asarray(self.T_cur), self.K,
                scale_factor=c.orb.scale_factor)
            if int(res2.n_inliers) >= c.tracking.min_matches_refkf:
                res, n_in = res2, int(res2.n_inliers)
                pose_np = None

        if n_in < c.tracking.min_matches_refkf and self.lost_count >= 2:
            # relocalization: BoW query against the keyframe database,
            # candidate-pose seeded optimization (reference
            # Tracking::Relocalization, src/Tracking.cc:3353)
            res3 = self._relocalize(feats)
            if res3 is not None:
                res, n_in = res3, int(res3.n_inliers)
                pose_np = None

        if n_in >= c.tracking.min_matches_refkf:
            # hook: the inertial subclass fuses the IMU preintegration
            # factor into the frame pose here (reference
            # PoseInertialOptimizationLastFrame, src/Optimizer.cc:7998)
            res2 = self._refine_pose(feats, res)
            if res2 is not res:
                # the hook may leave the host pose it already fetched
                # (saves a host sync re-reading res.pose)
                res = res2
                pose_np = getattr(self, "_refined_pose_np", None)
                self._refined_pose_np = None
            T_new = pose_np if pose_np is not None else np.asarray(res.pose)
            self.T_vel = (T_new @ np.linalg.inv(self.T_cur)).astype(np.float32)
            self.T_cur = T_new
            self.state = TrackState.OK
            self.lost_count = 0
            self._ok_streak = getattr(self, "_ok_streak", 0) + 1
            self.frames_since_kf += 1
            self.stats["frames_tracked"] += 1
            # the decay baseline rises during the post-KF recovery window:
            # triangulation lands new points 1-3 frames after insertion, so
            # the "what the last KF saw" reference is the best count since
            # (prevents a downward ratchet when KFs get inserted at decayed
            # inlier levels)
            if self.frames_since_kf <= 3:
                self._tracked_at_kf = max(
                    getattr(self, "_tracked_at_kf", 0), n_in)
            # landmark statistics (MapPoint::IncreaseFound/IncreaseVisible)
            # — already folded into the fused step when it ran
            m_stats = getattr(self, "_m_stats", None)
            if m_stats is not None:
                self.m = m_stats
            else:
                self.m = ms.update_found_visible(self.m, res.feat_mp,
                                                 res.visible)
            if self._need_keyframe(n_in):
                self._insert_keyframe(feats, res.feat_mp, ts)
                self._tracked_at_kf = n_in
        else:
            # RECENTLY_LOST: hold the motion model, give it a few frames
            # (reference Tracking.cc:1691-1766 ladder, minus IMU predict)
            self.lost_count += 1
            self._ok_streak = 0
            self.stats["frames_lost"] += 1
            self.T_cur = T_pred
            self.state = (TrackState.RECENTLY_LOST
                          if self.lost_count < c.tracking.relost_timeout
                          else TrackState.LOST)
            if self.state == TrackState.LOST and not self.localization_only:
                # Atlas ladder (Tracking.cc:2007-2027): a mature map is
                # kept and a fresh sub-map starts; an immature one is
                # discarded and rebuilt in place. Localization-only mode
                # never mutates the map: it keeps relocalizing instead.
                n_active = int(jnp.sum(
                    self.m.kf_valid
                    & (self.m.kf_map_id == self.m.active_map)))
                if n_active >= 10:
                    self._create_new_map(reason="lost")
                else:
                    self._reset_active_map()

    # ------------------------------------------------------------------
    def _create_new_map(self, reason: str = "") -> None:
        """Start a fresh sub-map in the Atlas (Tracking::CreateMapInAtlas,
        src/Tracking.cc:2400). Existing sub-maps stay queryable for
        relocalization / loop-driven merges."""
        self._adopt_pending(force=True)
        self._next_map_id = max(getattr(self, "_next_map_id", 0),
                                int(self.m.active_map)) + 1
        self.m = ms.switch_map(self.m, self._next_map_id)
        self.state = TrackState.NOT_INITIALIZED
        self._init_feats = None
        self.lost_count = 0
        self._active_map_kfs = 0
        self.T_vel = np.eye(4, dtype=np.float32)
        self.stats["maps_created"] = self.stats.get("maps_created", 0) + 1

    def _reset_active_map(self) -> None:
        """Discard the immature active sub-map and re-initialize in place
        (Tracking::ResetActiveMap, src/Tracking.cc:3588)."""
        self._adopt_pending(force=True)
        self.m = ms.erase_active_map(self.m)
        self.state = TrackState.NOT_INITIALIZED
        self._init_feats = None
        self.lost_count = 0
        self._active_map_kfs = 0
        self.T_vel = np.eye(4, dtype=np.float32)
        self.stats["map_resets"] = self.stats.get("map_resets", 0) + 1

    # ------------------------------------------------------------------
    def add_to_reloc_db(self, m, k: int) -> None:
        """Register keyframe k's BoW vector in whichever relocalization
        database this system runs (loop closer's shared db, or the
        standalone reloc db when loop closing is off)."""
        from multi_orbslam3_jax.bow import database as dbm
        if self.loop_closer is not None:
            self.loop_closer.db, _ = dbm.add_keyframe_bow(
                self.loop_closer.db, self.loop_closer.voc, jnp.int32(k),
                m.kf_desc[k], m.kf_feat_valid[k])
        elif self.reloc_db is not None:
            self.reloc_db, _ = dbm.add_keyframe_bow(
                self.reloc_db, self.reloc_voc, jnp.int32(k),
                m.kf_desc[k], m.kf_feat_valid[k])

    def _reloc_database(self):
        if self.loop_closer is not None:
            return self.loop_closer.db, self.loop_closer.voc
        return self.reloc_db, self.reloc_voc

    def _relocalize(self, feats: FrameFeatures):
        """Database-wide recovery: query the BoW database for the
        best-matching keyframe, solve the pose from scratch with RANSAC
        PnP (reference Tracking::Relocalization -> PnPsolver), and fall
        back to candidate-pose-seeded descriptor tracking."""
        db, voc = self._reloc_database()
        if db is None:
            return None
        import jax
        from multi_orbslam3_jax.bow import database as dbm
        scores = dbm.query(db, voc, feats.desc, feats.valid,
                           jnp.zeros(self.m.max_kf, bool))
        best = int(jnp.argmax(scores))
        if float(scores[best]) < self.cfg.loop.min_bow_score:
            return None
        self._rng_key, sub = jax.random.split(self._rng_key)
        res = tracking.relocalize_candidate(
            self.m, jnp.int32(best), feats, self.K, sub,
            scale_factor=self.cfg.orb.scale_factor)
        if int(res.n_inliers) < self.cfg.tracking.min_matches_refkf:
            # fallback: candidate-pose-seeded tracking (the reference also
            # retries with guided projection search)
            res = tracking.track_reference_kf(
                self.m, jnp.int32(best), feats,
                self.m.kf_pose[best], self.K,
                scale_factor=self.cfg.orb.scale_factor)
            if int(res.n_inliers) < self.cfg.tracking.min_matches_refkf:
                return None
        self.stats["relocalizations"] = self.stats.get(
            "relocalizations", 0) + 1
        self.ref_kf = best
        # relocalized into another sub-map: continue tracking there
        # (Atlas::ChangeMap analog; the abandoned map stays for later
        # loop-driven merging)
        cand_map = int(self.m.kf_map_id[best])
        if cand_map != int(self.m.active_map):
            self.m = ms.switch_map(self.m, cand_map)
            self.stats["map_switches"] = self.stats.get(
                "map_switches", 0) + 1
        return res

    # ------------------------------------------------------------------
    def activate_localization_mode(self, checkpoint_path: str = None) -> None:
        """Switch to localization-only tracking (reference
        ActivateLocalizationMode): optionally load a frozen map from a
        checkpoint, rebuild the relocalization BoW database over its
        keyframes, and start in LOST so the first frames relocalize."""
        if checkpoint_path is not None:
            from multi_orbslam3_jax.dataio import checkpoint as ckpt
            self.m, _ = ckpt.load_map(checkpoint_path)
        self.localization_only = True
        # rebuild the reloc database from the (loaded) map
        n = int(self.m.n_kf)
        valid = np.asarray(self.m.kf_valid[:n])
        for k in range(n):
            if valid[k]:
                self.add_to_reloc_db(self.m, k)
        self.state = TrackState.LOST
        self.lost_count = 10**6      # relocalize immediately
        self._init_feats = None

    def deactivate_localization_mode(self) -> None:
        self.localization_only = False

    def _need_keyframe(self, n_inliers: int) -> bool:
        """Keyframe decision (reference Tracking::NeedNewKeyFrame,
        src/Tracking.cc:2813-2950): insert when tracking strength decays
        below a fraction of what the last keyframe saw (the reference's
        mnMatchesInliers < thRefRatio * nRefMatches test) or the maximum
        interval elapses. Comparing against the inlier count AT the last
        insertion (not the reference KF's total association count) keeps
        the cadence at the reference's 1-5 Hz instead of every frame."""
        c = self.cfg.tracking
        if self.localization_only:
            return False
        # post-loss cooldown: a frame that just "recovered" may have
        # converged onto a wrong pose (reloc false positive, lucky
        # matches) — a keyframe minted from it poisons the map AND the
        # collaborative arena permanently. Require a short stable-OK
        # streak first (reference NeedNewKeyFrame requires OK state and
        # its reloc path waits mnFramesToResetIMU, Tracking.cc:2813+).
        if getattr(self, "_ok_streak", 0) < 2:
            return False
        if self.frames_since_kf < max(1, c.kf_min_interval):
            return False
        if self.frames_since_kf >= c.kf_max_interval:
            # the interval branch still requires decent tracking — the
            # reference's NeedNewKeyFrame gates EVERY branch on
            # mnMatchesInliers > 15 (src/Tracking.cc:2813-2950); a
            # max-interval keyframe minted from a barely-OK frame
            # enshrines a drifting pose in the map (and, collaboratively,
            # in the server arena)
            return n_inliers > 15
        baseline = getattr(self, "_tracked_at_kf", 0) or n_inliers
        return n_inliers < c.kf_tracked_ratio * baseline and n_inliers > 15

    def _insert_keyframe(self, feats: FrameFeatures, feat_mp: jnp.ndarray,
                         ts: float) -> None:
        m, k_new = ms.add_keyframe(self.m, feats, jnp.asarray(self.T_cur), ts,
                                   feat_mp, self.ref_kf, self.agent,
                                   u_r=self._frame_ur(), cam4=self._cam4)
        k = int(k_new)
        if k < 0:   # capacity reached
            return
        self.m = m
        self._seed_depth_points(k, feats)
        # an IMMATURE active map must adopt its mapping results
        # synchronously: deferred adoption is timing-dependent (device
        # readiness), and a young map whose triangulations lag a few
        # frames starves tracking of landmarks and collapses into a
        # reset loop. Mature maps keep the fully-async overlap.
        self._active_map_kfs = getattr(self, "_active_map_kfs", 0) + 1
        self._dispatch_mapping(k, defer=self.defer_mapping
                       and self._active_map_kfs > 10)
        self.T_cur = np.asarray(self.T_cur)
        self.ref_kf = k
        self.frames_since_kf = 0
        self.stats["kf_inserted"] += 1

    def _seed_depth_points(self, k: int, feats: FrameFeatures) -> None:
        """Hook: stereo/RGBD systems create depth-seeded landmarks for the
        new keyframe here, BEFORE the mapping chain is dispatched."""

    def _dispatch_mapping(self, k: int, defer: bool = True) -> None:
        """Launch the per-KF mapping chain — fused triangulate/fuse/stat
        stage (reference CreateNewMapPoints + SearchInNeighbors,
        src/LocalMapping.cc:520,868) followed by the windowed BA
        (Optimizer.cc:1810) — as ASYNC device work. Tracking keeps using
        the map WITH the new keyframe but without its new landmarks until
        the result is device-ready (the reference's tracking likewise
        consumes LocalMapping output whenever its thread finishes)."""
        if self._pending_map is not None:
            self._adopt_pending(force=True)
        lm = self.cfg.local_mapping
        n_window = min(lm.local_ba_kfs, self.cfg.map.max_keyframes // 2)
        n_fixed = min(lm.local_ba_fixed_kfs,
                      self.cfg.map.max_keyframes - n_window)
        out = local_mapping.map_keyframe(
            self.m, jnp.int32(k), self.K,
            n_neighbors=self.cfg.local_mapping.triangulation_neighbors,
            width=self.cfg.camera.width, height=self.cfg.camera.height,
            scale_factor=self.cfg.orb.scale_factor,
            n_levels=self.cfg.orb.n_levels, n_window=n_window,
            n_fixed=n_fixed, n_points=self._ba_points(),
            iters=lm.local_ba_iters,
            covis_threshold=self.cfg.map.covis_threshold,
            bf=self._bf())
        self._pending_map = (out.map, k, out.n_created, out.n_fused)
        if not defer:
            self._adopt_pending(force=True)

    def _adopt_pending(self, force: bool = False) -> None:
        """Swap in the finished mapping result (+ run loop closing on the
        mapped keyframe). force=True blocks; otherwise adopt only when
        the device is done so the frame loop never stalls."""
        if self._pending_map is None:
            return
        m_new, k, n_created, n_fused = self._pending_map
        if not force and not m_new.kf_pose.is_ready():
            return
        self._pending_map = None
        self.m = m_new
        self.stats["mp_created"] += int(n_created)
        self.stats["mp_fused"] = self.stats.get("mp_fused", 0) + \
            int(n_fused)
        if self.loop_closer is not None:
            prev_loops = self.loop_closer.loops_closed
            before = np.asarray(self.m.kf_pose[k])
            self.m = self._loop_close(k)
            if self.loop_closer.loops_closed > prev_loops:
                # a correction/merge moved the map under the live
                # tracker: re-gauge T_cur through the corrected KF
                # (T_cur' = T_cur o T_k^-1 o T_k') — without this,
                # tracking keeps predicting in the dead gauge and
                # rebuilds a parallel offset copy of known terrain
                after = np.asarray(self.m.kf_pose[k])
                T_rel = self.T_cur @ np.linalg.inv(before)
                self.T_cur = (T_rel @ after).astype(np.float32)
                self._T_cur_dev = None      # resync the device chain
        else:
            self.add_to_reloc_db(self.m, k)

    # ------------------------------------------------------------------
    def _yaw_only(self) -> bool:
        """Hook: 4-DoF (yaw+translation) essential-graph corrections for
        gravity-aligned maps (inertial systems override once the IMU is
        initialized — reference OptimizeEssentialGraph4DoF selection,
        LoopClosing.cc:1264-1273)."""
        return False

    def _loop_close(self, k: int):
        """Run the loop-closing verification cascade on keyframe k with
        full camera context (N-best candidates, reprojection Sim3, guided
        projection, welding BA)."""
        c = self.cfg
        return self.loop_closer.on_keyframe(
            self.m, k, fix_scale=self._bf() > 0.0 or self._yaw_only(),
            yaw_only=self._yaw_only(), K=self.K,
            width=c.camera.width, height=c.camera.height,
            scale_factor=c.orb.scale_factor, n_levels=c.orb.n_levels,
            min_proj_matches=c.loop.min_proj_matches,
            active_map_kfs=getattr(self, "_active_map_kfs", None))

    # ------------------------------------------------------------------
    def keyframe_trajectory(self) -> List[Tuple[float, np.ndarray]]:
        """(timestamp, T_cw) per valid keyframe of the BIGGEST sub-map,
        ordered by slot id — the reference's SaveKeyFrameTrajectoryEuRoC
        semantics (it picks the biggest map, src/ServerSystem.cc:138-185)."""
        self._adopt_pending(force=True)
        out = []
        n = int(self.m.n_kf)
        valid = np.asarray(self.m.kf_valid[:n])
        map_id = np.asarray(self.m.kf_map_id[:n])
        ts = np.asarray(self.m.kf_timestamp[:n])
        poses = np.asarray(self.m.kf_pose[:n])
        if valid.any():
            ids, counts = np.unique(map_id[valid], return_counts=True)
            biggest = int(ids[np.argmax(counts)])
        else:
            biggest = 0
        origin = self.ts_origin or 0.0
        for i in range(n):
            if valid[i] and map_id[i] == biggest:
                out.append((float(ts[i]) + origin, poses[i]))
        return out
