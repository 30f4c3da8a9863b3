"""Monocular-inertial SLAM system.

Extends MonoSlam with the reference's visual-inertial machinery
(Tracking::PreintegrateIMU/PredictStateIMU src/Tracking.cc:1231/:1363,
PoseInertialOptimizationLastFrame/LastKeyFrame src/Optimizer.cc:7998/
:7603, LocalMapping::InitializeIMU + staged VIBA1/VIBA2
src/LocalMapping.cc:1390-1585, Map::ApplyScaledRotation src/Map.cc:
438-496):

- IMU samples between frames are preintegrated (fixed-cap windows) and
  accumulated per keyframe interval;
- camera-IMU extrinsics T_bc (reference include/ImuTypes.h:71,111) are
  threaded through prediction, per-frame optimization, inertial
  initialization and the window BA — the body pose is
  T_wb = (T_bc o T_cw)^-1 everywhere;
- after enough keyframes + integration time, inertial initialization
  estimates gravity/scale/bias; the whole map is re-gauged so gravity is
  world -z and scale is metric (the ApplyScaledRotation analog), after
  which ``inertial_ready`` gates collaborative uplink exactly like the
  reference's GetInertialBA1 gate (Atlas.cc:134,155);
- tracking prediction switches from the constant-velocity model to IMU
  state propagation, and EVERY tracked frame runs the visual-inertial
  pose optimization (preintegration factor + bias random-walk prior
  fused with the reprojection residuals);
- keyframe-window BA switches to the visual-inertial solver.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.config import SystemConfig
from multi_orbslam3_jax.geometry import se3, sim3, so3
from multi_orbslam3_jax.imu import preintegration as pre
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.opt import inertial_ba, inertial_init, vi_pose_opt
from multi_orbslam3_jax.opt.local_ba import BAObservations
from multi_orbslam3_jax.pipeline.system import MonoSlam, TrackState
from multi_orbslam3_jax.pipeline.tracking import level_inv_sigma2


class MonoInertialSlam(MonoSlam):
    def __init__(self, config: SystemConfig, agent_id: int = 0,
                 enable_loop_closing: bool = True, vocabulary=None):
        super().__init__(config, agent_id, enable_loop_closing, vocabulary)
        self.calib = pre.ImuCalib.from_config(config.imu)
        self.T_bc = np.asarray(self.calib.T_bc, np.float32).reshape(4, 4)
        self.g_w = np.array([0.0, 0.0, -config.imu.gravity], np.float32)
        self.imu_initialized = False
        self.inertial_ready = False          # VIBA1 gate for uplink
        self.bg = np.zeros(3, np.float32)
        self.ba_bias = np.zeros(3, np.float32)
        self.v_cur = np.zeros(3, np.float32)
        # per-KF inertial state (host mirrors, slot-indexed)
        mk = config.map.max_keyframes
        self.kf_velocity = np.zeros((mk, 3), np.float32)
        self.kf_preint: List[Optional[pre.Preintegrated]] = [None] * mk
        self._accum: Optional[pre.Preintegrated] = None   # since last KF
        # rolling (timestamp, per-frame window) pairs for retroactive
        # KF0 -> KF1 assembly at two-view init
        self._frame_windows: List[tuple] = []
        # VI pose-opt anchoring: state at the last tracked frame + the
        # preintegration accumulated since it (survives RECENTLY_LOST gaps)
        self._prev_state = None              # (T_cw, v, bg, ba)
        self._since_prev: Optional[pre.Preintegrated] = None
        # scale observability needs integration time + excitation: wait for
        # a long-enough KF chain (the reference stages VIBA1 at ~2-3 s and
        # refines at ~6 s, src/LocalMapping.cc:272-304)
        self._init_kf_count = 8
        self._min_init_time = 2.0
        self._refine_time = 4.0              # VIBA2-analog refinement
        self._refined = False
        # stereo/RGBD-inertial subclasses fix the scale: depth already
        # pins the metric gauge, the init only estimates gravity
        # direction + biases (the reference passes bFixedVel/priorG
        # variants to InertialOptimization for IMU_STEREO)
        self._fix_scale = False

    # ------------------------------------------------------------------
    def _need_keyframe(self, n_inliers: int) -> bool:
        # pre-init cadence: the reference inserts a keyframe every
        # 0.25-0.5 s while the IMU is uninitialized (Tracking::
        # NeedNewKeyFrame inertial branch) — temporal density is what
        # makes gravity/scale observable
        if not self.imu_initialized and n_inliers > 15 and \
                self.frames_since_kf >= max(
                    1, int(round(0.2 * self.cfg.camera.fps))):
            return True
        return super()._need_keyframe(n_inliers)

    # ------------------------------------------------------------------
    def _yaw_only(self) -> bool:
        """Gravity-aligned metric map after IMU init: loop corrections run
        the 4-DoF essential graph (yaw + translation; scale pinned)."""
        return self.imu_initialized

    # ------------------------------------------------------------------
    def _T_wb(self, T_cw: np.ndarray) -> np.ndarray:
        """World-from-body pose for a camera pose: T_wb = (T_bc T_cw)^-1."""
        return np.linalg.inv(self.T_bc @ T_cw).astype(np.float32)

    def _T_cw_from_wb(self, T_wb: np.ndarray) -> np.ndarray:
        return (np.linalg.inv(self.T_bc) @
                np.linalg.inv(T_wb)).astype(np.float32)

    # ------------------------------------------------------------------
    def process_frame_imu(self, img: np.ndarray, timestamp: float,
                          acc: np.ndarray, gyro: np.ndarray,
                          dt: np.ndarray) -> TrackState:
        """acc/gyro: (S, 3) samples since the previous frame; dt: (S,)
        with zeros for padding (reference GrabImuData + PreintegrateIMU)."""
        t = self._rel_ts(timestamp)
        self._accumulate_imu(acc, gyro, dt)
        # rolling per-frame windows: the two-view bootstrap is
        # retroactive (frame pair chosen later), so KF0 -> KF1 must be
        # re-assembled from frame windows at init time. Relative time:
        # comparisons against float32 kf_timestamp must not lose sub-frame
        # precision (epoch-scale float32 spacing is 128 s).
        self._frame_windows.append((t, self._frame_window))
        if len(self._frame_windows) > 240:
            self._frame_windows.pop(0)
        return self._process_frame(img, t)

    def _accumulate_imu(self, acc: np.ndarray, gyro: np.ndarray,
                        dt: np.ndarray) -> None:
        """Preintegrate one inter-frame IMU window into the running
        accumulators (any frame entry point — mono, stereo — feeds
        through here)."""
        S_cap = self.cfg.imu.max_samples_per_frame
        acc = _pad_to(acc, S_cap)
        gyro = _pad_to(gyro, S_cap)
        dt = _pad_to(dt, S_cap)
        window = pre.preintegrate(
            jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dt),
            jnp.asarray(self.bg), jnp.asarray(self.ba_bias), self.calib)
        self._accum = window if self._accum is None else \
            pre.merge_preintegrated(self._accum, window)
        self._since_prev = window if self._since_prev is None else \
            pre.merge_preintegrated(self._since_prev, window)
        self._frame_window = window

    # ------------------------------------------------------------------
    def _pre_track(self, ts: float) -> None:
        if self.imu_initialized and self._since_prev is not None:
            # IMU prediction replaces the constant-velocity model; the
            # window spans the time since the last TRACKED frame so a
            # RECENTLY_LOST gap still propagates correctly
            T_wb = self._T_wb(self.T_cur)
            R2, v2, p2 = pre.predict_state(
                jnp.asarray(T_wb[:3, :3]), jnp.asarray(self.v_cur),
                jnp.asarray(T_wb[:3, 3]), self._since_prev,
                jnp.asarray(self.g_w), jnp.asarray(self.bg),
                jnp.asarray(self.ba_bias))
            # ONE device->host transfer for the predicted state (three
            # separate np.asarray fetches cost a host sync each)
            flat = np.asarray(jnp.concatenate(
                [R2.reshape(-1), v2, p2]))
            T_wb2 = np.eye(4, dtype=np.float32)
            T_wb2[:3, :3] = flat[:9].reshape(3, 3)
            T_wb2[:3, 3] = flat[12:15]
            T_pred = self._T_cw_from_wb(T_wb2)
            self.v_cur = flat[9:12].astype(np.float32)
            # feed the motion model with the IMU prediction
            self.T_vel = (T_pred @ np.linalg.inv(self.T_cur)).astype(
                np.float32)

    # ------------------------------------------------------------------
    def _refine_pose(self, feats, res):
        """Per-frame visual-inertial pose optimization (reference
        Optimizer::PoseInertialOptimizationLastFrame, src/Optimizer.cc:
        7998): fuse the preintegration factor from the last tracked
        frame's state with the frame's reprojection residuals."""
        if not self.imu_initialized or self._prev_state is None \
                or self._since_prev is None:
            return res
        T_prev, v_prev, bg_prev, ba_prev = self._prev_state
        feat_mp = res.feat_mp
        mp_safe = jnp.where(feat_mp >= 0, feat_mp, 0)
        out = vi_pose_opt.pose_inertial_optimization(
            res.pose, jnp.asarray(self.v_cur), jnp.asarray(bg_prev),
            jnp.asarray(ba_prev), jnp.asarray(T_prev), jnp.asarray(v_prev),
            jnp.asarray(bg_prev), jnp.asarray(ba_prev), self._since_prev,
            self.K, self.m.mp_pos[mp_safe], feats.uv_und,
            level_inv_sigma2(feats.level, self.cfg.orb.scale_factor),
            (feat_mp >= 0) & feats.valid,
            jnp.asarray(self.g_w), jnp.asarray(self.T_bc),
            gyro_walk2=float(self.calib.gyro_walk2),
            acc_walk2=float(self.calib.acc_walk2))
        # one packed transfer: pose + velocity + biases + inlier count
        flat = np.asarray(jnp.concatenate([
            out.pose.reshape(-1), out.velocity, out.bg, out.ba,
            out.n_inliers.astype(jnp.float32)[None]]))
        n_in = int(flat[25])
        pose = flat[:16].reshape(4, 4).astype(np.float32)
        if n_in < self.cfg.tracking.min_matches_refkf or \
                not np.all(np.isfinite(pose)):
            return res
        self.v_cur = flat[16:19].astype(np.float32)
        self.bg = flat[19:22].astype(np.float32)
        self.ba_bias = flat[22:25].astype(np.float32)
        self._refined_pose_np = pose     # _track_decide reuses the fetch
        from multi_orbslam3_jax.pipeline.tracking import TrackResult
        return TrackResult(
            pose=out.pose, feat_mp=jnp.where(out.inliers, feat_mp, ms.NO_MP),
            n_inliers=out.n_inliers, n_matches=res.n_matches,
            visible=res.visible)

    def _post_track(self, ts: float) -> None:
        # end-of-frame adoption: the mapping chain dispatched at this
        # frame's KF insertion overlapped the frame's remaining host
        # work (decision ladder, IMU bookkeeping); forcing here lands
        # the VI window BA in the SAME frame — a one-frame BA lag cost
        # 3x post-init accuracy (the VI pose-opt chain tightly couples
        # to BA-refreshed velocity/bias state, unlike the visual path)
        self._adopt_pending(force=True)
        if self.state == TrackState.OK:
            if self.imu_initialized and self._prev_state is None \
                    and not getattr(self, "_v_fresh", False):
                # first OK frame after a reloc/new-map event with no
                # usable velocity: re-anchor from body-position finite
                # differences. NEVER at the IMU-init frame itself — there
                # _last_ok_T is in the PRE-gauge frame (scale s apart) and
                # the difference is garbage; init/window-BA already set a
                # correct velocity (_v_fresh).
                prev_ts = getattr(self, "_last_ok_ts", None)
                prev_T = getattr(self, "_last_ok_T", None)
                if prev_ts is not None and ts > prev_ts:
                    p0 = self._T_wb(prev_T)[:3, 3]
                    p1 = self._T_wb(self.T_cur)[:3, 3]
                    self.v_cur = ((p1 - p0) / (ts - prev_ts)).astype(
                        np.float32)
            self._v_fresh = False
            # anchor the next frame's VI optimization on this state
            self._prev_state = (self.T_cur.copy(), self.v_cur.copy(),
                                self.bg.copy(), self.ba_bias.copy())
            self._since_prev = None
            self._last_ok_ts = ts
            self._last_ok_T = self.T_cur.copy()

    # ------------------------------------------------------------------
    def _try_initialize(self, feats, ts):
        super()._try_initialize(feats, ts)
        if self.state == TrackState.OK:
            # the two-view bootstrap created two keyframes outside
            # _insert_keyframe (at slots ref_kf-1, ref_kf — NOT always
            # 0,1: a new-map re-init appends). The running accumulator
            # spans since the START of the stream/last KF, but the
            # bootstrap factor must span exactly the keyframe gap —
            # rebuild it from the per-frame windows (using the stale
            # accumulator injected a wrong preintegration factor at the
            # chain root: its dT was the whole pre-init segment while
            # the poses are one KF apart)
            k1 = self.ref_kf
            k0 = int(self.m.kf_parent[k1])
            ts0 = float(self.m.kf_timestamp[k0])
            ts1 = float(self.m.kf_timestamp[k1])
            # kf_timestamp is float32 while frame labels are float64:
            # compare with a tolerance well under the frame period, or the
            # window at exactly ts0 leaks in and over-spans the factor
            eps = 1e-3
            win = None
            for t, w in self._frame_windows:
                if ts0 + eps < t <= ts1 + eps:
                    win = w if win is None else \
                        pre.merge_preintegrated(win, w)
            self.kf_preint[k1] = win
            self._accum = None

    # ------------------------------------------------------------------
    def _insert_keyframe(self, feats, feat_mp, ts):
        prev_n = int(self.m.n_kf)
        super()._insert_keyframe(feats, feat_mp, ts)
        if int(self.m.n_kf) > prev_n:       # insertion succeeded
            # adopt the mapping chain here: the VI window BA consumes
            # the mapped keyframe's new landmarks, and the per-frame VI
            # pose-opt chain couples tightly to BA-refreshed velocity/
            # bias state — an experiment deferring the BA by even one
            # frame cost 3x post-init accuracy. The mapping program
            # still overlaps the insertion-frame host work up to this
            # point (the reference's free-running LocalMapping accepts
            # the lag; our VI estimator does not).
            self._adopt_pending(force=True)
            k = int(self.m.n_kf) - 1
            self.kf_preint[k] = self._accum
            self.kf_velocity[k] = self.v_cur
            self._accum = None
            if not self.imu_initialized:
                self._maybe_initialize_imu()
            else:
                self._vi_ba_pending = k
                self._adopt_pending(force=True)

    def _adopt_pending(self, force: bool = False) -> None:
        had = self._pending_map is not None
        super()._adopt_pending(force)
        adopted = had and self._pending_map is None
        k = getattr(self, "_vi_ba_pending", None)
        if k is not None and (adopted or self._pending_map is None):
            self._vi_ba_pending = None
            if not self._refined:
                total_t = sum(float(p.dT) for p in
                              self.kf_preint[1:int(self.m.n_kf)]
                              if p is not None)
                if total_t > self._refine_time:
                    self._refined = True
                    self._maybe_initialize_imu(refine=True)
            if k >= 3:
                self._inertial_window_ba(k)

    # ------------------------------------------------------------------
    def _maybe_initialize_imu(self, refine: bool = False):
        n = int(self.m.n_kf)
        if not refine:
            if n < self._init_kf_count:
                return
        # valid OWN slots only (erasures/foreign ingest leave holes; the
        # surviving windows span between consecutive valid own KFs)
        validm = np.asarray(self.m.kf_valid[:n])
        agentm = np.asarray(self.m.kf_agent[:n])
        own = [k for k in range(n)
               if validm[k] and agentm[k] == self.agent]
        if len(own) < 2:
            return
        preints = [self.kf_preint[k] for k in own[1:]]
        if any(p is None for p in preints):
            return
        total_t = float(sum(float(p.dT) for p in preints))
        if not refine and total_t < self._min_init_time:
            return
        # body poses from camera poses through the extrinsics
        T_cw = np.array(self.m.kf_pose)[own]
        T_wb = np.stack([self._T_wb(T) for T in T_cw])
        stacked = jax.tree_util.tree_map(
            lambda *x: jnp.stack(x), *([pre.empty_preintegrated()] + preints))
        res = inertial_init.inertial_init(
            jnp.asarray(T_wb[:, :3, :3]), jnp.asarray(T_wb[:, :3, 3]),
            stacked, G=self.cfg.imu.gravity, fix_scale=self._fix_scale,
            # SLAM poses carry cm-level noise, far above IMU noise
            pose_sigma=(1e-2, 5e-2, 5e-2))
        if not bool(jnp.isfinite(res.chi2)) or float(res.chi2) > 1e3:
            return
        s = float(res.scale)
        R_wg = np.asarray(res.R_wg)
        # re-gauge the map: X_new = s * R_wg^T X_vis  (ApplyScaledRotation)
        S_corr = sim3.Sim3(R=jnp.asarray(R_wg.T),
                           t=jnp.zeros(3), s=jnp.float32(s))
        self._apply_map_gauge(S_corr)
        # velocities from the init are metric already (the residual scales
        # positions, not velocities) — the re-gauge only rotates them
        v = np.asarray(res.velocities)
        self.kf_velocity[own] = (R_wg.T @ v.T).T.astype(np.float32)
        self.v_cur = self.kf_velocity[own[-1]]
        self._v_fresh = True
        self.bg = np.asarray(res.bg)
        self.ba_bias = np.asarray(res.ba)
        self.imu_initialized = True
        self.inertial_ready = True          # VIBA1-passed gate
        self.stats["imu_init_scale"] = s
        self.stats.setdefault("imu_init_frame", self.frame_id)
        self._inertial_window_ba(n - 1)

    def _apply_map_gauge(self, S: sim3.Sim3):
        """Transform every map entity by similarity S (world re-gauge).

        The event is recorded for the collaborative uplink: the reference
        ships mScale/mRgw with the next Map msg and the server re-gauges
        its copy with ApplyScaledRotation (Map.cc:497-503,
        Communicator.cc:240-252)."""
        # a mapping chain dispatched against the PRE-gauge map must be
        # adopted (or it would overwrite the re-gauged map with old-gauge
        # state when it lands — observed as a scale-11 teleport when the
        # VI init fired with a deferred chain in flight)
        if self._pending_map is not None:
            self._adopt_pending(force=True)
        self.pending_gauge = (float(S.s), np.asarray(S.R).T.astype(np.float32))
        m = self.m
        new_mp = sim3.apply(S, m.mp_pos)
        S_cw = sim3.from_se3(m.kf_pose)
        S_new = sim3.compose(S_cw, sim3.inverse(S))
        new_pose = se3.make(S_new.R, S_new.t / S_new.s[..., None])
        self.m = m._replace(
            mp_pos=jnp.where(m.mp_valid[:, None], new_mp, m.mp_pos),
            kf_pose=jnp.where(m.kf_valid[:, None, None], new_pose,
                              m.kf_pose))
        # the LIVE pose rides the same gauge change (copying ref_kf's
        # pose instead teleported tracking when the re-gauge ran at the
        # deferred adoption point, frames after the insertion)
        S_live = sim3.compose(sim3.from_se3(jnp.asarray(self.T_cur)),
                              sim3.inverse(S))
        self.T_cur = np.asarray(
            se3.make(S_live.R, S_live.t / S_live.s)).astype(np.float32)
        self._T_cur_dev = None
        # the VI anchor state is now in the old gauge — drop it; the next
        # tracked frame re-establishes it
        self._prev_state = None

    # ------------------------------------------------------------------
    def _inertial_window_ba(self, k_last: int, window: int = 8,
                            n_anchor: int = 3):
        """Temporal-window visual-inertial BA (LocalInertialBA analog:
        sliding window over the most recent keyframes, with a pose-fixed
        anchor prefix so shared landmarks stay consistent with the
        out-of-window map — the reference's fixed-KF ring)."""
        n = int(self.m.n_kf)
        # VALID slots only: the server's culling erasures leave holes in
        # the slot range, and a merged preintegration window on a
        # survivor spans from the previous VALID keyframe — pairing it
        # against an erased slot's stale pose feeds the BA a factor
        # anchored at garbage (post-correction velocity blowup)
        valid = np.asarray(self.m.kf_valid[:n])
        agent = np.asarray(self.m.kf_agent[:n])
        own = [k for k in range(n)
               if valid[k] and k <= k_last and agent[k] == self.agent]
        slots = own[-(window + n_anchor):]
        Kw = len(slots)
        n_fixed_prefix = max(1, Kw - window)
        if Kw < 2:
            return
        ts = np.asarray(self.m.kf_timestamp[:n])
        preints = [pre.empty_preintegrated()]
        pair_valid = [False]
        for i, k in enumerate(slots[1:], start=1):
            p = self.kf_preint[k]
            gap = float(ts[k] - ts[slots[i - 1]])
            # the window must span exactly the gap to the previous VALID
            # keyframe (a mismatch means a dropped/unmerged link)
            if p is None or not (
                    abs(float(p.dT) - gap) < 0.25 * max(gap, 1e-3) + 0.01):
                preints.append(pre.empty_preintegrated())
                pair_valid.append(False)
            else:
                preints.append(p)
                pair_valid.append(True)
        stacked = jax.tree_util.tree_map(
            lambda *x: jnp.stack(x), *preints)
        m = self.m
        sl = jnp.asarray(slots, jnp.int32)
        # window landmarks
        obs_mp = m.kf_mp[sl]                       # (Kw, N)
        n_pts = self.cfg.local_mapping.local_ba_points
        uniq = jnp.unique(obs_mp, size=n_pts, fill_value=ms.NO_MP)
        pt_ok = uniq >= 0
        lut = jnp.full((m.max_mp + 1,), -1, jnp.int32)
        lut = lut.at[jnp.where(pt_ok, uniq, m.max_mp)].set(
            jnp.where(pt_ok, jnp.arange(n_pts, dtype=jnp.int32), -1))
        flat_mp = obs_mp.reshape(-1)
        local_pt = lut[jnp.where(flat_mp >= 0, flat_mp, m.max_mp)]
        N = m.kf_mp.shape[1]
        obs = BAObservations(
            kf=jnp.repeat(jnp.arange(Kw, dtype=jnp.int32), N),
            pt=jnp.where(local_pt >= 0, local_pt, 0),
            uv=m.kf_uv[sl].reshape(-1, 2),
            inv_sigma2=level_inv_sigma2(m.kf_level[sl].reshape(-1),
                                        self.cfg.orb.scale_factor),
            valid=(flat_mp >= 0) & (local_pt >= 0)
            & m.kf_feat_valid[sl].reshape(-1))
        fixed = jnp.arange(Kw) < n_fixed_prefix
        fixed = fixed | self.m.kf_pose_locked[sl]
        # hold server-owned landmarks (locked by a correction, or other
        # agents' foreign copies) at their authoritative positions: the
        # window must adapt POSES to them, not re-bend them with local
        # evidence the server's solve already consumed (the collab layer
        # maintains mp_hold; None for standalone systems)
        pf_local = None
        hold = getattr(self, "mp_hold", None)
        if hold is not None:
            pf_local = jnp.asarray(hold)[jnp.where(pt_ok, uniq, 0)] | ~pt_ok
        res = inertial_ba.inertial_bundle_adjust(
            m.kf_pose[sl], jnp.asarray(self.kf_velocity[slots]),
            jnp.tile(jnp.asarray(self.bg), (Kw, 1)),
            jnp.tile(jnp.asarray(self.ba_bias), (Kw, 1)),
            fixed, m.mp_pos[jnp.where(pt_ok, uniq, 0)], obs, stacked,
            jnp.asarray(pair_valid), self.K, jnp.asarray(self.g_w),
            jnp.asarray(self.T_bc), iters=6,
            gyro_walk2=float(self.calib.gyro_walk2),
            acc_walk2=float(self.calib.acc_walk2),
            point_fixed=pf_local)
        # single packed transfer for finiteness gate + host mirrors
        # (+ the PRE-BA pose of the window's last KF: the live-pose
        # update below must be RELATIVE — the BA may run frames after
        # the insertion, and overwriting T_cur with the refined KF pose
        # would teleport tracking backward)
        flat = np.asarray(jnp.concatenate([
            res.poses.reshape(-1), res.velocities.reshape(-1),
            res.bg[-1], res.ba[-1],
            m.kf_pose[sl[-1]].reshape(-1)]))
        n_pose = Kw * 16
        if not np.all(np.isfinite(flat[:n_pose + 3 * Kw])):
            return
        # write back
        kf_pose_ext = jnp.concatenate([m.kf_pose, jnp.zeros((1, 4, 4))], 0)
        kf_pose = kf_pose_ext.at[sl].set(res.poses)[:m.max_kf]
        mp_ext = jnp.concatenate([m.mp_pos, jnp.zeros((1, 3))], 0)
        mp_pos = mp_ext.at[jnp.where(pt_ok, uniq, m.max_mp)].set(
            res.points)[:m.max_mp]
        self.m = m._replace(kf_pose=kf_pose, mp_pos=mp_pos)
        v_old = self.kf_velocity[k_last].copy()
        self.kf_velocity[slots] = \
            flat[n_pose:n_pose + 3 * Kw].reshape(Kw, 3)
        off = n_pose + 3 * Kw
        self.bg = flat[off:off + 3].astype(np.float32)
        self.ba_bias = flat[off + 3:off + 6].astype(np.float32)
        # relative live-state update through the window's last KF
        T_k_old = flat[off + 6:off + 22].reshape(4, 4).astype(np.float32)
        T_k_new = flat[:n_pose].reshape(Kw, 4, 4)[-1].astype(np.float32)
        T_rel = self.T_cur @ np.linalg.inv(T_k_old)
        self.T_cur = (T_rel @ T_k_new).astype(np.float32)
        self.v_cur = (self.v_cur
                      + (self.kf_velocity[k_last] - v_old)).astype(
            np.float32)
        self._v_fresh = True
        self._T_cur_dev = None      # resync any pipelined device chain
        # refresh the VI anchor with the BA-refined state
        if self._prev_state is not None:
            self._prev_state = (self.T_cur.copy(), self.v_cur.copy(),
                                self.bg.copy(), self.ba_bias.copy())


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    x = np.asarray(x, np.float32)
    if x.shape[0] >= n:
        return x[:n]
    pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)
