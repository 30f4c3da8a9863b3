"""Collaborative client: MonoSlam + uplink/downlink communication.

Replaces the reference ClientSystem + Communicator client half
(src/Communicator.cc RunClient/PublishMapClient/ProcessKfInClient):
loop closing stays off (the server owns place recognition,
src/LocalMapping.cc:40-45), new/changed keyframes and landmarks are
drained into MapDelta envelopes under per-cycle budget bounds, and
incoming server corrections are applied only when pose-locked —
the reference's convergence rule (KeyFrame.cc:2143-2144): *server wins
after optimization, client wins for fresh odometry*.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.collab import protocol
from multi_orbslam3_jax.collab.transport import Transport
from multi_orbslam3_jax.config import SystemConfig
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.pipeline.system import MonoSlam


class CollabClient:
    def __init__(self, config: SystemConfig, agent_id: int,
                 transport: Transport, inertial: bool = False):
        self.cfg = config
        self.agent = agent_id
        self.transport = transport
        self.inertial = inertial
        if inertial:
            from multi_orbslam3_jax.pipeline.inertial_system import \
                MonoInertialSlam
            self.slam = MonoInertialSlam(config, agent_id,
                                         enable_loop_closing=False)
        else:
            self.slam = MonoSlam(config, agent_id, enable_loop_closing=False)
        self._sent_kf = 0               # slots < _sent_kf were sent in full
        self._sent_mp = 0
        self._sent_kf_pose = np.zeros((config.map.max_keyframes, 4, 4),
                                      np.float32)
        self._sent_mp_pos = np.zeros((config.map.max_mappoints, 3),
                                     np.float32)
        # foreign (other agents') entities ingested from the server
        # vicinity downlink: server slot -> local slot, plus masks that
        # keep them OUT of the uplink (they are not ours to publish)
        self._foreign_kf = {}
        self._foreign_mp = {}
        self._is_foreign_kf = np.zeros(config.map.max_keyframes, bool)
        self._is_foreign_mp = np.zeros(config.map.max_mappoints, bool)
        # reverse map (local slot -> server id) so uplinked keyframes can
        # declare which FOREIGN landmarks they observe (the reference's
        # KF.msg association triplets carry ClientIds for this)
        self._foreign_mp_rev = np.full(config.map.max_mappoints, -1,
                                       np.int32)
        # landmarks the server has locked (placed by a GBA/pose-graph
        # correction): their positions are server-owned now — uplinking
        # local refinements would be dropped server-side anyway, so the
        # outbound scan skips them (MapPoint pose-lock precedence)
        self._mp_locked_srv = np.zeros(config.map.max_mappoints, bool)
        self._seq = 0
        # cumulative server gauge applied to our frame ([s, R9, t3];
        # identity at start) + the epoch it corresponds to — see
        # protocol.MapDelta.gauge_down
        self._gauge_applied = np.concatenate([
            [1.0], np.eye(3).reshape(9), np.zeros(3)])
        self._gauge_epoch_applied = 0
        # reliability: unacked deltas are retained and resent after a few
        # cycles without a cumulative ack (the reference's open-ack lists,
        # include/Communicator.h:162-165) — tolerates dropped/reordered
        # transport payloads; the server's reorder buffer restores order
        self._outbox = {}               # seq -> (payload bytes, sent cycle)
        self._cycle = 0
        self._resend_after = 4          # cycles before a resend
        self.stats = {"deltas_sent": 0, "corrections_applied": 0,
                      "foreign_kf": 0, "foreign_mp": 0, "resends": 0}

    # ------------------------------------------------------------------
    def process_frame(self, img: np.ndarray, timestamp: float):
        state = self.slam.process_frame(img, timestamp)
        return state

    def process_frame_imu(self, img: np.ndarray, timestamp: float,
                          acc: np.ndarray, gyro: np.ndarray,
                          dt: np.ndarray):
        return self.slam.process_frame_imu(img, timestamp, acc, gyro, dt)

    # ------------------------------------------------------------------
    def comm_cycle(self) -> None:
        """One communication cycle: ingest corrections, publish deltas
        (reference Communicator::RunClient, src/Communicator.cc:164-230).

        Idle-skip: the delta build starts with a full arena snapshot
        (one device->host fetch). Between keyframe events nothing the
        uplink ships can have changed — poses/landmarks only move on KF
        insertion, mapping adoption, corrections, or gauge events — so
        idle cycles skip the build entirely (every 8th cycle runs it
        regardless, as a drift backstop). The reference's comm thread
        idles the same way: its out-buffers are simply empty."""
        self._cycle += 1
        self._ingest_corrections()
        sig = (self.slam.stats.get("kf_inserted", 0),
               self.slam.stats.get("mp_created", 0),
               self.slam.stats.get("mp_fused", 0),
               self.stats["corrections_applied"],
               self.stats.get("gauges_applied", 0),
               getattr(self.slam, "pending_gauge", None) is not None)
        dirty = sig != getattr(self, "_last_sig", None)
        if not dirty and self._cycle % 8 != 0:
            self._resend_unacked()
            return
        self._last_sig = sig
        delta = self._build_delta()
        if delta is not None:
            payload = delta.to_bytes()
            self._outbox[delta.seq] = (payload, self._cycle)
            self.transport.send_up(self.agent, payload)
            self.stats["deltas_sent"] += 1
        self._resend_unacked()

    def _resend_unacked(self) -> None:
        """Resend unacked deltas outstanding too long (open-ack lists)."""
        for seq, (payload, sent_at) in list(self._outbox.items()):
            if self._cycle - sent_at >= self._resend_after:
                self.transport.send_up(self.agent, payload)
                self._outbox[seq] = (payload, self._cycle)
                self.stats["resends"] += 1

    # ------------------------------------------------------------------
    def _build_delta(self) -> Optional[protocol.MapDelta]:
        # inertial clients publish nothing until visual-inertial init
        # stage 1 passed (the reference's GetInertialBA1 uplink gate,
        # Atlas.cc:134,155)
        if self.inertial and not getattr(self.slam, "inertial_ready", False):
            return None
        m = self.slam.m
        comm = self.cfg.comm
        # ONE batched device->host snapshot of everything this cycle
        # reads: every separate fetch is a host sync, and field-by-field
        # np.array() calls made the comm cycle sync-bound
        import jax
        snap = jax.device_get(dict(
            n_kf=m.n_kf, n_mp=m.n_mp, kf_pose=m.kf_pose,
            kf_parent=m.kf_parent, kf_timestamp=m.kf_timestamp,
            locked=m.kf_pose_locked, kf_mp=m.kf_mp,
            mp_ref_kf=m.mp_ref_kf, mp_pos=m.mp_pos, mp_desc=m.mp_desc))
        # IMU-init gauge handoff (mScale/mRgw, Map.cc:497-503): the server
        # transforms its copy of our map; refresh the sent-pose mirrors so
        # the re-gauge itself emits no per-entity updates
        gauge = getattr(self.slam, "pending_gauge", None)
        scale, R_gw = (1.0, None) if gauge is None else gauge
        if gauge is not None:
            self.slam.pending_gauge = None
            self._sent_kf_pose[:self._sent_kf] = \
                snap["kf_pose"][:self._sent_kf]
            self._sent_mp_pos[:self._sent_mp] = \
                snap["mp_pos"][:self._sent_mp]
        n_kf = int(snap["n_kf"])
        n_mp = int(snap["n_mp"])
        all_poses = snap["kf_pose"]
        kfs = kf_updates = mps = mp_updates = None

        # new OWN keyframes (foreign-ingested slots are skipped — they are
        # the server's, not ours to publish)
        own_new = [i for i in range(self._sent_kf, n_kf)
                   if not self._is_foreign_kf[i]][:comm.client_kf_bound]
        if own_new:
            ids = np.asarray(own_new, np.int64)
            poses = all_poses[ids]
            B = len(own_new)
            # per-feature payload rows: gathered ON DEVICE, one fetch
            ids_d = jnp.asarray(ids)
            rows = jax.device_get(dict(
                uv=m.kf_uv[ids_d], desc=m.kf_desc[ids_d],
                level=m.kf_level[ids_d], angle=m.kf_angle[ids_d],
                fv=m.kf_feat_valid[ids_d]))
            # reference chain: previous OWN keyframes + spanning parent
            own_all = np.nonzero(~self._is_foreign_kf[:n_kf])[0]
            pos_in_own = np.searchsorted(own_all, ids)
            pred1 = np.where(pos_in_own >= 1,
                             own_all[np.maximum(pos_in_own - 1, 0)], -1)
            pred2 = np.where(pos_in_own >= 2,
                             own_all[np.maximum(pos_in_own - 2, 0)], -1)
            parent = snap["kf_parent"][ids]
            parent = np.where((parent >= 0)
                              & ~self._is_foreign_kf[np.maximum(parent, 0)],
                              parent, -1)
            ref_ids = np.stack([pred1, pred2, parent], 1).astype(np.int32)
            T_rel = np.zeros((B, 3, 4, 4), np.float32)
            for b in range(B):
                for r in range(3):
                    rid = ref_ids[b, r]
                    if rid >= 0:
                        T_rel[b, r] = poses[b] @ np.linalg.inv(all_poses[rid])
            mp_raw = snap["kf_mp"][ids]
            # foreign associations travel under their SERVER identity
            # (reference KF.msg MP triplets carry ClientIds,
            # msg/KF.msg mvpMapPoints_ClientIds) — these cross-agent
            # observations are what lets the server's GBA align the
            # agents' arcs after a merge
            is_f = (mp_raw >= 0) & self._is_foreign_mp[np.maximum(mp_raw, 0)]
            mp_server = np.where(
                is_f, self._foreign_mp_rev[np.maximum(mp_raw, 0)],
                -1).astype(np.int32)
            mp_local = np.where(is_f, -1, mp_raw)
            # preintegration uplink (the reference ships mpImuPreintegrated
            # + velocity in every KF message, src/KeyFrame.cc
            # ConvertToMessage; the server needs them for FullInertialBA
            # and for window merging when it culls a keyframe)
            imu_rows = None
            kf_preint = getattr(self.slam, "kf_preint", None)
            if self.inertial and kf_preint is not None:
                from multi_orbslam3_jax.imu import preintegration as pre
                imu_rows = np.zeros((B, pre.FLAT_DIM + 3), np.float32)
                for b, lid in enumerate(ids):
                    p = kf_preint[int(lid)]
                    if p is not None:
                        imu_rows[b, :pre.FLAT_DIM] = pre.preint_to_flat(p)
                    imu_rows[b, pre.FLAT_DIM:] = \
                        self.slam.kf_velocity[int(lid)]
            kfs = protocol.KFPayload(
                agent=self.agent, local_id=ids.astype(np.int32),
                timestamp=snap["kf_timestamp"][ids],
                ref_ids=ref_ids, T_rel=T_rel, T_abs=poses,
                is_first=(ids == 0),
                uv=rows["uv"], desc=rows["desc"], level=rows["level"],
                angle=rows["angle"], feat_valid=rows["fv"],
                mp_local=mp_local, mp_server=mp_server, imu=imu_rows)
            self._sent_kf_pose[ids] = poses
            new_kf_hi = int(ids[-1]) + 1 \
                if len(own_new) == comm.client_kf_bound else n_kf
        else:
            new_kf_hi = n_kf

        own_mp_new = [i for i in range(self._sent_mp, n_mp)
                      if not self._is_foreign_mp[i]][:comm.client_mp_bound]
        if own_mp_new:
            ids = np.asarray(own_mp_new, np.int64)
            ref_kf = snap["mp_ref_kf"][ids]
            # a foreign reference KF has no sender-local id on the server
            ref_kf = np.where((ref_kf >= 0)
                              & ~self._is_foreign_kf[np.maximum(ref_kf, 0)],
                              ref_kf, -1)
            pos_abs = snap["mp_pos"][ids]
            ref_safe = np.maximum(ref_kf, 0)
            # position in reference-KF camera frame (relative encoding,
            # MP.msg mSendWithKF semantics)
            pos_rel = np.einsum("bij,bj->bi",
                                all_poses[ref_safe][:, :3, :3], pos_abs) \
                + all_poses[ref_safe][:, :3, 3]
            mps = protocol.MPPayload(
                agent=self.agent, local_id=ids.astype(np.int32),
                ref_kf_local=ref_kf.astype(np.int32),
                pos_rel=pos_rel.astype(np.float32), pos_abs=pos_abs,
                desc=snap["mp_desc"][ids])
            self._sent_mp_pos[ids] = pos_abs
            new_mp_hi = int(ids[-1]) + 1 \
                if len(own_mp_new) == comm.client_mp_bound else n_mp
        else:
            new_mp_hi = n_mp

        # pose updates for already-sent KFs whose pose moved (SendMe analog)
        if self._sent_kf > 0:
            cur = all_poses[:self._sent_kf]
            moved = np.abs(cur - self._sent_kf_pose[:self._sent_kf]) \
                .reshape(self._sent_kf, -1).max(axis=1) > 1e-6
            locked = snap["locked"][:self._sent_kf]
            moved = moved & ~locked     # never push back over a server lock
            if moved.any():
                ids = np.nonzero(moved)[0].astype(np.int32)
                ids = ids[:comm.client_kf_bound]
                # re-ship the CURRENT association rows: fuse keeps
                # attaching landmarks to already-sent keyframes and the
                # server's observation counts must follow (KFred.msg MP
                # triplets; without this the server culls landmarks it
                # believes under-observed)
                urows = snap["kf_mp"][ids]
                u_is_f = (urows >= 0) & \
                    self._is_foreign_mp[np.maximum(urows, 0)]
                u_server = np.where(
                    u_is_f, self._foreign_mp_rev[np.maximum(urows, 0)],
                    -1).astype(np.int32)
                urows = np.where(u_is_f, -1, urows)
                kf_updates = protocol.KFUpdatePayload(
                    agent=self.agent, local_id=ids, T_abs=cur[ids],
                    locked=np.zeros(len(ids), bool),
                    mp_local=urows.astype(np.int32),
                    mp_server=u_server)
                self._sent_kf_pose[ids] = cur[ids]
        if self._sent_mp > 0:
            curp = snap["mp_pos"][:self._sent_mp]
            movedp = np.abs(curp - self._sent_mp_pos[:self._sent_mp])\
                .max(axis=1) > 1e-6
            movedp = movedp & ~self._is_foreign_mp[:self._sent_mp] \
                & ~self._mp_locked_srv[:self._sent_mp]
            if movedp.any():
                ids = np.nonzero(movedp)[0].astype(np.int32)
                ids = ids[:comm.client_mp_bound]
                mp_updates = protocol.MPUpdatePayload(
                    agent=self.agent, local_id=ids, pos_abs=curp[ids],
                    locked=np.zeros(len(ids), bool))
                self._sent_mp_pos[ids] = curp[ids]

        self._sent_kf = new_kf_hi
        self._sent_mp = new_mp_hi
        if kfs is None and mps is None and kf_updates is None \
                and mp_updates is None and gauge is None:
            return None
        self._seq += 1
        T_bc = None
        if self.inertial and hasattr(self.slam, "T_bc"):
            T_bc = np.asarray(self.slam.T_bc, np.float32).reshape(4, 4)
        return protocol.MapDelta(
            agent=self.agent, seq=self._seq, kfs=kfs, kf_updates=kf_updates,
            mps=mps, mp_updates=mp_updates,
            closest_kf=self.slam.ref_kf, scale=scale, R_gw=R_gw,
            inertial=self.inertial, T_bc=T_bc,
            cam=np.asarray(self.slam._cam4, np.float32))

    # ------------------------------------------------------------------
    def _ingest_corrections(self) -> None:
        """Apply server downlink: only pose-locked updates
        (ProcessKfInClient, src/Communicator.cc:1324-1403). After a
        correction batch, the gauge change it implies is PROPAGATED to
        every not-yet-corrected local entity (fresh keyframes, unsent
        landmarks, the live pose/velocity) — the client-side analog of
        the reference's CorrectLoop/GBA spanning-tree propagation to
        entities created meanwhile (src/LoopClosing.cc:2619+). Without
        this, a merge that re-gauges the map splits the client's frame
        in two: old keyframes jump to the server gauge while live
        odometry keeps extending the old one."""
        payloads = getattr(self, "_deferred_down", []) + \
            self.transport.poll_down(self.agent)
        self._deferred_down = []
        # weak-tracking deferral: re-basing the whole frame exactly when
        # the tracker has few inliers (weak-texture stretch, recovery)
        # amplifies the disturbance into tracking loss — hold the batch
        # for a few cycles until an OK streak returns (bounded so a
        # persistently weak tracker still converges to the server state;
        # the reference's comm thread similarly waits on LockTracking)
        from multi_orbslam3_jax.pipeline.system import TrackState
        weak = self.slam.state != TrackState.OK or \
            getattr(self.slam, "_ok_streak", 0) < 2
        if payloads and weak:
            self._defer_count = getattr(self, "_defer_count", 0) + 1
            if self._defer_count <= 10:
                self._deferred_down = payloads
                return
        self._defer_count = 0
        if payloads:
            # corrections mutate slam.m — fold in any in-flight deferred
            # mapping result first so adoption can't clobber them
            self.slam._adopt_pending(force=True)
            self._locked_before = np.array(self.slam.m.kf_pose_locked)
            self._old_poses = np.array(self.slam.m.kf_pose)
            self._corrected_now: set = set()
            self._mp_updated_now: set = set()
        for payload in payloads:
            try:
                delta = protocol.MapDelta.from_bytes(payload)
            except ValueError:
                # corrupted downlink frame: drop; the next cycle's
                # vicinity/correction pass re-sends current state
                self.stats["dropped_frames"] = \
                    self.stats.get("dropped_frames", 0) + 1
                continue
            if delta.ack_seq >= 0:
                for seq in [s for s in self._outbox if s <= delta.ack_seq]:
                    del self._outbox[seq]
            if delta.gauge_down is not None \
                    and delta.gauge_epoch > self._gauge_epoch_applied:
                self._apply_gauge_down(delta.gauge_down)
                self._gauge_epoch_applied = delta.gauge_epoch
            m = self.slam.m
            if delta.kf_updates is not None:
                ku = delta.kf_updates
                apply = np.asarray(ku.locked, bool)
                if apply.any():
                    from multi_orbslam3_jax.utils.padding import pad_pow2
                    pids, pT = pad_pow2(ku.local_id[apply].astype(np.int32),
                                        ku.T_abs[apply].astype(np.float32))
                    ids = jnp.asarray(pids)
                    m = m._replace(
                        kf_pose=m.kf_pose.at[ids].set(jnp.asarray(pT)),
                        kf_pose_locked=m.kf_pose_locked.at[ids].set(True))
                    self.stats["corrections_applied"] += int(apply.sum())
                    self._sent_kf_pose[ku.local_id[apply]] = ku.T_abs[apply]
                    self._corrected_now.update(
                        int(i) for i in ku.local_id[apply])
            if delta.mp_updates is not None:
                mu = delta.mp_updates
                apply = np.asarray(mu.locked, bool)
                if apply.any():
                    from multi_orbslam3_jax.utils.padding import pad_pow2
                    pids, ppos = pad_pow2(
                        mu.local_id[apply].astype(np.int32),
                        mu.pos_abs[apply].astype(np.float32))
                    m = m._replace(mp_pos=m.mp_pos.at[
                        jnp.asarray(pids)].set(jnp.asarray(ppos)))
                    self._sent_mp_pos[mu.local_id[apply]] = mu.pos_abs[apply]
                    self._mp_locked_srv[mu.local_id[apply]] = True
                    self._mp_updated_now.update(
                        int(i) for i in mu.local_id[apply])
            if delta.erased_kf is not None:
                # server culled these keyframes (ProcessErasedKf flow)
                for lid in delta.erased_kf:
                    lid = int(lid)
                    if lid != self.slam.ref_kf and 0 <= lid < int(m.n_kf):
                        self._merge_preint_over(lid)
                        m = ms.erase_keyframe(m, jnp.int32(lid))
            if delta.erased_mp is not None:
                # server culled these landmarks of OURS: erase the local
                # copy too — the server never re-corrects a culled
                # landmark, so a surviving local copy would stay at the
                # old gauge after the next re-gauging correction
                slots = [int(l) for l in delta.erased_mp
                         if 0 <= int(l) < int(m.n_mp)
                         and not self._is_foreign_mp[int(l)]]
                if slots:
                    m = ms.erase_mappoints(m, jnp.asarray(slots, jnp.int32))
                    self.stats["own_mp_erased"] = \
                        self.stats.get("own_mp_erased", 0) + len(slots)
            # foreign-entity revocation: the server culled entities it
            # previously shipped here as vicinity content (reference
            # erasure flow covers all consumers, Communicator.cc:309-354)
            if delta.foreign_erased_kf is not None:
                for sid in delta.foreign_erased_kf:
                    loc = self._foreign_kf.pop(int(sid), None)
                    if loc is not None and loc != self.slam.ref_kf:
                        m = ms.erase_keyframe(m, jnp.int32(loc))
                        self._is_foreign_kf[loc] = False
                        self.stats["foreign_revoked_kf"] = \
                            self.stats.get("foreign_revoked_kf", 0) + 1
            if delta.foreign_erased_mp is not None:
                slots = []
                for sid in delta.foreign_erased_mp:
                    loc = self._foreign_mp.pop(int(sid), None)
                    if loc is not None:
                        slots.append(loc)
                        self._is_foreign_mp[loc] = False
                        self._foreign_mp_rev[loc] = -1
                if slots:
                    m = ms.erase_mappoints(
                        m, jnp.asarray(slots, jnp.int32))
                    self.stats["foreign_revoked_mp"] = \
                        self.stats.get("foreign_revoked_mp", 0) + len(slots)
            m = self._apply_foreign_updates(m, delta)
            m = self._ingest_foreign(m, delta)
            self.slam.m = m
        if payloads:
            # landmark hold mask for the client's own window BA: foreign
            # copies and server-locked landmarks are authoritative — the
            # local solve adapts poses to them instead of re-bending them
            self.slam.mp_hold = self._is_foreign_mp | self._mp_locked_srv
        if payloads and self._corrected_now:
            self._propagate_correction()

    # ------------------------------------------------------------------
    def _apply_gauge_down(self, g_total: np.ndarray) -> None:
        """Apply the server's EXACT cumulative merge gauge to our whole
        frame (reference ClientHandler mg2oS_wcurmap_wclientmap,
        src/ClientHandler.h:24). The remainder X = applied^-1 o total is
        applied to every own entity, the live pose/velocity, and the
        bookkeeping mirrors: poses T' = T o X, landmarks p' = X^-1(p).
        Exact per-entity corrections in the same batch then overwrite
        with the server's refined values."""
        ga = self._gauge_applied
        sa, Ra, ta = float(ga[0]), ga[1:10].reshape(3, 3), ga[10:13]
        st_, Rt, tt = float(g_total[0]), \
            np.asarray(g_total[1:10]).reshape(3, 3), \
            np.asarray(g_total[10:13])
        # X = inv(applied) o total
        s = st_ / sa
        R = Ra.T @ Rt
        t = (Ra.T @ (tt - ta)) / sa
        if abs(s - 1.0) < 1e-12 and np.allclose(R, np.eye(3), atol=1e-12) \
                and np.allclose(t, 0.0, atol=1e-12):
            self._gauge_applied = np.asarray(g_total, np.float64)
            return
        m = self.slam.m
        n_kf, n_mp = int(m.n_kf), int(m.n_mp)
        own_kf = np.zeros(m.kf_pose.shape[0], bool)
        own_kf[:n_kf] = np.array(m.kf_valid[:n_kf])
        own_kf &= ~self._is_foreign_kf
        own_mp = np.zeros(m.mp_pos.shape[0], bool)
        own_mp[:n_mp] = np.array(m.mp_valid[:n_mp])
        own_mp &= ~self._is_foreign_mp

        R32, t32 = R.astype(np.float32), t.astype(np.float32)
        s32 = np.float32(s)

        def xf_poses(P):    # T' = T o X  (Sim3 compose, scale folded)
            Rc = P[..., :3, :3]
            tc = P[..., :3, 3]
            Rn = Rc @ R32
            tn = (np.einsum("...ij,j->...i", Rc, t32) + tc) / s32
            out = P.copy()
            out[..., :3, :3] = Rn
            out[..., :3, 3] = tn
            return out

        def xf_points(p):   # p' = X^-1(p) = (1/s) R^T (p - t)
            return ((p - t32) @ R32) / s32

        poses = np.array(m.kf_pose)
        poses[own_kf] = xf_poses(poses[own_kf])
        mp = np.array(m.mp_pos)
        mp[own_mp] = xf_points(mp[own_mp])
        # scale-invariance bands follow the world scale
        upd = {"kf_pose": jnp.asarray(poses), "mp_pos": jnp.asarray(mp)}
        if hasattr(m, "mp_min_dist"):
            mn = np.array(m.mp_min_dist)
            mx = np.array(m.mp_max_dist)
            mn[own_mp] = mn[own_mp] / s32
            mx[own_mp] = mx[own_mp] / s32
            upd["mp_min_dist"] = jnp.asarray(mn)
            upd["mp_max_dist"] = jnp.asarray(mx)
        if hasattr(m, "mp_normal"):
            nrm = np.array(m.mp_normal)
            nrm[own_mp] = nrm[own_mp] @ R32     # n' = R^T n
            upd["mp_normal"] = jnp.asarray(nrm)
        self.slam.m = m._replace(**upd)
        # live pose chain: right-multiplication leaves T_vel invariant
        self.slam.T_cur = xf_poses(np.asarray(self.slam.T_cur)[None])[0] \
            .astype(np.float32)
        if getattr(self.slam, "_last_ok_T", None) is not None:
            self.slam._last_ok_T = xf_poses(
                np.asarray(self.slam._last_ok_T)[None])[0].astype(np.float32)
        self.slam._T_cur_dev = None
        if hasattr(self.slam, "v_cur"):
            A = (R32.T / s32)
            self.slam.v_cur = (A @ self.slam.v_cur).astype(np.float32)
            self.slam.kf_velocity[:n_kf] = self.slam.kf_velocity[:n_kf] @ A.T
            self.slam._prev_state = None
            self.slam._v_fresh = True
        # bookkeeping mirrors follow (the server's copies moved the same
        # way, so no spurious kf/mp updates are uplinked next cycle)
        sent_kf = np.zeros_like(own_kf)
        sent_kf[:self._sent_kf] = own_kf[:self._sent_kf]
        self._sent_kf_pose[sent_kf] = xf_poses(self._sent_kf_pose[sent_kf])
        sent_mp = np.zeros_like(own_mp)
        sent_mp[:self._sent_mp] = own_mp[:self._sent_mp]
        self._sent_mp_pos[sent_mp] = xf_points(self._sent_mp_pos[sent_mp])
        # the pre-batch snapshot feeds _propagate_correction: transform it
        # too so the Umeyama fit sees only the server's residual refinement
        if getattr(self, "_old_poses", None) is not None:
            self._old_poses[own_kf] = xf_poses(self._old_poses[own_kf])
        self._gauge_applied = np.asarray(g_total, np.float64)
        self.stats["gauges_applied"] = \
            self.stats.get("gauges_applied", 0) + 1

    # ------------------------------------------------------------------
    def _propagate_correction(self) -> None:
        """Propagate this batch of exact server corrections to everything
        the server did NOT correct, by RELATIVE chaining through each
        entity's nearest corrected keyframe — the reference's
        spanning-tree propagation of GBA/loop results to entities created
        meanwhile (mTcwBefGBA bookkeeping, src/LoopClosing.cc:2731-2790):
        T_k' = T_k o T_anchor^-1 o T_anchor', landmarks ride their
        reference keyframe (p' = T_ref'^-1 T_ref p). Global-similarity
        gauge changes (merge scale, GBA arc rescale) arrive EXACTLY on
        the gauge channel before this runs (_apply_gauge_down), so the
        residual handled here is locally rigid; a global similarity fit
        over all corrected poses (the round-4 design) misplaced the tail
        whenever the residual varied along the trajectory."""
        corr = np.asarray(sorted(self._corrected_now), np.int64)
        poses_new = np.array(self.slam.m.kf_pose)
        old_T = self._old_poses[corr]
        new_T = poses_new[corr]
        if np.allclose(old_T, new_T, atol=1e-7):
            return                          # refinement-free ack cycle
        m = self.slam.m
        n_kf = int(m.n_kf)
        n_mp = int(m.n_mp)
        # keyframes to move: own, valid, not locked before, not corrected
        move_kf = np.zeros(m.kf_pose.shape[0], bool)
        move_kf[:n_kf] = np.array(m.kf_valid[:n_kf])
        move_kf &= ~self._locked_before
        move_kf[corr] = False
        move_kf &= ~self._is_foreign_kf
        # per-KF old->new pose pairs: corrected slots take the exact
        # server values; moved slots chain through the nearest corrected
        poses_old = self._old_poses
        inv_old_corr = {int(k): np.linalg.inv(poses_old[int(k)])
                        for k in corr}

        def nearest_anchor(k: int) -> int:
            i = np.searchsorted(corr, k)
            below = corr[i - 1] if i > 0 else None
            above = corr[i] if i < len(corr) else None
            if below is None:
                return int(above)
            if above is None:
                return int(below)
            return int(below if k - below <= above - k else above)

        moved_idx = np.nonzero(move_kf)[0]
        for k in moved_idx:
            a = nearest_anchor(int(k))
            poses_new[k] = (poses_old[k] @ inv_old_corr[a]
                            @ poses_new[a]).astype(np.float32)
        # landmarks: ride the correction of their reference keyframe
        # (p' = T_ref'^-1 T_ref p — reference CorrectLoop MP update).
        # This must cover already-sent landmarks too: ones the server
        # culled or truncated under budget would otherwise stay in the
        # old frame and tear tracking after a re-gauging event.
        move_mp = np.zeros(m.mp_pos.shape[0], bool)
        move_mp[:n_mp] = np.array(m.mp_valid[:n_mp])
        move_mp[list(self._mp_updated_now)] = False
        move_mp &= ~self._is_foreign_mp
        mp = np.array(m.mp_pos)
        ref = np.array(m.mp_ref_kf)
        idx = np.nonzero(move_mp)[0]
        if len(idx):
            r = ref[idx]
            r_ok = (r >= 0) & (r < n_kf) & ~self._is_foreign_kf[
                np.clip(r, 0, len(self._is_foreign_kf) - 1)]
            idx = idx[r_ok]
            r = r[r_ok]
            if len(idx):
                A = np.einsum("kij,kjl->kil",
                              np.linalg.inv(poses_new[r]), poses_old[r])
                xh = np.concatenate([mp[idx], np.ones((len(idx), 1))], 1)
                mp[idx] = np.einsum("kij,kj->ki", A, xh)[:, :3] \
                    .astype(np.float32)
        self.slam.m = m._replace(kf_pose=jnp.asarray(poses_new),
                                 mp_pos=jnp.asarray(mp))
        # live pose chains through the newest corrected keyframe
        # (reference UpdateFrameIMU + CorrectLoop propagation,
        # src/Tracking.cc:3726); T_vel = T2 o T1^-1 is invariant under
        # a shared right-multiplication, so the motion model survives
        aN = int(corr[-1])
        chain = inv_old_corr[aN] @ poses_new[aN]

        def rebase(T_o):
            return (np.asarray(T_o) @ chain).astype(np.float32)

        self.slam.T_cur = rebase(self.slam.T_cur)
        if getattr(self.slam, "_last_ok_T", None) is not None:
            self.slam._last_ok_T = rebase(self.slam._last_ok_T)
        self.slam._T_cur_dev = None
        if hasattr(self.slam, "v_cur"):
            # world-frame velocities follow the world-change of the
            # anchor: p' = T_a'^-1 T_a p  =>  v' = R_W v
            A_w = np.linalg.inv(poses_new[aN]) @ poses_old[aN]
            R_w = A_w[:3, :3].astype(np.float32)
            self.slam.v_cur = (R_w @ self.slam.v_cur).astype(np.float32)
            self.slam.kf_velocity[:n_kf] = \
                self.slam.kf_velocity[:n_kf] @ R_w.T
            self.slam._prev_state = None
            # v_cur is ALREADY in the new gauge: block _post_track's
            # finite-difference re-anchor, whose previous pose is in the
            # OLD gauge — the difference would span the gauge jump and
            # inject a garbage velocity (the f43 2x-velocity blowup)
            self.slam._v_fresh = True

    # ------------------------------------------------------------------
    def _merge_preint_over(self, lid: int) -> None:
        """When a keyframe is culled, fold its IMU preintegration window
        into its successor's so the inertial chain stays unbroken
        (reference MergePrevious on erased-KF processing,
        src/Communicator.cc:319-341)."""
        kf_preint = getattr(self.slam, "kf_preint", None)
        if kf_preint is None or kf_preint[lid] is None:
            return
        from multi_orbslam3_jax.imu import preintegration as pre
        n = int(self.slam.m.n_kf)
        win = kf_preint[lid]
        kf_preint[lid] = None
        for succ in range(lid + 1, n):
            if self._is_foreign_kf[succ]:
                continue
            if kf_preint[succ] is not None:
                kf_preint[succ] = pre.merge_preintegrated(
                    win, kf_preint[succ])
            return
        # erased KF was the newest own keyframe: its window folds into the
        # RUNNING accumulator so the next inserted KF's window spans from
        # the previous surviving keyframe
        if self.slam._accum is not None:
            self.slam._accum = pre.merge_preintegrated(
                win, self.slam._accum)
        else:
            self.slam._accum = win

    # ------------------------------------------------------------------
    def _apply_foreign_updates(self, m, delta: protocol.MapDelta):
        """Refresh foreign entities the server corrected since shipping
        them (the reference downlink re-sends KFred/MPred for vicinity
        entities of every owner; stale foreign copies would pull live
        tracking toward the pre-correction gauge)."""
        from multi_orbslam3_jax.utils.padding import pad_pow2
        fku = delta.foreign_kf_updates
        if fku is not None:
            locs, poses = [], []
            for b, sid in enumerate(fku.server_id):
                loc = self._foreign_kf.get(int(sid))
                if loc is not None:
                    locs.append(loc)
                    poses.append(fku.T_abs[b])
            if locs:
                ids, T = pad_pow2(np.asarray(locs, np.int32),
                                  np.stack(poses).astype(np.float32))
                m = m._replace(kf_pose=m.kf_pose.at[jnp.asarray(ids)].set(
                    jnp.asarray(T)))
        fmu = delta.foreign_mp_updates
        if fmu is not None:
            locs, pos = [], []
            for b, sid in enumerate(fmu.server_id):
                loc = self._foreign_mp.get(int(sid))
                if loc is not None:
                    locs.append(loc)
                    pos.append(fmu.pos_abs[b])
            if locs:
                ids, P = pad_pow2(np.asarray(locs, np.int32),
                                  np.stack(pos).astype(np.float32))
                m = m._replace(mp_pos=m.mp_pos.at[jnp.asarray(ids)].set(
                    jnp.asarray(P)))
        return m

    # ------------------------------------------------------------------
    def _ingest_foreign(self, m, delta: protocol.MapDelta):
        """Ingest other agents' map content from the server vicinity
        downlink (reference Communicator::ProcessKfInClient /
        ProcessMpInClient for never-seen entities, src/Communicator.cc:
        1324-1477): foreign landmarks and keyframes land in the client's
        own arena (tagged with the owning agent, poses locked), so live
        tracking matches them like local landmarks and relocalization can
        query them."""
        from multi_orbslam3_jax.frontend.extractor import FrameFeatures
        fm = delta.foreign_mps
        if fm is not None:
            B = fm.server_id.shape[0]
            new = [b for b in range(B)
                   if int(fm.server_id[b]) not in self._foreign_mp]
            if new:
                idx = np.asarray(new)
                ref = np.full(len(new), self.slam.ref_kf, np.int32)
                m, slots = ms.add_mappoints_raw_padded(
                    m, jnp.asarray(fm.pos_abs[idx]),
                    jnp.ones(len(new), bool),
                    jnp.asarray(fm.desc[idx]), jnp.asarray(ref),
                    int(fm.owner[idx[0]]) if len(new) else 0)
                slots_np = np.array(slots)
                for i, b in enumerate(new):
                    s = int(slots_np[i])
                    if s >= 0:
                        self._foreign_mp[int(fm.server_id[b])] = s
                        self._is_foreign_mp[s] = True
                        self._foreign_mp_rev[s] = int(fm.server_id[b])
                        self.stats["foreign_mp"] += 1
        fk = delta.foreign_kfs
        if fk is not None:
            for b in range(fk.server_id.shape[0]):
                sid = int(fk.server_id[b])
                if sid in self._foreign_kf:
                    continue
                assoc = np.full(fk.mp_server.shape[1], ms.NO_MP, np.int32)
                for f, s in enumerate(fk.mp_server[b]):
                    if s >= 0:
                        loc = self._foreign_mp.get(int(s))
                        if loc is not None:
                            assoc[f] = loc
                feats = FrameFeatures(
                    uv=jnp.asarray(fk.uv[b]), uv_und=jnp.asarray(fk.uv[b]),
                    response=jnp.ones(fk.uv.shape[1], jnp.float32),
                    level=jnp.asarray(fk.level[b]),
                    angle=jnp.asarray(fk.angle[b]),
                    desc=jnp.asarray(fk.desc[b]),
                    valid=jnp.asarray(fk.feat_valid[b]))
                cam_b = jnp.asarray(fk.cam[b], jnp.float32) \
                    if fk.cam is not None else None
                m, k = ms.add_keyframe(
                    m, feats, jnp.asarray(fk.T_abs[b]),
                    float(fk.timestamp[b]), jnp.asarray(assoc), -1,
                    int(fk.owner[b]), cam4=cam_b)
                k_i = int(k)
                if k_i < 0:
                    continue
                # server-owned pose: locked against local refinement
                m = m._replace(
                    kf_pose_locked=m.kf_pose_locked.at[k_i].set(True))
                self._foreign_kf[sid] = k_i
                self._is_foreign_kf[k_i] = True
                self.stats["foreign_kf"] += 1
                self.slam.add_to_reloc_db(m, k_i)
        return m
