"""Stereo / RGBD SLAM systems.

Replaces the reference's STEREO / RGBD sensor modes (Tracking::
StereoInitialization src/Tracking.cc:2064, GrabImageStereo :1014,
GrabImageRGBD :1086). Per the reference these modes run STANDALONE —
collaborative sync is gated to monocular sensors
(Communicator.cc:1675,1689) — so these systems reuse the mono tracking /
mapping stack and add:

- depth-seeded initialization: the very first frame builds the map (no
  two-view bootstrap, metric scale for free);
- depth-seeded landmark creation on keyframe insertion for close points
  (the reference creates up to 100 nearest stereo points per new KF);
- triangulation still runs for far points.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.config import SystemConfig
from multi_orbslam3_jax.frontend import extractor, stereo
from multi_orbslam3_jax.frontend.extractor import FrameFeatures
from multi_orbslam3_jax.geometry import camera as cam
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.pipeline import local_mapping
from multi_orbslam3_jax.pipeline.system import MonoSlam, TrackState


class StereoSlam(MonoSlam):
    """sensor='stereo': process_frame_stereo(left, right, ts)."""

    def __init__(self, config: SystemConfig, agent_id: int = 0,
                 enable_loop_closing: bool = True, vocabulary=None):
        super().__init__(config, agent_id, enable_loop_closing, vocabulary)
        self._baseline_fx = jnp.float32(config.camera.baseline
                                        * config.camera.fx)
        self._depth_th = config.camera.depth_threshold \
            * config.camera.baseline
        self._cur_depth: Optional[stereo.StereoDepth] = None

    # ------------------------------------------------------------------
    def process_frame_stereo(self, img_left: np.ndarray,
                             img_right: np.ndarray,
                             timestamp: float) -> TrackState:
        featsL = extractor.extract_features(
            jnp.asarray(img_left, jnp.float32), self.cfg)
        featsR = extractor.extract_features(
            jnp.asarray(img_right, jnp.float32), self.cfg)
        self._cur_depth = stereo.stereo_match(featsL, featsR,
                                              self._baseline_fx)
        return self._process_with_depth(featsL, timestamp)

    # ------------------------------------------------------------------
    def process_frame_stereo_pipelined(self, img_left, img_right,
                                       timestamp: float) -> TrackState:
        """Pipelined stereo loop (see MonoSlam.process_frame_pipelined):
        dispatch this stereo frame's fused extract+match+track, finalize
        the previous frame's state machine while it computes."""
        from multi_orbslam3_jax.pipeline import tracking
        if self.state != TrackState.OK and not self._pipe:
            return self.process_frame_stereo(img_left, img_right, timestamp)
        ts = self._rel_ts(timestamp)
        il = self.to_device(img_left)
        ir = self.to_device(img_right)
        self.frame_id += 1
        self._adopt_pending()
        if self._T_cur_dev is None:
            self._T_cur_dev = jnp.asarray(self.T_cur)
            self._T_vel_dev = jnp.asarray(self.T_vel)
        step = tracking._fused_step_stereo_chained(self.cfg)
        feats, sd, res, pose_dev, tvel_dev = step(
            self.m, il, ir, self._T_cur_dev, self._T_vel_dev)
        try:
            res.packed.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        self._pipe.append((feats, res, ts, sd))
        self._T_cur_dev, self._T_vel_dev = pose_dev, tvel_dev
        while len(self._pipe) > self.pipeline_depth:
            self._finalize_frame(*self._pipe.pop(0))
        return self.state

    def _finalize_frame(self, feats, res, ts, sd=None):
        if sd is not None:
            self._cur_depth = sd     # _frame_ur/_seed_depth_points source
        super()._finalize_frame(feats, res, ts)

    # ------------------------------------------------------------------
    def _frame_ur(self):
        """Stereo right-u of the current frame — activates the third
        residual row in pose optimization and local BA (reference stereo
        edges pin metric scale continuously, Optimizer.cc stereo branch)."""
        if self._cur_depth is None:
            return None
        return self._cur_depth.u_right

    def _bf(self) -> float:
        return self._baseline_fx

    # ------------------------------------------------------------------
    def _process_with_depth(self, feats: FrameFeatures,
                            timestamp: float) -> TrackState:
        timestamp = self._rel_ts(timestamp)
        self.frame_id += 1
        self._adopt_pending()
        if self.state == TrackState.NOT_INITIALIZED:
            self._depth_initialize(feats, timestamp)
        else:
            self._pre_track(timestamp)
            self._track(feats, timestamp)
            self._post_track(timestamp)
        self.trajectory.append((timestamp, np.asarray(self.T_cur)))
        self.frame_log.append((timestamp, self.state))
        return self.state

    # ------------------------------------------------------------------
    def _depth_initialize(self, feats: FrameFeatures, ts: float) -> None:
        """StereoInitialization: first frame IS the map (Tracking.cc:2064)."""
        sd = self._cur_depth
        ok = sd.valid & feats.valid & (sd.depth > 0.1)
        if int(jnp.sum(ok)) < 50:
            return
        n = feats.n
        no = jnp.full((n,), ms.NO_MP, jnp.int32)
        self.m, k0 = ms.add_keyframe(self.m, feats, jnp.eye(4), ts, no, -1,
                                     self.agent, u_r=sd.u_right,
                                     cam4=self._cam4)
        # back-project with depth
        K = self.K
        bearing = cam.unproject(K, feats.uv_und)
        pts = bearing * sd.depth[:, None]
        idx = jnp.arange(n, dtype=jnp.int32)
        self.m, slots = ms.add_mappoints(self.m, pts, ok, feats.desc,
                                         k0, k0, idx, k0, idx, self.agent)
        if self.loop_closer is not None:
            self.m = self._loop_close(int(k0))
        self.T_cur = np.eye(4, dtype=np.float32)
        self.T_vel = np.eye(4, dtype=np.float32)
        self.ref_kf = int(k0)
        self.frames_since_kf = 0
        self.state = TrackState.OK
        self.stats["kf_inserted"] += 1
        self.stats["mp_created"] += int(jnp.sum(slots >= 0))

    # ------------------------------------------------------------------
    def _seed_depth_points(self, k: int, feats: FrameFeatures) -> None:
        """Depth-seeded close points for unmatched features (the reference
        creates the ~100 closest stereo points, Tracking.cc:2952-3081);
        runs before the async mapping chain is dispatched so the
        triangulation/BA window sees them."""
        if self._cur_depth is None:
            return
        sd = self._cur_depth
        free = self.m.kf_feat_valid[k] & (self.m.kf_mp[k] == ms.NO_MP)
        close = sd.valid & free & (sd.depth > 0.1) & \
            (sd.depth < self._depth_th)
        # no host gate on the count: an all-false mask is a harmless
        # no-op dispatch, and the extra scalar fetch would add a host
        # sync on every keyframe
        T = jnp.asarray(self.T_cur)
        bearing = cam.unproject(self.K, self.m.kf_uv[k])
        p_cam = bearing * sd.depth[:, None]
        pts_w = (p_cam - T[:3, 3][None, :]) @ T[:3, :3]  # = R^T (p_cam - t)
        idx = jnp.arange(feats.n, dtype=jnp.int32)
        self.m, slots = ms.add_mappoints(
            self.m, pts_w, close, self.m.kf_desc[k], k, k, idx, k, idx,
            self.agent)
        self.stats["mp_created"] += int(jnp.sum(slots >= 0))


class RGBDSlam(StereoSlam):
    """sensor='rgbd': process_frame_rgbd(rgb_gray, depth, ts) — depth image
    converted to virtual-right stereo (reference RGBDNode path)."""

    def process_frame_rgbd(self, img: np.ndarray, depth: np.ndarray,
                           timestamp: float) -> TrackState:
        feats = extractor.extract_features(
            jnp.asarray(img, jnp.float32), self.cfg)
        self._cur_depth = stereo.rgbd_depth(
            feats, jnp.asarray(depth, jnp.float32), self._baseline_fx)
        return self._process_with_depth(feats, timestamp)
