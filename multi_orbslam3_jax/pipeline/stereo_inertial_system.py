"""Stereo-inertial SLAM system (IMU_STEREO).

The reference's sensor enum carries IMU_STEREO (include/Datatypes.h
eSensor) and the ORB-SLAM3 core it embeds supports it end-to-end; like
STEREO/RGBD it runs standalone (collaborative sync is gated to monocular
sensors, reference src/Communicator.cc:1675,1689).

Composition of the two existing systems via the MonoSlam hook protocol:

- StereoSlam supplies depth-seeded initialization/landmarks and the
  stereo residual row (``_frame_ur``/``_bf``/``_seed_depth_points``);
- MonoInertialSlam supplies IMU preintegration, IMU state prediction
  (``_pre_track``), per-frame visual-inertial pose optimization
  (``_refine_pose``), the staged inertial initialization and the
  temporal-window VI bundle adjustment.

Stereo-specific inertial behavior (matching the reference's IMU_STEREO
branches in Tracking/LocalMapping):

- **scale is fixed**: stereo depth already pins the metric gauge, so the
  inertial initialization estimates only gravity direction + biases
  (``fix_scale=True`` -> the map re-gauge is a pure gravity-alignment
  rotation);
- **fast initialization**: no scale observability problem means fewer
  keyframes / less integration time are required before the IMU is
  trusted (the reference initializes stereo-inertial in ~1-2 s vs the
  monocular staged 2-6 s ladder).
"""

from __future__ import annotations

import numpy as np

from multi_orbslam3_jax.config import SystemConfig
from multi_orbslam3_jax.pipeline.inertial_system import MonoInertialSlam
from multi_orbslam3_jax.pipeline.stereo_system import RGBDSlam, StereoSlam
from multi_orbslam3_jax.pipeline.system import TrackState


class StereoInertialSlam(MonoInertialSlam, StereoSlam):
    """sensor='imu_stereo': process_frame_stereo_imu(left, right, ts,
    acc, gyro, dt)."""

    def __init__(self, config: SystemConfig, agent_id: int = 0,
                 enable_loop_closing: bool = True, vocabulary=None):
        super().__init__(config, agent_id, enable_loop_closing, vocabulary)
        self._fix_scale = True
        # metric scale from depth: gravity/bias become observable fast
        self._init_kf_count = 5
        self._min_init_time = 1.0
        self._refine_time = 3.0

    # ------------------------------------------------------------------
    def process_frame_stereo_imu(self, img_left: np.ndarray,
                                 img_right: np.ndarray, timestamp: float,
                                 acc: np.ndarray, gyro: np.ndarray,
                                 dt: np.ndarray) -> TrackState:
        """acc/gyro: (S,3) IMU samples since the previous frame; dt: (S,)
        with zeros for padding (reference GrabImuData + the stereo
        GrabImageStereo entry, src/Tracking.cc:1014)."""
        self._accumulate_imu(acc, gyro, dt)
        return self.process_frame_stereo(img_left, img_right, timestamp)

    # ------------------------------------------------------------------
    def _depth_initialize(self, feats, ts) -> None:
        super()._depth_initialize(feats, ts)
        if self.state == TrackState.OK:
            # the inertial chain starts AT the first keyframe: whatever
            # was integrated before the map existed is not a KF->KF window
            self._accum = None
            self._since_prev = None
            k0 = self.ref_kf
            self.kf_preint[k0] = None
            self.kf_velocity[k0] = 0.0


class RGBDInertialSlam(StereoInertialSlam, RGBDSlam):
    """sensor='imu_rgbd': process_frame_rgbd_imu(gray, depth, ts, acc,
    gyro, dt). The reference ships an RGBDInertialNode (ros/src/
    RGBDInertialNode.cc) on the same core path; depth converts to
    virtual-right stereo and the stereo-inertial machinery applies
    unchanged."""

    def process_frame_rgbd_imu(self, img: np.ndarray, depth: np.ndarray,
                               timestamp: float, acc: np.ndarray,
                               gyro: np.ndarray,
                               dt: np.ndarray) -> TrackState:
        self._accumulate_imu(acc, gyro, dt)
        return self.process_frame_rgbd(img, depth, timestamp)
