"""Stereo-inertial (IMU_STEREO) end-to-end: fixed-scale IMU init,
rotated/offset T_bc, tracking accuracy (reference Tracking IMU_STEREO
branches + the RGBDInertialNode path)."""

import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate
from multi_orbslam3_jax.geometry import se3, so3
from multi_orbslam3_jax.pipeline.stereo_inertial_system import \
    StereoInertialSlam
from multi_orbslam3_jax.pipeline.system import TrackState


def si_config():
    c = cfg.synthetic_mono(width=320, height=240)
    # non-trivial camera-IMU extrinsics: 25deg tilt + lever arm
    import jax.numpy as jnp
    R = np.asarray(so3.exp(jnp.asarray([0.3, -0.2, 0.25])))
    T_bc = np.eye(4, dtype=np.float64)
    T_bc[:3, :3] = R
    T_bc[:3, 3] = [0.05, -0.03, 0.02]
    return c.replace(
        sensor="imu_stereo",
        camera=cfg.CameraConfig(width=320, height=240, fx=400.0, fy=400.0,
                                cx=160.0, cy=120.0, baseline=0.2),
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        imu=cfg.IMUConfig(T_bc=tuple(float(x) for x in T_bc.reshape(-1))),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048,
                          max_obs=16384, max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024,
            local_ba_iters=8),
    )


@pytest.mark.slow
class TestStereoInertialE2E:
    def test_tracks_initializes_fixed_scale(self):
        c = si_config()
        seq = synthetic.make_sequence(c, n_frames=50, n_points=500, seed=11,
                                      trajectory="forward", imu=True,
                                      lateral=0.6, sway_freq=0.15)
        slam = StereoInertialSlam(c, enable_loop_closing=False)
        assert slam._fix_scale
        for i in range(seq.images.shape[0]):
            dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / 200)
            dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)
            slam.process_frame_stereo_imu(
                seq.images[i], seq.images_right[i],
                float(seq.timestamps[i]), seq.imu_acc[i], seq.imu_gyro[i],
                dt)
        assert slam.stats["frames_tracked"] > 30, slam.stats
        assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST)
        assert slam.imu_initialized, "IMU never initialized"
        # fixed scale: the init must NOT re-scale the metric stereo map
        assert abs(slam.stats["imu_init_scale"] - 1.0) < 1e-5
        # stereo is metric end-to-end: ATE against GT without Sim3
        # alignment of scale (SE3 alignment only)
        est = np.stack([T for _, T in slam.trajectory])
        gt = seq.T_cw[:est.shape[0]]
        e = ate.camera_centers(est)
        g = ate.camera_centers(gt)
        rmse = ate.ate_rmse(e, g, with_scale=False)
        span = np.linalg.norm(g.max(0) - g.min(0))
        assert rmse < 0.1 * max(span, 1.0), f"ATE {rmse:.3f}, span {span:.2f}"
        # velocity state sane after init
        assert np.all(np.isfinite(slam.v_cur))
        assert np.linalg.norm(slam.v_cur) < 10.0
