import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate
from multi_orbslam3_jax.pipeline.inertial_system import MonoInertialSlam
from multi_orbslam3_jax.pipeline.system import TrackState


def vi_config():
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                          max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                             local_ba_points=1024,
                                             local_ba_iters=8),
    )


@pytest.mark.slow
class TestMonoInertialE2E:
    def test_tracks_and_initializes_imu(self):
        c = vi_config()
        # strong lateral sway: acceleration excitation makes VI scale
        # observable (a constant-velocity trajectory is scale-degenerate)
        seq = synthetic.make_sequence(c, n_frames=70, n_points=500, seed=7,
                                      trajectory="forward", imu=True,
                                      lateral=0.8, sway_freq=0.15)
        slam = MonoInertialSlam(c, enable_loop_closing=False)
        states = []
        for i in range(seq.images.shape[0]):
            dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / 200)
            dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)
            st = slam.process_frame_imu(
                seq.images[i], float(seq.timestamps[i]),
                seq.imu_acc[i], seq.imu_gyro[i], dt)
            states.append(st)
        assert slam.stats["frames_tracked"] > 25, slam.stats
        assert slam.state in (TrackState.OK, TrackState.RECENTLY_LOST)
        assert slam.imu_initialized, "IMU never initialized"
        assert slam.inertial_ready
        # scale estimate should be positive and sane
        s = slam.stats.get("imu_init_scale", 0.0)
        assert 0.05 < s < 50.0, f"scale {s}"
        # the frame log keeps pre-gauge poses, so evaluate the pre- and
        # post-init segments separately (each is internally consistent;
        # the re-gauge introduces a scale jump between them)
        n0 = next(i for i, st in enumerate(states) if st == TrackState.OK)
        init_f = slam.stats["imu_init_frame"]
        est = np.stack([T for _, T in slam.trajectory])
        for a, b in ((n0, init_f - 1), (init_f + 2, len(states))):
            e = ate.camera_centers(est[a:b])
            g = ate.camera_centers(seq.T_cw[a:b])
            rmse = ate.ate_rmse(e, g)
            span = np.linalg.norm(g.max(0) - g.min(0))
            assert rmse < 0.1 * span, \
                f"segment [{a}:{b}] ATE {rmse:.3f} vs span {span:.2f}"


@pytest.mark.slow
class TestMonoInertialTbc:
    def test_non_identity_extrinsics(self):
        """E2E with rotated + offset camera-IMU extrinsics (EuRoC's Tbc is
        far from identity; reference threads it everywhere,
        include/ImuTypes.h:111)."""
        from multi_orbslam3_jax.geometry import se3, so3
        import jax.numpy as jnp
        T_bc = np.asarray(se3.make(
            so3.exp(jnp.asarray([0.05, -0.1, 0.6])),
            jnp.asarray([0.08, -0.02, 0.05])))
        c = vi_config()
        c = c.replace(imu=cfg.IMUConfig(
            T_bc=tuple(float(x) for x in T_bc.reshape(-1))))
        seq = synthetic.make_sequence(c, n_frames=70, n_points=500, seed=7,
                                      trajectory="forward", imu=True,
                                      lateral=0.8, sway_freq=0.15)
        slam = MonoInertialSlam(c, enable_loop_closing=False)
        states = []
        for i in range(seq.images.shape[0]):
            dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1.0 / 200)
            dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0.0), 0.0)
            st = slam.process_frame_imu(
                seq.images[i], float(seq.timestamps[i]),
                seq.imu_acc[i], seq.imu_gyro[i], dt)
            states.append(st)
        assert slam.stats["frames_tracked"] > 25, slam.stats
        assert slam.imu_initialized, "IMU never initialized with Tbc != I"
        s = slam.stats.get("imu_init_scale", 0.0)
        assert 0.05 < s < 50.0, f"scale {s}"
        n0 = next(i for i, st in enumerate(states) if st == TrackState.OK)
        init_f = slam.stats["imu_init_frame"]
        est = np.stack([T for _, T in slam.trajectory])
        for a, b in ((n0, init_f - 1), (init_f + 2, len(states))):
            e = ate.camera_centers(est[a:b])
            g = ate.camera_centers(seq.T_cw[a:b])
            rmse = ate.ate_rmse(e, g)
            span = np.linalg.norm(g.max(0) - g.min(0))
            assert rmse < 0.1 * span, \
                f"segment [{a}:{b}] ATE {rmse:.3f} vs span {span:.2f}"
