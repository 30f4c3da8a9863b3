import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate
from multi_orbslam3_jax.geometry import camera, se3
from multi_orbslam3_jax.pipeline import initializer
from multi_orbslam3_jax.pipeline.system import MonoSlam, TrackState

K = camera.PinholeK(*[jnp.float32(v) for v in (400.0, 400.0, 160.0, 120.0)])


def small_config():
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                          max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                             local_ba_points=1024,
                                             local_ba_iters=8),
    )


class TestInitializer:
    def test_two_view_exact(self):
        rng = np.random.RandomState(0)
        n = 200
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        rng.uniform(3, 8, n)], 1).astype(np.float32)
        T2 = se3.exp(jnp.asarray([0.02, -0.04, 0.01, 0.4, 0.05, 0.1]))
        uv1 = camera.project(K, jnp.asarray(pts))
        uv2 = camera.project(K, se3.apply(T2, jnp.asarray(pts)))
        res = initializer.initialize_two_view(
            K, uv1, uv2, jnp.ones(n, bool), jax.random.PRNGKey(0))
        assert bool(res.ok)
        # direction of translation should match (scale is free)
        t_est = np.asarray(se3.translation(res.T_21))
        t_true = np.asarray(se3.translation(T2))
        cos = np.dot(t_est, t_true) / (np.linalg.norm(t_est)
                                       * np.linalg.norm(t_true))
        assert cos > 0.999, f"translation direction cos {cos}"
        R_err = np.asarray(se3.rotation(res.T_21)).T @ np.asarray(
            se3.rotation(T2))
        assert abs(np.trace(R_err) - 3.0) < 1e-3
        # triangulated points should be proportional to ground truth
        ok = np.asarray(res.point_ok)
        assert ok.sum() > 150
        p = np.asarray(res.points)[ok]
        scale = np.median(p[:, 2] / pts[ok, 2])
        np.testing.assert_allclose(p, pts[ok] * scale, atol=0.05 * scale * 8)

    def test_rejects_pure_rotation(self):
        rng = np.random.RandomState(1)
        n = 150
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        rng.uniform(3, 8, n)], 1).astype(np.float32)
        T2 = se3.exp(jnp.asarray([0.0, 0.05, 0.01, 0.0, 0.0, 0.0]))  # no trans
        uv1 = camera.project(K, jnp.asarray(pts))
        uv2 = camera.project(K, se3.apply(T2, jnp.asarray(pts)))
        res = initializer.initialize_two_view(
            K, uv1, uv2, jnp.ones(n, bool), jax.random.PRNGKey(1))
        assert not bool(res.ok)

    def test_planar_scene_homography_path(self):
        # all landmarks on one plane: F/E is degenerate, the homography
        # model must win (reference RH > 0.4 selection) and still recover
        # the correct motion
        rng = np.random.RandomState(4)
        n = 200
        xy = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n)], 1)
        # plane z = 5 + 0.3x - 0.2y
        z = 5.0 + 0.3 * xy[:, 0] - 0.2 * xy[:, 1]
        pts = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
        T2 = se3.exp(jnp.asarray([0.02, -0.03, 0.01, 0.5, 0.1, 0.05]))
        uv1 = camera.project(K, jnp.asarray(pts))
        uv2 = camera.project(K, se3.apply(T2, jnp.asarray(pts)))
        res = initializer.initialize_two_view(
            K, uv1, uv2, jnp.ones(n, bool), jax.random.PRNGKey(4))
        assert bool(res.ok)
        t_est = np.asarray(se3.translation(res.T_21))
        t_true = np.asarray(se3.translation(T2))
        cos = np.dot(t_est, t_true) / (np.linalg.norm(t_est)
                                       * np.linalg.norm(t_true))
        assert cos > 0.99, f"translation direction cos {cos}"
        R_err = np.asarray(se3.rotation(res.T_21)).T @ np.asarray(
            se3.rotation(T2))
        assert abs(np.trace(R_err) - 3.0) < 1e-2

    def test_handles_outliers(self):
        rng = np.random.RandomState(2)
        n = 200
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        rng.uniform(3, 8, n)], 1).astype(np.float32)
        T2 = se3.exp(jnp.asarray([0.01, -0.03, 0.0, 0.5, 0.0, 0.05]))
        uv1 = camera.project(K, jnp.asarray(pts))
        uv2 = np.array(camera.project(K, se3.apply(T2, jnp.asarray(pts))))
        uv2[:40] += rng.uniform(20, 60, (40, 2))  # 20% outliers
        res = initializer.initialize_two_view(
            K, uv1, jnp.asarray(uv2), jnp.ones(n, bool), jax.random.PRNGKey(2))
        assert bool(res.ok)
        inl = np.asarray(res.inliers)
        assert inl[:40].mean() < 0.2
        assert inl[40:].mean() > 0.9


@pytest.mark.slow
class TestMonoSlamE2E:
    def test_tracks_synthetic_sequence(self):
        c = small_config()
        seq = synthetic.make_sequence(c, n_frames=40, n_points=500, seed=7,
                                      trajectory="forward")
        slam = MonoSlam(c)
        states = []
        for i in range(seq.images.shape[0]):
            st = slam.process_frame(seq.images[i], float(seq.timestamps[i]))
            states.append(st)
        assert slam.state == TrackState.OK, f"final state {slam.state}"
        assert slam.stats["kf_inserted"] >= 3
        assert slam.stats["frames_tracked"] > 25
        # ATE on per-frame trajectory vs ground truth (Sim3-aligned)
        est = np.stack([T for _, T in slam.trajectory])
        # only frames after initialization are meaningful
        n0 = next(i for i, s in enumerate(states) if s == TrackState.OK)
        est_c = ate.camera_centers(est[n0:])
        gt_c = ate.camera_centers(seq.T_cw[n0:])
        rmse = ate.ate_rmse(est_c, gt_c)
        # world scale: trajectory spans ~3 m; demand cm-level relative accuracy
        span = np.linalg.norm(gt_c.max(0) - gt_c.min(0))
        assert rmse < 0.05 * span, f"ATE {rmse:.3f} vs span {span:.2f}"


@pytest.mark.slow
class TestAtlasLadder:
    def test_timestamp_jump_creates_new_map(self):
        c = small_config()
        seq0 = synthetic.make_sequence(c, n_frames=16, n_points=500, seed=21,
                                       trajectory="forward", phase=0.0)
        seq1 = synthetic.make_sequence(c, n_frames=16, n_points=500, seed=22,
                                       trajectory="forward", phase=0.5)
        slam = MonoSlam(c, enable_loop_closing=False)
        for i in range(16):
            slam.process_frame(seq0.images[i], float(seq0.timestamps[i]))
        t_off = float(seq0.timestamps[-1]) + 10.0
        for i in range(16):
            slam.process_frame(seq1.images[i],
                               t_off + float(seq1.timestamps[i]))
        assert slam.stats.get("maps_created", 0) >= 1
        map_ids = set(np.array(slam.m.kf_map_id)[np.array(slam.m.kf_valid)])
        assert len(map_ids) >= 2, f"expected 2 sub-maps, got {map_ids}"
        # trajectory export uses one (the biggest) sub-map only
        traj = slam.keyframe_trajectory()
        assert len(traj) > 0
