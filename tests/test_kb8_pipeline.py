import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate
from multi_orbslam3_jax.pipeline.system import MonoSlam, TrackState


def kb8_config():
    """TUM-VI-style fisheye at test scale: KB8 model with the dataset's
    coefficient magnitudes (reference KannalaBrandt8.cpp + TUM_512.yaml)."""
    cam = cfg.CameraConfig(
        width=320, height=320, fx=120.0, fy=120.0, cx=160.0, cy=160.0,
        model="kb8",
        kb=(0.0034823894, 0.00071503485, -0.0020532361, 0.00020293674))
    return cfg.SystemConfig(camera=cam).replace(
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048,
                          max_obs=16384, max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024,
            local_ba_iters=8))


class TestKB8Unprojection:
    def test_roundtrip_to_ideal_pinhole(self):
        import jax.numpy as jnp
        from multi_orbslam3_jax.geometry import camera as camm
        c = kb8_config().camera
        K = camm.intrinsics_from_config(c)
        kb = jnp.asarray(c.kb)
        rng = np.random.RandomState(0)
        p = jnp.asarray(np.stack([rng.uniform(-2, 2, 50),
                                  rng.uniform(-2, 2, 50),
                                  rng.uniform(2, 6, 50)], 1), jnp.float32)
        uv_fish = camm.kb8_project(K, kb, p)
        bearing = camm.kb8_unproject(K, kb, uv_fish)
        uv_ideal = camm.project(K, bearing)
        uv_true = camm.project(K, p)
        np.testing.assert_allclose(np.asarray(uv_ideal),
                                   np.asarray(uv_true), atol=0.1)


@pytest.mark.slow
class TestKB8MonoE2E:
    def test_tracks_fisheye_sequence(self):
        """End-to-end monocular SLAM on a KB8-rendered sequence
        (reference TUM-VI 512 mode): extraction rectifies keypoints to
        the ideal pinhole, the rest of the pipeline is unchanged."""
        c = kb8_config()
        seq = synthetic.make_sequence(c, n_frames=45, n_points=500, seed=7,
                                      trajectory="forward")
        slam = MonoSlam(c, enable_loop_closing=False)
        states = [slam.process_frame(seq.images[i],
                                     float(seq.timestamps[i]))
                  for i in range(seq.images.shape[0])]
        assert slam.stats["frames_tracked"] > 25, slam.stats
        ok = [i for i, s in enumerate(states) if s == TrackState.OK]
        est = np.stack([slam.trajectory[i][1] for i in ok])
        gt = seq.T_cw[ok]
        rmse = ate.ate_rmse(ate.camera_centers(est), ate.camera_centers(gt))
        g = ate.camera_centers(gt)
        span = np.linalg.norm(g.max(0) - g.min(0))
        assert rmse < 0.12 * span, f"ATE {rmse:.3f} vs span {span:.2f}"
