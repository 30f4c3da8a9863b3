import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate
from multi_orbslam3_jax.frontend import extractor, stereo
from multi_orbslam3_jax.pipeline.stereo_system import RGBDSlam, StereoSlam
from multi_orbslam3_jax.pipeline.system import TrackState


def stereo_config():
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        sensor="stereo",
        camera=cfg.CameraConfig(width=320, height=240, fx=400.0, fy=400.0,
                                cx=160.0, cy=120.0, baseline=0.2),
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                          max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                             local_ba_points=1024,
                                             local_ba_iters=8),
    )


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(stereo_config(), n_frames=30, n_points=500,
                                   seed=9, trajectory="forward")


class TestStereoMatch:
    def test_depth_accuracy(self, seq):
        c = stereo_config()
        fL = extractor.extract_features(jnp.asarray(seq.images[0]), c)
        fR = extractor.extract_features(jnp.asarray(seq.images_right[0]), c)
        sd = stereo.stereo_match(fL, fR,
                                 jnp.float32(c.camera.baseline * c.camera.fx))
        n_matched = int(sd.valid.sum())
        assert n_matched > 40, f"only {n_matched} stereo matches"
        # compare matched depths against the rendered depth map
        uv = np.asarray(fL.uv)
        ok = np.asarray(sd.valid)
        d_est = np.asarray(sd.depth)
        d_gt = seq.depths[0][
            np.clip(np.round(uv[:, 1]).astype(int), 0, 239),
            np.clip(np.round(uv[:, 0]).astype(int), 0, 319)]
        sel = ok & (d_gt > 0.1)
        # integer keypoints without subpixel refine: ~0.5-1 px disparity
        # quantization => ~6% median depth error at these disparities
        rel = np.abs(d_est[sel] - d_gt[sel]) / d_gt[sel]
        assert np.median(rel) < 0.08, f"median depth error {np.median(rel)}"

    def test_rgbd_depth(self, seq):
        c = stereo_config()
        f = extractor.extract_features(jnp.asarray(seq.images[0]), c)
        sd = stereo.rgbd_depth(f, jnp.asarray(seq.depths[0]),
                               jnp.float32(c.camera.baseline * c.camera.fx))
        ok = np.asarray(sd.valid)
        assert ok.sum() > 50
        d = np.asarray(sd.depth)[ok]
        assert (d > 0.3).all() and (d < 30).all()


@pytest.mark.slow
class TestStereoE2E:
    def test_stereo_slam_metric_scale(self, seq):
        c = stereo_config()
        slam = StereoSlam(c, enable_loop_closing=False)
        for i in range(seq.images.shape[0]):
            slam.process_frame_stereo(seq.images[i], seq.images_right[i],
                                      float(seq.timestamps[i]))
        assert slam.state == TrackState.OK
        assert slam.stats["frames_tracked"] > 20
        est = np.stack([T for _, T in slam.trajectory])
        e = ate.camera_centers(est)
        g = ate.camera_centers(seq.T_cw)
        # metric scale: alignment WITHOUT scale must already fit
        rmse = ate.ate_rmse(e, g, with_scale=False)
        span = np.linalg.norm(g.max(0) - g.min(0))
        assert rmse < 0.08 * span, f"metric ATE {rmse:.3f} span {span:.2f}"
        # recovered scale near 1 (depth-seeded). Some drift remains because
        # BA currently carries mono reprojection residuals only — the
        # stereo u_R residual that would pin scale continuously is a known
        # round-2 item (reference EdgeStereoSE3ProjectXYZ).
        s, _, _ = ate.umeyama_align(e, g)
        assert abs(s - 1.0) < 0.35, f"scale {s}"

    def test_rgbd_slam(self, seq):
        c = stereo_config().replace(sensor="rgbd")
        slam = RGBDSlam(c, enable_loop_closing=False)
        for i in range(20):
            slam.process_frame_rgbd(seq.images[i], seq.depths[i],
                                    float(seq.timestamps[i]))
        assert slam.state == TrackState.OK
        assert slam.stats["frames_tracked"] > 12
