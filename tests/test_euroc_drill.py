"""EuRoC-readiness drill (round-2 VERDICT item 9): materialize a
miniature ASL-layout dataset on disk with REAL epoch-scale nanosecond
timestamps and run the EuRoC code paths end-to-end — the loader,
bench_euroc (ATE vs the ground-truth csv), and the mono-inertial frame
sync — none of which had ever executed against on-disk data before.

Epoch timestamps (~1.4e9 s) also regression-test the float32-precision
fix (ADVICE r2): all internal time is sequence-relative."""

import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import euroc, mini_asl, synthetic


def _write_dataset(tmp_path, imu=False, n_frames=36):
    c = cfg.synthetic_mono(width=320, height=240)
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=700,
                                  seed=13, trajectory="forward", imu=imu,
                                  lateral=0.8 if imu else 0.4,
                                  sway_freq=0.15 if imu else 0.08)
    root = str(tmp_path / "MINI01")
    mini_asl.write_mini_asl(root, seq)
    return c, seq, root


def test_loader_reads_asl_tree(tmp_path):
    c, seq, root = _write_dataset(tmp_path)
    assert euroc.available(root)
    it = euroc.EurocSequence(root, max_frames=10)
    frames = list(it)
    assert len(frames) == 10
    t0, img0 = frames[0]
    assert t0 > 1.4e9                     # epoch-scale, like real EuRoC
    assert img0.shape == (240, 320)
    # pixel content survives the png round trip
    ref = np.clip(np.asarray(seq.images[0]), 0, 255)
    assert np.abs(img0 - ref).mean() < 1.0


@pytest.mark.slow
def test_bench_euroc_end_to_end(tmp_path):
    """bench_euroc (the gated EuRoC benchmark) runs against the on-disk
    tree and produces a sane ATE from the ground-truth csv."""
    from multi_orbslam3_jax.eval import benchmarks as B
    c, seq, root = _write_dataset(tmp_path, n_frames=36)

    # bench_euroc builds its own (752x480) config; point it at our config
    # geometry instead by calling the same code path with an override
    import multi_orbslam3_jax.eval.benchmarks as bm

    orig = bm._euroc_scale_config
    bm._euroc_scale_config = lambda **kw: cfg.synthetic_mono(
        width=320, height=240)
    try:
        out = B.bench_euroc(root, n_frames=36)
    finally:
        bm._euroc_scale_config = orig
    assert out is not None
    assert out["frames"] == 36
    assert "ate_rmse" in out, out
    g = np.stack([-T[:3, :3].T @ T[:3, 3] for T in seq.T_cw])
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    assert out["ate_rmse"] < 0.12 * max(span, 1.0), out


@pytest.mark.slow
def test_mono_inertial_epoch_timestamps(tmp_path):
    """The VI pipeline initializes correctly fed from an ASL tree with
    epoch nanosecond stamps — the float32 kf_timestamp quantization at
    1.4e9 s (128 s spacing) made bootstrap-window selection degenerate
    before the relative-time fix (ADVICE r2 medium)."""
    from multi_orbslam3_jax.pipeline.inertial_system import MonoInertialSlam
    # 60 frames @ 20 Hz = 2.95 s — the VI init gate needs >= 2.0 s of
    # integration time (the reference's ~2 s mono-inertial minimum,
    # src/LocalMapping.cc:1390); a 36-frame/1.75 s drill is structurally
    # too short to initialize no matter how good the data is
    c, seq, root = _write_dataset(tmp_path, imu=True, n_frames=60)
    c = c.replace(
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048,
                          max_obs=16384, max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024,
            local_ba_iters=8))
    slam = MonoInertialSlam(c, enable_loop_closing=False)
    it = euroc.EurocSequence(root, imu=True)
    n = 0
    for t, img, acc, gyro, dt in it:
        slam.process_frame_imu(img, t, acc, gyro, dt)
        n += 1
    assert n == 60
    # the bootstrap preintegration factor spans the keyframe gap (the
    # float32 failure silently attached none / a ~12 s window)
    own = [k for k in range(int(slam.m.n_kf)) if slam.kf_preint[k]]
    assert own, "no preintegration windows attached"
    dts = [float(slam.kf_preint[k].dT) for k in own]
    assert all(0.0 < d < 2.0 for d in dts), dts
    assert slam.imu_initialized, slam.stats
