import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.geometry import so3
from multi_orbslam3_jax.imu import preintegration as pre


def calib():
    return pre.ImuCalib.from_config(cfg.IMUConfig())


def integrate_naive(acc, gyro, dt, bg, ba):
    """Ground-truth discrete integration (same model, plain numpy)."""
    R = np.eye(3)
    v = np.zeros(3)
    p = np.zeros(3)
    for a, w, h in zip(acc, gyro, dt):
        if h <= 0:
            continue
        a = a - ba
        w = w - bg
        p = p + v * h + 0.5 * (R @ a) * h * h
        v = v + (R @ a) * h
        R = R @ np.asarray(so3.exp(jnp.asarray(w * h)))
    return R, v, p


class TestPreintegration:
    def test_matches_naive_integration(self):
        rng = np.random.RandomState(0)
        S = 20
        acc = rng.randn(S, 3).astype(np.float32) * 0.5 + [0, 0, 9.81]
        gyro = rng.randn(S, 3).astype(np.float32) * 0.1
        dt = np.full(S, 0.005, np.float32)
        bg = np.zeros(3, np.float32)
        ba = np.zeros(3, np.float32)
        out = pre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                               jnp.asarray(dt), jnp.asarray(bg),
                               jnp.asarray(ba), calib())
        R, v, p = integrate_naive(acc, gyro, dt, bg, ba)
        np.testing.assert_allclose(np.asarray(out.dR), R, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out.dV), v, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out.dP), p, atol=1e-5)
        assert abs(float(out.dT) - 0.1) < 1e-6

    def test_padding_ignored(self):
        rng = np.random.RandomState(1)
        S = 10
        acc = rng.randn(S, 3).astype(np.float32)
        gyro = rng.randn(S, 3).astype(np.float32) * 0.2
        dt = np.full(S, 0.005, np.float32)
        dt[6:] = 0.0  # padding
        out = pre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                               jnp.asarray(dt), jnp.zeros(3), jnp.zeros(3),
                               calib())
        out2 = pre.preintegrate(jnp.asarray(acc[:6]), jnp.asarray(gyro[:6]),
                                jnp.asarray(dt[:6]), jnp.zeros(3),
                                jnp.zeros(3), calib())
        np.testing.assert_allclose(np.asarray(out.dR), np.asarray(out2.dR),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(out.dP), np.asarray(out2.dP),
                                   atol=1e-6)

    def test_bias_jacobian_first_order(self):
        rng = np.random.RandomState(2)
        S = 30
        acc = (rng.randn(S, 3) * 0.3 + [0, 0, 9.81]).astype(np.float32)
        gyro = (rng.randn(S, 3) * 0.15).astype(np.float32)
        dt = np.full(S, 0.005, np.float32)
        z = jnp.zeros(3)
        out0 = pre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                                jnp.asarray(dt), z, z, calib())
        dbg = jnp.asarray([0.01, -0.02, 0.015])
        dba = jnp.asarray([0.05, 0.03, -0.04])
        # reintegrate with the new bias
        out1 = pre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                                jnp.asarray(dt), dbg, dba, calib())
        # first-order correction from Jacobians
        dR, dV, dP = pre.bias_corrected_delta(out0, dbg, dba)
        np.testing.assert_allclose(np.asarray(dR), np.asarray(out1.dR),
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(dV), np.asarray(out1.dV),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(dP), np.asarray(out1.dP),
                                   atol=2e-4)

    def test_predict_state_free_fall(self):
        # stationary body, perfect gravity-compensating accelerometer
        S = 40
        g = 9.81
        acc = np.tile([0, 0, g], (S, 1)).astype(np.float32)  # z-up body
        gyro = np.zeros((S, 3), np.float32)
        dt = np.full(S, 0.005, np.float32)
        out = pre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                               jnp.asarray(dt), jnp.zeros(3), jnp.zeros(3),
                               calib())
        R2, v2, p2 = pre.predict_state(
            jnp.eye(3), jnp.zeros(3), jnp.zeros(3), out,
            jnp.asarray([0.0, 0.0, -g]), jnp.zeros(3), jnp.zeros(3))
        # gravity cancels: body stays put
        np.testing.assert_allclose(np.asarray(v2), 0.0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(p2), 0.0, atol=1e-4)

    def test_merge_mixed_bias_windows(self):
        """ADVICE r2: merging windows integrated at DIFFERENT biases (the
        client's bias evolves per frame after IMU init) must yield a
        window consistent with the stored (p1) bias — evaluating the
        merged factor at p2's integration bias should match composing the
        two windows each evaluated at that same bias."""
        rng = np.random.RandomState(11)
        S = 24
        acc = (rng.randn(S, 3) * 0.4 + [0, 0, 9.81]).astype(np.float32)
        gyro = (rng.randn(S, 3) * 0.1).astype(np.float32)
        dt = np.full(S, 0.005, np.float32)
        bg1 = jnp.asarray([0.002, -0.001, 0.003])
        ba1 = jnp.asarray([0.01, 0.02, -0.015])
        bg2 = bg1 + 0.004
        ba2 = ba1 - 0.03
        h1 = pre.preintegrate(jnp.asarray(acc[:12]), jnp.asarray(gyro[:12]),
                              jnp.asarray(dt[:12]), bg1, ba1, calib())
        h2 = pre.preintegrate(jnp.asarray(acc[12:]), jnp.asarray(gyro[12:]),
                              jnp.asarray(dt[12:]), bg2, ba2, calib())
        merged = pre.merge_preintegrated(h1, h2)
        assert np.allclose(np.asarray(merged.bg), np.asarray(bg1))
        # ground truth: both windows integrated directly at a query bias
        bq_g = bg1 + 0.002
        bq_a = ba1 + 0.01
        g1 = pre.preintegrate(jnp.asarray(acc[:12]), jnp.asarray(gyro[:12]),
                              jnp.asarray(dt[:12]), bq_g, bq_a, calib())
        g2 = pre.preintegrate(jnp.asarray(acc[12:]), jnp.asarray(gyro[12:]),
                              jnp.asarray(dt[12:]), bq_g, bq_a, calib())
        gold = pre.merge_preintegrated(g1, g2)
        dR, dV, dP = pre.bias_corrected_delta(merged, bq_g, bq_a)
        np.testing.assert_allclose(np.asarray(dR), np.asarray(gold.dR),
                                   atol=2e-4)
        np.testing.assert_allclose(np.asarray(dV), np.asarray(gold.dV),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(dP), np.asarray(gold.dP),
                                   atol=2e-3)

    def test_merge_matches_full_integration(self):
        rng = np.random.RandomState(3)
        S = 24
        acc = (rng.randn(S, 3) * 0.4 + [0, 0, 9.81]).astype(np.float32)
        gyro = (rng.randn(S, 3) * 0.1).astype(np.float32)
        dt = np.full(S, 0.005, np.float32)
        z = jnp.zeros(3)
        full = pre.preintegrate(jnp.asarray(acc), jnp.asarray(gyro),
                                jnp.asarray(dt), z, z, calib())
        h1 = pre.preintegrate(jnp.asarray(acc[:12]), jnp.asarray(gyro[:12]),
                              jnp.asarray(dt[:12]), z, z, calib())
        h2 = pre.preintegrate(jnp.asarray(acc[12:]), jnp.asarray(gyro[12:]),
                              jnp.asarray(dt[12:]), z, z, calib())
        merged = pre.merge_preintegrated(h1, h2)
        np.testing.assert_allclose(np.asarray(merged.dR),
                                   np.asarray(full.dR), atol=1e-5)
        np.testing.assert_allclose(np.asarray(merged.dV),
                                   np.asarray(full.dV), atol=1e-5)
        np.testing.assert_allclose(np.asarray(merged.dP),
                                   np.asarray(full.dP), atol=1e-5)
        np.testing.assert_allclose(np.asarray(merged.dT),
                                   np.asarray(full.dT), atol=1e-6)
        # jacobians should compose to ~ the full-window jacobians
        np.testing.assert_allclose(np.asarray(merged.JRg),
                                   np.asarray(full.JRg), atol=1e-3)
        np.testing.assert_allclose(np.asarray(merged.JPa),
                                   np.asarray(full.JPa), atol=1e-3)
