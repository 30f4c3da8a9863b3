import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.geometry import camera, se3, so3
from multi_orbslam3_jax.imu import preintegration as pre
from multi_orbslam3_jax.opt import inertial_ba, inertial_init, local_ba

G = 9.81
g_w = np.array([0.0, 0.0, -G])


def calib():
    return pre.ImuCalib.from_config(cfg.IMUConfig())


def simulate(n_kf=8, samples_per_kf=10, dt=0.01, seed=0,
             bg=np.zeros(3), ba=np.zeros(3)):
    """Discrete ground-truth trajectory + exactly-consistent IMU samples
    (same Euler scheme as the preintegrator)."""
    rng = np.random.RandomState(seed)
    R = np.eye(3)
    v = np.array([0.3, 0.0, 0.1])
    p = np.zeros(3)
    kf_R, kf_p, kf_v = [R.copy()], [p.copy()], [v.copy()]
    acc_w, gyr_w, dt_w = [], [], []
    n_steps = n_kf * samples_per_kf
    # smooth body acceleration / rotation profiles
    t = np.arange(n_steps) * dt
    a_prof = np.stack([0.6 * np.sin(2 * t), 0.4 * np.cos(3 * t),
                       0.3 * np.sin(t)], 1)
    w_prof = np.stack([0.2 * np.sin(t), 0.3 * np.cos(2 * t),
                       0.25 * np.sin(3 * t)], 1)
    window_a, window_g, window_dt = [], [], []
    for k in range(n_steps):
        a_b = a_prof[k]          # true body-frame specific force w/o gravity
        w_b = w_prof[k]
        # measured = specific force: a_meas = a_b - R^T g (+bias)
        a_meas = a_b - R.T @ g_w + ba
        w_meas = w_b + bg
        window_a.append(a_meas)
        window_g.append(w_meas)
        window_dt.append(dt)
        # integrate truth (same scheme as preintegrate)
        a_wrld = R @ a_b
        p = p + v * dt + 0.5 * a_wrld * dt * dt
        v = v + a_wrld * dt
        R = R @ np.asarray(so3.exp(jnp.asarray(w_b * dt)))
        if (k + 1) % samples_per_kf == 0:
            kf_R.append(R.copy())
            kf_p.append(p.copy())
            kf_v.append(v.copy())
            acc_w.append(np.stack(window_a))
            gyr_w.append(np.stack(window_g))
            dt_w.append(np.asarray(window_dt))
            window_a, window_g, window_dt = [], [], []
    return (np.stack(kf_R), np.stack(kf_p), np.stack(kf_v),
            np.stack(acc_w), np.stack(gyr_w), np.stack(dt_w))


def stack_preints(acc_w, gyr_w, dt_w, bg0, ba0):
    """Preintegrate each window; prepend a dummy entry 0."""
    outs = []
    c = calib()
    for i in range(acc_w.shape[0]):
        outs.append(pre.preintegrate(
            jnp.asarray(acc_w[i]), jnp.asarray(gyr_w[i]),
            jnp.asarray(dt_w[i]), jnp.asarray(bg0), jnp.asarray(ba0), c))
    dummy = pre.empty_preintegrated()
    outs = [dummy] + outs
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *outs)


class TestInertialInit:
    def test_recovers_scale_and_gravity(self):
        kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate()
        preints = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3), np.zeros(3))
        # visual frame: tilted + scaled version of the inertial world
        s_true = 2.5
        tilt = np.asarray(so3.exp(jnp.asarray([0.06, -0.04, 0.0])))
        R_vis = np.einsum("ij,njk->nik", tilt.T, kf_R)
        p_vis = (kf_p @ tilt) / s_true   # tilt.T @ p / s
        res = inertial_init.inertial_init(
            jnp.asarray(R_vis.astype(np.float32)),
            jnp.asarray(p_vis.astype(np.float32)), preints, G=G)
        assert abs(float(res.scale) - s_true) / s_true < 0.02, \
            f"scale {float(res.scale)} vs {s_true}"
        # gravity direction in the visual frame
        g_est = np.asarray(res.R_wg @ jnp.asarray([0.0, 0.0, -1.0])) * G
        g_vis = tilt.T @ g_w
        cos = g_est @ g_vis / (np.linalg.norm(g_est) * np.linalg.norm(g_vis))
        assert cos > 0.9995, f"gravity cos {cos}"
        np.testing.assert_allclose(np.asarray(res.bg), 0.0, atol=5e-3)

    def test_recovers_gyro_bias(self):
        bg_true = np.array([0.02, -0.015, 0.01])
        kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(bg=bg_true)
        preints = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3), np.zeros(3))
        res = inertial_init.inertial_init(
            jnp.asarray(kf_R.astype(np.float32)),
            jnp.asarray(kf_p.astype(np.float32)), preints, G=G)
        np.testing.assert_allclose(np.asarray(res.bg), bg_true, atol=4e-3)
        assert abs(float(res.scale) - 1.0) < 0.02

    def test_velocities_recovered(self):
        kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate()
        preints = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3), np.zeros(3))
        res = inertial_init.inertial_init(
            jnp.asarray(kf_R.astype(np.float32)),
            jnp.asarray(kf_p.astype(np.float32)), preints, G=G)
        np.testing.assert_allclose(np.asarray(res.velocities), kf_v,
                                   atol=0.05)


class TestInertialBA:
    def test_converges_with_imu(self):
        K = camera.PinholeK(*[jnp.float32(x) for x in
                              (400.0, 400.0, 320.0, 240.0)])
        kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(n_kf=5)
        n_kf = kf_R.shape[0]
        preints = stack_preints(acc_w, gyr_w, dt_w, np.zeros(3), np.zeros(3))
        rng = np.random.RandomState(3)
        n_pts = 80
        pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                        rng.uniform(3, 7, n_pts)], 1).astype(np.float32)
        # camera = body (T_bc = I); T_cw = T_wb^-1
        T_wb = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
        T_wb[:, :3, :3] = kf_R
        T_wb[:, :3, 3] = kf_p
        T_cw = jnp.asarray(np.linalg.inv(T_wb))
        obs_kf = jnp.repeat(jnp.arange(n_kf, dtype=jnp.int32), n_pts)
        obs_pt = jnp.tile(jnp.arange(n_pts, dtype=jnp.int32), n_kf)
        uv = jax.vmap(lambda T: camera.project(
            K, se3.apply(T, jnp.asarray(pts))))(T_cw).reshape(-1, 2)
        obs = local_ba.BAObservations(
            kf=obs_kf, pt=obs_pt, uv=uv, inv_sigma2=jnp.ones(n_kf * n_pts),
            valid=jnp.ones(n_kf * n_pts, bool))
        # perturb everything but KF0
        poses0 = np.array(T_cw)
        for i in range(1, n_kf):
            poses0[i] = np.asarray(se3.retract(
                jnp.asarray(poses0[i]),
                jnp.asarray(rng.randn(6) * 0.02, jnp.float32)))
        v0 = kf_v + rng.randn(n_kf, 3) * 0.1
        pts0 = pts + rng.randn(n_pts, 3).astype(np.float32) * 0.05
        fixed = jnp.zeros(n_kf, bool).at[0].set(True)
        res = inertial_ba.inertial_bundle_adjust(
            jnp.asarray(poses0), jnp.asarray(v0.astype(np.float32)),
            jnp.zeros((n_kf, 3)), jnp.zeros((n_kf, 3)), fixed,
            jnp.asarray(pts0), obs, preints,
            jnp.ones(n_kf, bool), K, jnp.asarray(g_w.astype(np.float32)),
            se3.identity(), iters=12)
        for i in range(n_kf):
            err = float(jnp.linalg.norm(se3.log(se3.compose(
                res.poses[i], se3.inverse(T_cw[i])))))
            assert err < 5e-3, f"KF{i} pose err {err}"
        v_err = np.abs(np.asarray(res.velocities) - kf_v).max()
        assert v_err < 0.05, f"velocity err {v_err}"
        assert float(res.chi2) < 1e-3


class TestVIPoseOpt:
    """Per-frame visual-inertial pose optimization with non-identity
    camera-IMU extrinsics (reference PoseInertialOptimizationLastFrame,
    src/Optimizer.cc:7998 + Tbc threading, include/ImuTypes.h:111)."""

    T_bc = np.asarray(se3.make(
        so3.exp(jnp.asarray([0.0, 0.0, 1.2])),
        jnp.asarray([0.10, 0.02, -0.03])))

    def _setup(self, seed=0, n_pts=60, px_noise=0.0):
        from multi_orbslam3_jax.opt import vi_pose_opt
        K = camera.PinholeK(*[jnp.float32(x) for x in
                              (400.0, 400.0, 320.0, 240.0)])
        kf_R, kf_p, kf_v, acc_w, gyr_w, dt_w = simulate(n_kf=4, seed=seed)
        i, j = 2, 3
        c = calib()
        preint = pre.preintegrate(
            jnp.asarray(acc_w[i]), jnp.asarray(gyr_w[i]),
            jnp.asarray(dt_w[i]), jnp.zeros(3), jnp.zeros(3), c)
        T_bc = self.T_bc
        T_bc_inv = np.linalg.inv(T_bc)

        def cam_pose(k):
            T_wb = np.eye(4, dtype=np.float32)
            T_wb[:3, :3] = kf_R[k]
            T_wb[:3, 3] = kf_p[k]
            return (T_bc_inv @ np.linalg.inv(T_wb)).astype(np.float32)

        T_prev = cam_pose(i)
        T_true = cam_pose(j)
        rng = np.random.RandomState(seed + 11)
        p_c = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                        rng.uniform(3, 7, n_pts)], 1).astype(np.float32)
        p_w = np.asarray(se3.apply(se3.inverse(jnp.asarray(T_true)),
                                   jnp.asarray(p_c)))
        uv = np.asarray(camera.project(K, jnp.asarray(p_c)))
        uv = uv + rng.randn(n_pts, 2).astype(np.float32) * px_noise
        return (vi_pose_opt, K, preint, T_prev, T_true, kf_v[i], kf_v[j],
                p_w, uv, n_pts)

    def test_inertial_only_matches_prediction(self):
        """With no visual observations the factor graph is exactly the IMU
        prediction from the fixed previous state — validates the T_bc
        body-pose composition in isolation."""
        (vp, K, preint, T_prev, T_true, v_prev, v_true, p_w, uv,
         n_pts) = self._setup()
        rng = np.random.RandomState(5)
        T0 = np.asarray(se3.retract(jnp.asarray(T_true),
                                    jnp.asarray(rng.randn(6) * 0.05,
                                                jnp.float32)))
        res = vp.pose_inertial_optimization(
            jnp.asarray(T0), jnp.asarray(v_true + rng.randn(3) * 0.2),
            jnp.zeros(3), jnp.zeros(3),
            jnp.asarray(T_prev), jnp.asarray(v_prev),
            jnp.zeros(3), jnp.zeros(3), preint, K,
            jnp.asarray(p_w), jnp.asarray(uv), jnp.ones(n_pts),
            jnp.zeros(n_pts, bool), jnp.asarray(g_w.astype(np.float32)),
            jnp.asarray(self.T_bc), rounds=2, iters=8)
        err = float(jnp.linalg.norm(se3.log(se3.compose(
            res.pose, se3.inverse(jnp.asarray(T_true))))))
        assert err < 5e-3, f"pose err {err}"
        v_err = float(jnp.linalg.norm(res.velocity - jnp.asarray(v_true)))
        assert v_err < 0.05, f"velocity err {v_err}"

    def test_visual_inertial_fusion(self):
        """Visual + inertial with noisy pixels: pose recovered and the
        velocity estimate comes out of the joint optimization."""
        (vp, K, preint, T_prev, T_true, v_prev, v_true, p_w, uv,
         n_pts) = self._setup(px_noise=0.5)
        rng = np.random.RandomState(7)
        T0 = np.asarray(se3.retract(jnp.asarray(T_true),
                                    jnp.asarray(rng.randn(6) * 0.03,
                                                jnp.float32)))
        res = vp.pose_inertial_optimization(
            jnp.asarray(T0), jnp.asarray(v_true + rng.randn(3) * 0.3),
            jnp.zeros(3), jnp.zeros(3),
            jnp.asarray(T_prev), jnp.asarray(v_prev),
            jnp.zeros(3), jnp.zeros(3), preint, K,
            jnp.asarray(p_w), jnp.asarray(uv), jnp.ones(n_pts),
            jnp.ones(n_pts, bool), jnp.asarray(g_w.astype(np.float32)),
            jnp.asarray(self.T_bc), rounds=2, iters=8)
        err = float(jnp.linalg.norm(se3.log(se3.compose(
            res.pose, se3.inverse(jnp.asarray(T_true))))))
        assert err < 5e-3, f"pose err {err}"
        v_err = float(jnp.linalg.norm(res.velocity - jnp.asarray(v_true)))
        assert v_err < 0.05, f"velocity err {v_err}"
        assert int(res.n_inliers) > n_pts * 0.8
