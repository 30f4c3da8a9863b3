import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax.geometry import camera, se3
from multi_orbslam3_jax.opt import local_ba, pose_opt


K = camera.PinholeK(*[jnp.float32(v) for v in (400.0, 400.0, 320.0, 240.0)])


def make_scene(n_pts=120, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(3.0, 7.0, n_pts)], axis=1).astype(np.float32)
    return jnp.asarray(pts)


def project_all(T, pts):
    return camera.project(K, se3.apply(T, pts))


class TestPoseOpt:
    def test_recovers_pose(self):
        pts = make_scene()
        T_true = se3.exp(jnp.asarray([0.03, -0.05, 0.02, 0.2, -0.1, 0.15]))
        uv = project_all(T_true, pts)
        T0 = se3.identity()
        res = pose_opt.pose_optimization(
            T0, K, pts, uv, jnp.ones(pts.shape[0]), jnp.ones(pts.shape[0], bool))
        err = float(jnp.linalg.norm(se3.log(
            se3.compose(res.pose, se3.inverse(T_true)))))
        assert err < 1e-3, f"pose error {err}"
        assert int(res.n_inliers) == pts.shape[0]

    def test_rejects_outliers(self):
        pts = make_scene()
        T_true = se3.exp(jnp.asarray([0.0, 0.02, 0.0, 0.1, 0.0, 0.05]))
        uv = project_all(T_true, pts)
        n_out = 30
        uv = uv.at[:n_out].add(jnp.asarray(
            np.random.RandomState(1).uniform(30, 80, (n_out, 2)).astype(np.float32)))
        res = pose_opt.pose_optimization(
            se3.identity(), K, pts, uv, jnp.ones(pts.shape[0]),
            jnp.ones(pts.shape[0], bool))
        err = float(jnp.linalg.norm(se3.log(
            se3.compose(res.pose, se3.inverse(T_true)))))
        assert err < 5e-3, f"pose error {err}"
        inl = np.asarray(res.inliers)
        assert inl[n_out:].all()
        assert not inl[:n_out].any()

    def test_respects_mask(self):
        pts = make_scene(40)
        T_true = se3.exp(jnp.asarray([0.0, 0.0, 0.0, 0.05, 0.0, 0.0]))
        uv = project_all(T_true, pts)
        # corrupt masked-out observations wildly; they must not matter
        uv = uv.at[:10].add(500.0)
        mask = jnp.arange(40) >= 10
        res = pose_opt.pose_optimization(se3.identity(), K, pts, uv,
                                         jnp.ones(40), mask)
        err = float(jnp.linalg.norm(se3.log(
            se3.compose(res.pose, se3.inverse(T_true)))))
        assert err < 1e-3


class TestBundleAdjust:
    def _window(self, n_kf=4, n_pts=100, noise_pose=0.02, noise_pt=0.05,
                seed=0):
        rng = np.random.RandomState(seed)
        pts_true = make_scene(n_pts, seed)
        poses_true = []
        for i in range(n_kf):
            xi = jnp.asarray([0.0, 0.01 * i, 0.0, 0.3 * i, 0.0, 0.0])
            poses_true.append(se3.exp(xi))
        poses_true = jnp.stack(poses_true)
        # observations: every KF sees every point
        obs_kf = jnp.repeat(jnp.arange(n_kf, dtype=jnp.int32), n_pts)
        obs_pt = jnp.tile(jnp.arange(n_pts, dtype=jnp.int32), n_kf)
        uv = jax.vmap(lambda T: project_all(T, pts_true))(poses_true)
        obs_uv = uv.reshape(-1, 2)
        obs = local_ba.BAObservations(
            kf=obs_kf, pt=obs_pt, uv=obs_uv,
            inv_sigma2=jnp.ones(n_kf * n_pts),
            valid=jnp.ones(n_kf * n_pts, bool))
        # perturb
        poses0 = [poses_true[0]]
        for i in range(1, n_kf):
            noise = jnp.asarray(rng.randn(6) * noise_pose, jnp.float32)
            poses0.append(se3.retract(poses_true[i], noise))
        poses0 = jnp.stack(poses0)
        pts0 = pts_true + jnp.asarray(rng.randn(n_pts, 3) * noise_pt, jnp.float32)
        fixed = jnp.zeros(n_kf, bool).at[0].set(True)
        return poses_true, pts_true, poses0, pts0, fixed, obs

    def test_grouped_assembly_matches_scatter(self):
        """grouped=True (one-hot matmul assembly) must
        reproduce the scatter-path results bit-for-bit-ish on a grouped
        observation layout."""
        _, _, poses0, pts0, fixed, obs = self._window(seed=4)
        a = local_ba.bundle_adjust(poses0, fixed, pts0, obs, K, iters=8)
        b = local_ba.bundle_adjust(poses0, fixed, pts0, obs, K, iters=8,
                                   grouped=True)
        np.testing.assert_allclose(np.asarray(a.poses), np.asarray(b.poses),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(a.points),
                                   np.asarray(b.points), atol=1e-3)

    def test_inv3x3_matches_linalg(self):
        rng = np.random.RandomState(0)
        A = rng.randn(64, 3, 3).astype(np.float32)
        A = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3)   # SPD
        np.testing.assert_allclose(
            np.asarray(local_ba.inv3x3(jnp.asarray(A))),
            np.linalg.inv(A), rtol=2e-3, atol=2e-4)

    def test_converges(self):
        poses_true, pts_true, poses0, pts0, fixed, obs = self._window()
        res = local_ba.bundle_adjust(poses0, fixed, pts0, obs, K, iters=15)
        # poses should approach ground truth (gauge fixed by KF0)
        for i in range(poses_true.shape[0]):
            err = float(jnp.linalg.norm(se3.log(
                se3.compose(res.poses[i], se3.inverse(poses_true[i])))))
            assert err < 2e-3, f"KF{i} err {err}"
        pt_err = float(jnp.abs(res.points - pts_true).max())
        assert pt_err < 2e-2, f"point err {pt_err}"
        assert float(res.chi2) < 1e-4

    def test_fixed_kf_untouched(self):
        _, _, poses0, pts0, fixed, obs = self._window()
        res = local_ba.bundle_adjust(poses0, fixed, pts0, obs, K, iters=5)
        np.testing.assert_allclose(np.asarray(res.poses[0]),
                                   np.asarray(poses0[0]), atol=1e-6)

    def test_outlier_observations_classified(self):
        poses_true, pts_true, poses0, pts0, fixed, obs = self._window()
        bad = np.zeros(obs.uv.shape[0], bool)
        bad[::17] = True
        uv = np.array(obs.uv)
        uv[bad] += np.random.RandomState(3).uniform(40, 90, (bad.sum(), 2))
        obs = obs._replace(uv=jnp.asarray(uv))
        res = local_ba.bundle_adjust(poses0, fixed, pts0, obs, K, iters=15)
        inl = np.asarray(res.inliers)
        assert not inl[bad].any()
        assert inl[~bad].mean() > 0.95

    def test_structure_only(self):
        poses_true, pts_true, poses0, pts0, fixed, obs = self._window(
            noise_pose=0.0)
        res = local_ba.bundle_adjust(poses_true, jnp.ones(4, bool), pts0, obs,
                                     K, iters=10, structure_only=True)
        np.testing.assert_allclose(np.asarray(res.poses),
                                   np.asarray(poses_true), atol=1e-6)
        assert float(jnp.abs(res.points - pts_true).max()) < 1e-2


class TestPnP:
    def test_ransac_pnp_with_outliers(self):
        import jax
        from multi_orbslam3_jax.geometry import camera, se3
        from multi_orbslam3_jax.opt import pnp
        K = camera.PinholeK(*[jnp.float32(v) for v in (400., 400., 160., 120.)])
        rng = np.random.RandomState(0)
        n = 100
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        rng.uniform(3, 8, n)], 1).astype(np.float32)
        T = se3.exp(jnp.asarray([0.1, -0.2, 0.15, 0.3, -0.2, 0.5]))
        uv = np.array(camera.project(K, se3.apply(T, jnp.asarray(pts))))
        uv[:20] += rng.uniform(30, 80, (20, 2))     # 20% outliers
        res = pnp.pnp_ransac(K, jnp.asarray(pts), jnp.asarray(uv),
                             jnp.ones(n, bool), jnp.ones(n, jnp.float32),
                             jax.random.PRNGKey(1))
        assert bool(res.ok)
        err = np.array(res.pose) @ np.linalg.inv(np.array(T))
        assert abs(np.trace(err[:3, :3]) - 3.0) < 1e-2
        assert np.linalg.norm(err[:3, 3]) < 1e-2
        inl = np.array(res.inliers)
        assert inl[:20].mean() < 0.2 and inl[20:].mean() > 0.9


class TestStereoResiduals:
    """Stereo right-u rows (reference EdgeStereoSE3ProjectXYZ edges,
    Optimizer.cc stereo branches) make global scale observable in BA."""

    BF = 40.0  # baseline * fx

    def _stereo_obs(self, n_kf=3, n_pts=80):
        pts = make_scene(n_pts)
        poses = jnp.stack([se3.exp(jnp.asarray(
            [0.0, 0.01 * i, 0.0, 0.25 * i, 0.0, 0.0])) for i in range(n_kf)])

        def proj(T):
            pc = se3.apply(T, pts)
            uv = camera.project(K, pc)
            ur = K.fx * pc[..., 0] / pc[..., 2] + K.cx - self.BF / pc[..., 2]
            return uv, ur

        uvs, urs = zip(*[proj(poses[i]) for i in range(n_kf)])
        obs = local_ba.BAObservations(
            kf=jnp.repeat(jnp.arange(n_kf, dtype=jnp.int32), n_pts),
            pt=jnp.tile(jnp.arange(n_pts, dtype=jnp.int32), n_kf),
            uv=jnp.concatenate(uvs), inv_sigma2=jnp.ones(n_kf * n_pts),
            valid=jnp.ones(n_kf * n_pts, bool), u_r=jnp.concatenate(urs))
        return poses, pts, obs

    def test_ba_recovers_scale(self):
        poses, pts, obs = self._stereo_obs()
        s = 1.2   # global scale drift: unobservable for mono, not stereo
        res = local_ba.bundle_adjust(
            poses.at[:, :3, 3].multiply(s), jnp.zeros(3, bool).at[0].set(True),
            pts * s, obs, K, iters=15, bf=self.BF)
        ratio = float(jnp.median(jnp.linalg.norm(res.points, axis=-1)
                                 / jnp.linalg.norm(pts, axis=-1)))
        assert abs(ratio - 1.0) < 0.02, ratio
        # mono control: scale drift stays (gauge freedom)
        res_m = local_ba.bundle_adjust(
            poses.at[:, :3, 3].multiply(s), jnp.zeros(3, bool).at[0].set(True),
            pts * s, obs._replace(u_r=None), K, iters=15)
        ratio_m = float(jnp.median(jnp.linalg.norm(res_m.points, axis=-1)
                                   / jnp.linalg.norm(pts, axis=-1)))
        assert abs(ratio_m - s) < 0.05, ratio_m

    def test_pose_opt_mixed_mono_stereo(self):
        poses, pts, obs = self._stereo_obs(n_kf=2)
        n = pts.shape[0]
        uv = obs.uv[n:2 * n]
        ur = jnp.where(jnp.arange(n) % 2 == 0, obs.u_r[n:2 * n], -1.0)
        T0 = se3.exp(jnp.asarray([0.01, 0.0, 0.01, 0.05, 0.02, 0.1])) @ poses[1]
        res = pose_opt.pose_optimization(T0, K, pts, uv, jnp.ones(n),
                                         jnp.ones(n, bool), u_r=ur, bf=self.BF)
        err = float(jnp.linalg.norm(se3.log(
            se3.compose(res.pose, se3.inverse(poses[1])))))
        assert err < 1e-3
        assert int(res.n_inliers) == n
