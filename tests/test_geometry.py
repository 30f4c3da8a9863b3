import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax.geometry import so3, se3, sim3, camera, triangulation


def rand_rotvec(key, n=8, scale=1.0):
    return scale * jax.random.normal(key, (n, 3))


class TestSO3:
    def test_exp_log_roundtrip(self):
        w = rand_rotvec(jax.random.PRNGKey(0), 32, 1.5)
        # log returns the canonical vector with |w| <= pi; keep inputs in range
        norm = jnp.linalg.norm(w, axis=-1, keepdims=True)
        w = w * jnp.minimum(norm, 3.0) / norm
        R = so3.exp(w)
        w2 = so3.log(R)
        np.testing.assert_allclose(np.asarray(w), np.asarray(w2), atol=1e-4)

    def test_exp_small_angle(self):
        w = jnp.array([[1e-6, -2e-6, 3e-7], [0.0, 0.0, 0.0]])
        R = so3.exp(w)
        np.testing.assert_allclose(np.asarray(R[1]), np.eye(3), atol=1e-6)
        w2 = so3.log(R)
        np.testing.assert_allclose(np.asarray(w), np.asarray(w2), atol=1e-6)

    def test_rotation_orthonormal(self):
        w = rand_rotvec(jax.random.PRNGKey(1), 16, 2.0)
        R = so3.exp(w)
        RtR = jnp.einsum("nij,nik->njk", R, R)
        np.testing.assert_allclose(
            np.asarray(RtR), np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-5)
        np.testing.assert_allclose(np.asarray(jnp.linalg.det(R)), 1.0, atol=1e-5)

    def test_log_near_pi(self):
        axis = jnp.array([0.3, -0.5, 0.81])
        axis = axis / jnp.linalg.norm(axis)
        w = axis * (np.pi - 1e-4)
        R = so3.exp(w)
        w2 = so3.log(R)
        np.testing.assert_allclose(np.asarray(so3.exp(w2)), np.asarray(R), atol=1e-3)

    def test_right_jacobian_numeric(self):
        w = jnp.array([0.3, -0.2, 0.5])
        Jr = so3.right_jacobian(w)
        eps = 1e-4
        cols = []
        for i in range(3):
            dw = jnp.zeros(3).at[i].set(eps)
            # exp(w + dw) ~ exp(w) exp(Jr dw)
            d = so3.log(jnp.linalg.inv(so3.exp(w)) @ so3.exp(w + dw)) / eps
            cols.append(d)
        Jnum = jnp.stack(cols, axis=-1)
        np.testing.assert_allclose(np.asarray(Jr), np.asarray(Jnum), atol=1e-3)

    def test_jr_inv(self):
        w = rand_rotvec(jax.random.PRNGKey(3), 8, 1.0)
        J = so3.right_jacobian(w)
        Ji = so3.right_jacobian_inv(w)
        np.testing.assert_allclose(
            np.asarray(J @ Ji), np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-4)

    def test_quaternion_roundtrip(self):
        w = rand_rotvec(jax.random.PRNGKey(4), 32, 2.0)
        R = so3.exp(w)
        q = so3.to_quaternion(R)
        R2 = so3.from_quaternion(q)
        np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-5)


class TestSE3:
    def test_exp_log_roundtrip(self):
        key = jax.random.PRNGKey(5)
        xi = jax.random.normal(key, (16, 6))
        T = se3.exp(xi)
        xi2 = se3.log(T)
        np.testing.assert_allclose(np.asarray(xi), np.asarray(xi2), atol=1e-4)

    def test_inverse_compose(self):
        xi = jax.random.normal(jax.random.PRNGKey(6), (8, 6))
        T = se3.exp(xi)
        eye = se3.compose(T, se3.inverse(T))
        np.testing.assert_allclose(
            np.asarray(eye), np.broadcast_to(np.eye(4), (8, 4, 4)), atol=1e-5)

    def test_apply(self):
        T = se3.exp(jnp.array([0.0, 0.0, jnp.pi / 2, 1.0, 0.0, 0.0]))
        p = jnp.array([1.0, 0.0, 0.0])
        # rotation by 90deg about z maps x->y; plus translation component
        p2 = se3.apply(T, p)
        expected = se3.rotation(T) @ p + se3.translation(T)
        np.testing.assert_allclose(np.asarray(p2), np.asarray(expected), atol=1e-6)

    def test_retract_identity(self):
        T = se3.exp(jax.random.normal(jax.random.PRNGKey(7), (6,)))
        T2 = se3.retract(T, jnp.zeros(6))
        np.testing.assert_allclose(np.asarray(T), np.asarray(T2), atol=1e-6)


class TestSim3:
    def test_exp_log_roundtrip(self):
        zeta = 0.5 * jax.random.normal(jax.random.PRNGKey(8), (16, 7))
        S = sim3.exp(zeta)
        zeta2 = sim3.log(S)
        np.testing.assert_allclose(np.asarray(zeta), np.asarray(zeta2), atol=1e-3)

    def test_compose_inverse(self):
        zeta = 0.5 * jax.random.normal(jax.random.PRNGKey(9), (8, 7))
        S = sim3.exp(zeta)
        I = sim3.compose(S, sim3.inverse(S))
        np.testing.assert_allclose(
            np.asarray(I.R), np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-5)
        np.testing.assert_allclose(np.asarray(I.t), 0.0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(I.s), 1.0, atol=1e-5)

    def test_action_matches_composition(self):
        za = 0.3 * jax.random.normal(jax.random.PRNGKey(10), (7,))
        zb = 0.3 * jax.random.normal(jax.random.PRNGKey(11), (7,))
        A, B = sim3.exp(za), sim3.exp(zb)
        p = jax.random.normal(jax.random.PRNGKey(12), (5, 3))
        lhs = sim3.apply(sim3.compose(A, B), p)
        rhs = sim3.apply(A, sim3.apply(B, p))
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-5)

    def test_identity_scale(self):
        S = sim3.identity((4,))
        p = jnp.ones((4, 3))
        np.testing.assert_allclose(np.asarray(sim3.apply(S, p)), 1.0, atol=1e-7)

    def test_stack_unstack(self):
        zeta = 0.5 * jax.random.normal(jax.random.PRNGKey(13), (4, 7))
        S = sim3.exp(zeta)
        S2 = sim3.unstack(sim3.stack(S))
        np.testing.assert_allclose(np.asarray(S.R), np.asarray(S2.R), atol=1e-7)
        np.testing.assert_allclose(np.asarray(S.s), np.asarray(S2.s), atol=1e-7)


class TestCamera:
    def setup_method(self, _):
        self.K = camera.PinholeK(*[jnp.float32(v) for v in (400.0, 410.0, 320.0, 240.0)])

    def test_project_unproject(self):
        uv = jnp.array([[100.0, 50.0], [320.0, 240.0], [600.0, 400.0]])
        b = camera.unproject(self.K, uv)
        uv2 = camera.project(self.K, b * 3.7)  # any positive depth
        np.testing.assert_allclose(np.asarray(uv), np.asarray(uv2), atol=1e-4)

    def test_project_jacobian_numeric(self):
        p = jnp.array([0.3, -0.2, 2.0])
        J = camera.project_jacobian(self.K, p)
        eps = 1e-2  # float32 central differences need a coarse step
        Jn = np.zeros((2, 3))
        for i in range(3):
            dp = jnp.zeros(3).at[i].set(eps)
            Jn[:, i] = np.asarray(
                (camera.project(self.K, p + dp) - camera.project(self.K, p - dp))
                / (2 * eps))
        np.testing.assert_allclose(np.asarray(J), Jn, atol=1e-2)

    def test_radtan_roundtrip(self):
        dist = jnp.array([-0.28, 0.07, 1e-4, -2e-5, 0.0])
        xy = jnp.array([[0.1, 0.2], [-0.3, 0.15], [0.0, 0.0]])
        d = camera.radtan_distort(xy, dist)
        u = camera.radtan_undistort(d, dist)
        np.testing.assert_allclose(np.asarray(xy), np.asarray(u), atol=1e-5)

    def test_kb8_roundtrip(self):
        kb = jnp.array([0.003, 0.0008, -0.0004, 0.0001])
        p = jnp.array([[0.4, 0.1, 1.0], [-0.2, 0.3, 2.0], [0.9, -0.8, 1.5]])
        uv = camera.kb8_project(self.K, kb, p)
        b = camera.kb8_unproject(self.K, kb, uv)
        # bearings should align with p (same direction)
        pn = p / jnp.linalg.norm(p, axis=-1, keepdims=True)
        bn = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
        np.testing.assert_allclose(np.asarray(pn), np.asarray(bn), atol=1e-4)

    def test_kb8_jacobian_numeric(self):
        kb = jnp.array([0.003, 0.0008, -0.0004, 0.0001])
        p = jnp.array([0.3, -0.25, 1.4])
        J = camera.kb8_project_jacobian(self.K, kb, p)
        eps = 1e-2
        Jn = np.zeros((2, 3))
        for i in range(3):
            dp = jnp.zeros(3).at[i].set(eps)
            Jn[:, i] = np.asarray(
                (camera.kb8_project(self.K, kb, p + dp)
                 - camera.kb8_project(self.K, kb, p - dp)) / (2 * eps))
        np.testing.assert_allclose(np.asarray(J), Jn, rtol=1e-2, atol=1e-2)


class TestTriangulation:
    def test_triangulate_exact(self):
        key = jax.random.PRNGKey(20)
        K = camera.PinholeK(*[jnp.float32(v) for v in (400.0, 400.0, 320.0, 240.0)])
        pts = jax.random.uniform(key, (64, 3), minval=-1.0, maxval=1.0) \
            + jnp.array([0.0, 0.0, 4.0])
        T1 = se3.identity()
        T2 = se3.exp(jnp.array([0.0, 0.05, 0.0, -0.5, 0.0, 0.0]))
        pc1 = se3.apply(T1, pts)
        pc2 = se3.apply(T2, pts)
        b1 = pc1 / pc1[..., 2:3]
        b2 = pc2 / pc2[..., 2:3]
        uv1 = camera.project(K, pc1)
        uv2 = camera.project(K, pc2)
        p, ok = triangulation.triangulate_and_check(
            jnp.broadcast_to(T1, (64, 4, 4)), jnp.broadcast_to(T2, (64, 4, 4)),
            b1, b2, K, uv1, uv2)
        assert bool(jnp.all(ok))
        np.testing.assert_allclose(np.asarray(p), np.asarray(pts), atol=1e-2)

    def test_rejects_behind_camera(self):
        K = camera.PinholeK(*[jnp.float32(v) for v in (400.0, 400.0, 320.0, 240.0)])
        pt = jnp.array([[0.0, 0.0, -3.0]])
        T1 = jnp.broadcast_to(se3.identity(), (1, 4, 4))
        T2 = jnp.broadcast_to(
            se3.exp(jnp.array([0.0, 0.0, 0.0, -0.5, 0.0, 0.0])), (1, 4, 4))
        b1 = pt / pt[..., 2:3]
        b2 = (se3.apply(T2, pt)) / se3.apply(T2, pt)[..., 2:3]
        uv1 = camera.project(K, pt)
        uv2 = camera.project(K, se3.apply(T2, pt))
        _, ok = triangulation.triangulate_and_check(T1, T2, b1, b2, K, uv1, uv2)
        assert not bool(ok[0])

    def test_rejects_zero_parallax(self):
        K = camera.PinholeK(*[jnp.float32(v) for v in (400.0, 400.0, 320.0, 240.0)])
        pt = jnp.array([[0.1, 0.2, 5.0]])
        T = jnp.broadcast_to(se3.identity(), (1, 4, 4))
        b = pt / pt[..., 2:3]
        uv = camera.project(K, pt)
        _, ok = triangulation.triangulate_and_check(T, T, b, b, K, uv, uv)
        assert not bool(ok[0])
