import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax.frontend.extractor import FrameFeatures
from multi_orbslam3_jax.geometry import se3, sim3
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.opt import sim3_solve
from multi_orbslam3_jax.pipeline import loop_closing


class TestHornSim3:
    def test_exact_recovery(self):
        rng = np.random.RandomState(0)
        p = jnp.asarray(rng.randn(50, 3).astype(np.float32))
        S_true = sim3.exp(jnp.asarray([0.1, -0.2, 0.3, 0.5, -0.4, 0.2, 0.3]))
        q = sim3.apply(S_true, p)
        S = sim3_solve.horn_sim3(p, q)
        np.testing.assert_allclose(np.asarray(S.R), np.asarray(S_true.R),
                                   atol=1e-4)
        np.testing.assert_allclose(float(S.s), float(S_true.s), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(S.t), np.asarray(S_true.t),
                                   atol=1e-4)

    def test_fix_scale(self):
        rng = np.random.RandomState(1)
        p = jnp.asarray(rng.randn(30, 3).astype(np.float32))
        S_true = sim3.exp(jnp.asarray([0.0, 0.1, 0.0, 0.3, 0.0, 0.1, 0.0]))
        q = sim3.apply(S_true, p)
        S = sim3_solve.horn_sim3(p, q, fix_scale=True)
        assert abs(float(S.s) - 1.0) < 1e-6

    def test_ransac_with_outliers(self):
        rng = np.random.RandomState(2)
        M = 120
        p = jnp.asarray(rng.randn(M, 3).astype(np.float32) * 2.0)
        S_true = sim3.exp(jnp.asarray([0.05, 0.1, -0.1, 0.8, 0.2, -0.3, 0.2]))
        q = np.array(sim3.apply(S_true, p))
        q[:30] += rng.uniform(1.0, 3.0, (30, 3))  # 25% outliers
        res = sim3_solve.sim3_ransac(p, jnp.asarray(q), jnp.ones(M, bool),
                                     jax.random.PRNGKey(0), inlier_th=0.1)
        assert bool(res.ok)
        inl = np.asarray(res.inliers)
        assert inl[:30].mean() < 0.2
        assert inl[30:].mean() > 0.9
        np.testing.assert_allclose(float(res.S.s), float(S_true.s), rtol=0.02)


def _build_loop_map(n_kf=12, n_pts_per_kf=20, drift_sigma=0.0,
                    drift_after=6, drift_xi=None, seed=0):
    """A hand-built map: KFs along a circle-ish path, each with its own
    landmarks. Optionally apply an artificial drift (rigid+scale error) to
    every KF/landmark after `drift_after`."""
    rng = np.random.RandomState(seed)
    n_feat = 32
    m = ms.empty_map(max_kf=16, max_mp=512, n_feat=n_feat)
    all_T = []
    for i in range(n_kf):
        xi = jnp.asarray([0.0, 0.25 * i, 0.0, 0.6 * i, 0.0, 0.0])
        all_T.append(se3.exp(xi))
    for i in range(n_kf):
        feats = FrameFeatures(
            uv=jnp.asarray(rng.uniform(0, 300, (n_feat, 2)).astype(np.float32)),
            uv_und=jnp.asarray(rng.uniform(0, 300, (n_feat, 2)).astype(np.float32)),
            response=jnp.ones(n_feat), level=jnp.zeros(n_feat, jnp.int32),
            angle=jnp.zeros(n_feat),
            desc=jnp.asarray(rng.randint(0, 2 ** 32, (n_feat, 8),
                                         dtype=np.uint32)),
            valid=jnp.ones(n_feat, bool))
        m, k = ms.add_keyframe(m, feats, all_T[i], float(i),
                               jnp.full((n_feat,), ms.NO_MP, jnp.int32),
                               i - 1)
        # landmarks in front of this KF
        pts = jnp.asarray(rng.uniform(-1, 1, (n_pts_per_kf, 3))
                          .astype(np.float32)) + jnp.asarray([0.0, 0.0, 4.0])
        p_world = se3.apply(se3.inverse(all_T[i])[None], pts)
        m, slots = ms.add_mappoints(
            m, p_world, jnp.ones(n_pts_per_kf, bool),
            feats.desc[:n_pts_per_kf], k, k,
            jnp.arange(n_pts_per_kf, dtype=jnp.int32), k,
            jnp.arange(n_pts_per_kf, dtype=jnp.int32))
    return m, all_T


class TestCorrectLoop:
    def test_drift_corrected(self):
        m, all_T = _build_loop_map()
        # apply artificial drift S_d to KFs >= 6 and their landmarks:
        # world entities seen by late KFs move to S_d(p)
        S_d = sim3.exp(jnp.asarray([0.0, 0.05, 0.0, 0.3, 0.0, 0.1, 0.08]))
        late = np.arange(6, 12)
        kf_pose = np.array(m.kf_pose)
        for k in late:
            # camera still sees same pixels: T' = T o S_d^-1 (fold scale)
            S_old = sim3.from_se3(jnp.asarray(kf_pose[k]))
            S_new = sim3.compose(S_old, sim3.inverse(S_d))
            kf_pose[k] = np.asarray(sim3.to_se3_scaled(S_new))
        mp_pos = np.array(m.mp_pos)
        mp_ref = np.array(m.mp_ref_kf)
        late_mp = np.isin(mp_ref, late)
        mp_pos[late_mp] = np.asarray(sim3.apply(
            S_d, jnp.asarray(mp_pos[late_mp])))
        m = m._replace(kf_pose=jnp.asarray(kf_pose), mp_pos=jnp.asarray(mp_pos))

        # ground-truth loop constraint between KF 11 (drifted) and KF 0:
        # drifted-region points q = S_d(p_true): verify_loop's convention is
        # p_cur ~ S(p_cand) with cand side undrifted => S = S_d
        m2 = loop_closing.correct_loop(m, jnp.int32(11), jnp.int32(0), S_d,
                                       max_covis_edges=32, iters=12)
        # all poses should return near their true values
        for k in range(12):
            err = float(jnp.linalg.norm(se3.log(se3.compose(
                m2.kf_pose[k], se3.inverse(all_T[k])))))
            assert err < 0.12, f"KF{k} err {err}"
        # drifted landmarks should be pulled back
        gt_pos = np.array(_build_loop_map()[0].mp_pos)
        err_pts = np.linalg.norm(np.asarray(m2.mp_pos) - gt_pos, axis=1)
        n_mp = int(m2.n_mp)
        assert np.median(err_pts[:n_mp]) < 0.15


@pytest.mark.slow
def test_correct_loop_arena_scale():
    """Loop correction at server-arena scale (round-2 VERDICT Weak #6 /
    item 7): 1024 KFs x 32k landmarks. The chunked covisibility build
    keeps the peak footprint bounded (bool mask + one bf16 chunk) —
    previously the dense f32 (K, P) mask alone was ~0.5 GB at the
    4-agent arena. Asserts the correction runs and returns finite
    poses/points in bounded time."""
    import time as _time
    K_arena, P_arena, N = 1024, 32768, 256
    rng = np.random.RandomState(0)
    m = ms.empty_map(K_arena, P_arena, N)
    kf_mp = np.where(rng.rand(K_arena, N) < 0.5,
                     rng.randint(0, P_arena, (K_arena, N)), -1)
    poses = np.tile(np.eye(4, dtype=np.float32), (K_arena, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 20, K_arena)
    parents = np.arange(-1, K_arena - 1, dtype=np.int32)
    m = m._replace(
        kf_valid=jnp.ones(K_arena, bool),
        kf_pose=jnp.asarray(poses),
        kf_parent=jnp.asarray(parents),
        kf_mp=jnp.asarray(kf_mp, jnp.int32),
        kf_feat_valid=jnp.ones((K_arena, N), bool),
        mp_pos=jnp.asarray(rng.randn(P_arena, 3), jnp.float32),
        mp_valid=jnp.ones(P_arena, bool),
        mp_ref_kf=jnp.asarray(rng.randint(0, K_arena, P_arena), jnp.int32),
        n_kf=jnp.int32(K_arena), n_mp=jnp.int32(P_arena))
    S = sim3.exp(jnp.asarray([0.0, 0.02, 0.0, 0.1, 0.0, 0.05, 0.02]))
    t0 = _time.perf_counter()
    m2 = loop_closing.correct_loop(m, jnp.int32(K_arena - 1), jnp.int32(0),
                                   S, max_covis_edges=256, iters=3)
    np.asarray(m2.kf_pose)          # block
    wall = _time.perf_counter() - t0
    assert np.isfinite(np.asarray(m2.kf_pose)).all()
    assert np.isfinite(np.asarray(m2.mp_pos)).all()
    # compile+run bounded (the old dense path OOM'd or took minutes)
    assert wall < 300.0, wall


def _projected_kf(m, K, T_cw, pts_world, desc, ts, parent=-1, n_feat=64):
    """Add a KF whose features are the true projections of pts_world, plus
    its own landmark entries observed by it (duplicate-entry style, the
    situation right before a loop fusion)."""
    from multi_orbslam3_jax.geometry import camera as camm
    uv = np.asarray(camm.project(K, se3.apply(jnp.asarray(T_cw)[None],
                                              jnp.asarray(pts_world))))
    P = pts_world.shape[0]
    uv_pad = np.zeros((n_feat, 2), np.float32)
    uv_pad[:P] = uv
    desc_pad = np.zeros((n_feat, 8), np.uint32)
    desc_pad[:P] = desc
    valid = np.zeros(n_feat, bool)
    valid[:P] = True
    feats = FrameFeatures(
        uv=jnp.asarray(uv_pad), uv_und=jnp.asarray(uv_pad),
        response=jnp.ones(n_feat), level=jnp.zeros(n_feat, jnp.int32),
        angle=jnp.zeros(n_feat), desc=jnp.asarray(desc_pad),
        valid=jnp.asarray(valid))
    m, k = ms.add_keyframe(m, feats, jnp.asarray(T_cw), ts,
                           jnp.full((n_feat,), ms.NO_MP, jnp.int32), parent)
    idx = jnp.arange(P, dtype=jnp.int32)
    m, slots = ms.add_mappoints(m, jnp.asarray(pts_world),
                                jnp.ones(P, bool), jnp.asarray(desc_pad[:P]),
                                k, k, idx, k, idx)
    return m, int(k)


class TestVerificationCascade:
    """Reference cascade: Sim3 RANSAC -> reprojection OptimizeSim3 ->
    guided projection re-check (LoopClosing.cc:580, Optimizer.cc:4031).
    The adversarial case: repeated texture where 3D-3D RANSAC alone
    false-positives but the projection re-check rejects."""

    def _setup(self, adversarial: bool):
        from multi_orbslam3_jax.geometry import camera as camm
        rng = np.random.RandomState(3)
        K = camm.PinholeK(*[jnp.float32(x) for x in
                            (300.0, 300.0, 160.0, 120.0)])
        P = 64
        # place A: random landmarks in front of the origin
        p_A = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1, 1, P),
                        rng.uniform(3, 6, P)], 1).astype(np.float32)
        desc = rng.randint(0, 2 ** 32, (P, 8), dtype=np.uint32)
        T_a = np.eye(4, dtype=np.float32)
        m = ms.empty_map(max_kf=16, max_mp=512, n_feat=64)
        m, kA = _projected_kf(m, K, T_a, p_A, desc, 0.0)
        if not adversarial:
            # genuine loop: same place seen again with duplicate entries
            p_B = p_A.copy()
        else:
            # repeated texture: same DESCRIPTORS, but only 20 of 64 points
            # follow a similarity; the rest are elsewhere (a different
            # facade with the same tiling)
            S_d = sim3.exp(jnp.asarray([0.0, 0.1, 0.0, 0.4, 0.0, 0.2, 0.05]))
            p_B = np.array(sim3.apply(S_d, jnp.asarray(p_A)))
            scram = np.stack([rng.uniform(-1.5, 1.5, P - 20),
                              rng.uniform(-1, 1, P - 20),
                              rng.uniform(3, 6, P - 20)], 1)
            p_B[20:] = scram + np.asarray([0.0, 0.0, 0.5])
        T_b = np.asarray(se3.exp(jnp.asarray(
            [0.0, 0.03, 0.0, 0.15, 0.05, 0.0])), np.float32)
        m, kB = _projected_kf(m, K, T_b, p_B.astype(np.float32), desc, 9.0,
                              parent=kA)
        return m, K, kA, kB

    def test_true_loop_accepted(self):
        m, K, kA, kB = self._setup(adversarial=False)
        casc = loop_closing.verify_candidate_cascade(
            m, kB, kA, jax.random.PRNGKey(0), K, width=320, height=240,
            min_proj_matches=25)
        assert casc.ok, f"true loop rejected (n_proj={casc.n_proj})"
        assert casc.n_proj >= 25

    def test_repeated_texture_rejected(self):
        m, K, kA, kB = self._setup(adversarial=True)
        # the naive 3D-3D path (round-1 pipeline) false-positives:
        lm = loop_closing.match_loop_landmarks(m, jnp.int32(kB),
                                               jnp.int32(kA))
        res = loop_closing.verify_loop(m, lm, jax.random.PRNGKey(0))
        assert bool(res.ok), "precondition: RANSAC alone should accept"
        # the full cascade rejects on the guided-projection count:
        casc = loop_closing.verify_candidate_cascade(
            m, kB, kA, jax.random.PRNGKey(0), K, width=320, height=240,
            min_proj_matches=25)
        assert not casc.ok, \
            f"repeated texture accepted (n_proj={casc.n_proj})"
