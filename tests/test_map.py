import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.frontend.extractor import FrameFeatures
from multi_orbslam3_jax.map import mapstate as ms


def _feats(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return FrameFeatures(
        uv=jnp.asarray(rng.uniform(0, 100, (n, 2)).astype(np.float32)),
        uv_und=jnp.asarray(rng.uniform(0, 100, (n, 2)).astype(np.float32)),
        response=jnp.ones(n, jnp.float32),
        level=jnp.zeros(n, jnp.int32),
        angle=jnp.zeros(n, jnp.float32),
        desc=jnp.asarray(rng.randint(0, 2**32, (n, 8), dtype=np.uint32)),
        valid=jnp.ones(n, bool),
    )


def _map(max_kf=8, max_mp=64, n_feat=16):
    return ms.empty_map(max_kf, max_mp, n_feat)


class TestAddKeyframe:
    def test_add_and_slot(self):
        m = _map()
        no = jnp.full((16,), ms.NO_MP, jnp.int32)
        m, k0 = ms.add_keyframe(m, _feats(), jnp.eye(4), 0.0, no, -1)
        m, k1 = ms.add_keyframe(m, _feats(seed=1), jnp.eye(4), 0.1, no, 0)
        assert int(k0) == 0 and int(k1) == 1
        assert int(m.n_kf) == 2
        assert bool(m.kf_valid[0]) and bool(m.kf_valid[1])
        assert int(m.kf_parent[1]) == 0

    def test_capacity_overflow(self):
        m = _map(max_kf=2)
        no = jnp.full((16,), ms.NO_MP, jnp.int32)
        for i in range(3):
            m, k = ms.add_keyframe(m, _feats(), jnp.eye(4), 0.0, no, -1)
        assert int(k) == -1
        assert int(m.n_kf) == 2


class TestMapPoints:
    def _setup_two_kfs(self):
        m = _map()
        no = jnp.full((16,), ms.NO_MP, jnp.int32)
        m, _ = ms.add_keyframe(m, _feats(), jnp.eye(4), 0.0, no, -1)
        m, _ = ms.add_keyframe(m, _feats(seed=1), jnp.eye(4), 0.1, no, 0)
        return m

    def test_add_mappoints(self):
        m = self._setup_two_kfs()
        B = 4
        pos = jnp.asarray(np.random.RandomState(2).uniform(-1, 1, (B, 3))
                          .astype(np.float32))
        ok = jnp.asarray([True, True, False, True])
        desc = jnp.zeros((B, 8), jnp.uint32)
        fa = jnp.asarray([0, 1, 2, 3], jnp.int32)
        fb = jnp.asarray([4, 5, 6, 7], jnp.int32)
        m, slots = ms.add_mappoints(m, pos, ok, desc, 0, 0, fa, 1, fb)
        s = np.asarray(slots)
        assert list(s) == [0, 1, -1, 2]
        assert int(m.n_mp) == 3
        # associations written in both KFs for created points only
        assert int(m.kf_mp[0, 0]) == 0 and int(m.kf_mp[1, 4]) == 0
        assert int(m.kf_mp[0, 2]) == ms.NO_MP
        assert bool(m.mp_valid[2]) and not bool(m.mp_valid[3])

    def test_covisibility(self):
        m = self._setup_two_kfs()
        B = 6
        pos = jnp.ones((B, 3), jnp.float32)
        ok = jnp.ones(B, bool)
        m, _ = ms.add_mappoints(m, pos, ok, jnp.zeros((B, 8), jnp.uint32),
                                0, 0, jnp.arange(B, dtype=jnp.int32),
                                1, jnp.arange(B, dtype=jnp.int32))
        W = ms.covisibility_matrix(m)
        assert int(W[0, 1]) == 6 and int(W[1, 0]) == 6
        assert int(W[0, 0]) == 0
        row = ms.covisibility_row(m, jnp.int32(0))
        assert int(row[1]) == 6

    def test_erase_mappoints(self):
        m = self._setup_two_kfs()
        B = 3
        m, slots = ms.add_mappoints(
            m, jnp.ones((B, 3)), jnp.ones(B, bool), jnp.zeros((B, 8), jnp.uint32),
            0, 0, jnp.arange(B, dtype=jnp.int32), 1, jnp.arange(B, dtype=jnp.int32))
        m = ms.erase_mappoints(m, jnp.asarray([1, -1], jnp.int32))
        assert not bool(m.mp_valid[1])
        assert int(m.kf_mp[0, 1]) == ms.NO_MP
        assert int(m.kf_mp[0, 0]) == 0  # untouched

    def test_replace_mappoint(self):
        m = self._setup_two_kfs()
        B = 3
        m, _ = ms.add_mappoints(
            m, jnp.ones((B, 3)), jnp.ones(B, bool), jnp.zeros((B, 8), jnp.uint32),
            0, 0, jnp.arange(B, dtype=jnp.int32), 1, jnp.arange(B, dtype=jnp.int32))
        m = ms.replace_mappoint(m, jnp.asarray([0], jnp.int32),
                                jnp.asarray([2], jnp.int32))
        assert int(m.kf_mp[0, 0]) == 2
        assert not bool(m.mp_valid[0])
        assert bool(m.mp_valid[2])

    def test_erase_keyframe(self):
        m = self._setup_two_kfs()
        no = jnp.full((16,), ms.NO_MP, jnp.int32)
        m, k2 = ms.add_keyframe(m, _feats(seed=2), jnp.eye(4), 0.2, no, 1)
        m = ms.erase_keyframe(m, jnp.int32(1))
        assert not bool(m.kf_valid[1])
        # child re-parents to erased KF's parent
        assert int(m.kf_parent[int(k2)]) == 0


class TestPointStats:
    def test_found_visible(self):
        m = ms.empty_map(4, 8, 4)
        no = jnp.full((4,), ms.NO_MP, jnp.int32)
        m, _ = ms.add_keyframe(m, _feats(n=4), jnp.eye(4), 0.0, no, -1)
        m, _ = ms.add_mappoints(
            m, jnp.ones((2, 3)), jnp.ones(2, bool), jnp.zeros((2, 8), jnp.uint32),
            0, 0, jnp.asarray([0, 1], jnp.int32), 0, jnp.asarray([2, 3], jnp.int32))
        feat_mp = jnp.asarray([0, -1, -1, -1], jnp.int32)
        visible = jnp.zeros(8, bool).at[jnp.asarray([0, 1])].set(True)
        m = ms.update_found_visible(m, feat_mp, visible)
        assert int(m.mp_found[0]) == 1 and int(m.mp_found[1]) == 0
        assert int(m.mp_visible[0]) == 1 and int(m.mp_visible[1]) == 1

    def test_refresh_descriptor_median_vote(self):
        # three observations of one landmark: two identical descriptors and
        # one outlier -> the representative must be the majority descriptor
        n = 4
        m = ms.empty_map(4, 8, n)
        no = jnp.full((n,), ms.NO_MP, jnp.int32)
        d_major = np.full((8,), 0x0F0F0F0F, np.uint32)
        d_outlier = np.full((8,), 0xFFFFFFFF, np.uint32)

        def feats_with(d0):
            f = _feats(n=n)
            return f._replace(desc=f.desc.at[0].set(jnp.asarray(d0)))

        m, k0 = ms.add_keyframe(m, feats_with(d_outlier), jnp.eye(4), 0.0, no, -1)
        m, k1 = ms.add_keyframe(m, feats_with(d_major), jnp.eye(4), 0.1, no, 0)
        T2 = np.eye(4, dtype=np.float32); T2[2, 3] = 0.5
        m, k2 = ms.add_keyframe(m, feats_with(d_major), jnp.asarray(T2), 0.2, no, 1)
        # one landmark observed at feature 0 of all three KFs, outlier desc
        m, slots = ms.add_mappoints(
            m, jnp.asarray([[0.0, 0.0, 2.0]]), jnp.ones(1, bool),
            jnp.asarray(d_outlier)[None], 0,
            0, jnp.zeros(1, jnp.int32), 1, jnp.zeros(1, jnp.int32))
        m = m._replace(kf_mp=m.kf_mp.at[2, 0].set(0))
        m = ms.refresh_point_stats(
            m, jnp.asarray([0, 1, 2], jnp.int32), jnp.ones(3, bool),
            scale_factor=1.2, n_levels=8)
        np.testing.assert_array_equal(np.array(m.mp_desc[0]), d_major)
        # normal points from the cameras (z=0 / z=-0.5 origins) to the point
        nrm = np.array(m.mp_normal[0])
        assert nrm[2] > 0.99
        # depth range set from the reference KF (dist 2.0, level 0)
        assert abs(float(m.mp_max_dist[0]) - 2.0) < 1e-3
        assert float(m.mp_min_dist[0]) < 2.0


class TestFuse:
    def test_fuse_duplicates_and_attach(self):
        from multi_orbslam3_jax.geometry import camera as cam
        from multi_orbslam3_jax.pipeline import local_mapping
        K = cam.PinholeK(fx=100.0, fy=100.0, cx=50.0, cy=50.0)
        n = 8
        m = ms.empty_map(4, 16, n)
        rng = np.random.RandomState(3)
        pts = np.array([[0.0, 0.0, 2.0], [0.2, 0.1, 2.5], [-0.2, -0.1, 3.0]],
                       np.float32)
        uv = np.stack([100.0 * pts[:, 0] / pts[:, 2] + 50.0,
                       100.0 * pts[:, 1] / pts[:, 2] + 50.0], axis=1)
        descs = rng.randint(0, 2**32, (3, 8), dtype=np.uint32)
        feats = FrameFeatures(
            uv=jnp.asarray(np.concatenate([uv, rng.uniform(0, 100, (n - 3, 2))])
                           .astype(np.float32)),
            uv_und=jnp.asarray(np.concatenate(
                [uv, rng.uniform(0, 100, (n - 3, 2))]).astype(np.float32)),
            response=jnp.ones(n, jnp.float32),
            level=jnp.zeros(n, jnp.int32), angle=jnp.zeros(n, jnp.float32),
            desc=jnp.asarray(np.concatenate(
                [descs, rng.randint(0, 2**32, (n - 3, 8), dtype=np.uint32)])),
            valid=jnp.ones(n, bool))
        no = jnp.full((n,), ms.NO_MP, jnp.int32)
        m, k0 = ms.add_keyframe(m, feats, jnp.eye(4), 0.0, no, -1)
        m, k1 = ms.add_keyframe(m, feats, jnp.eye(4), 0.1, no, 0)
        # landmark 0: bound to feature 0 in BOTH kfs (2 obs)
        # landmark 1: duplicate of landmark 0 (same pos+desc), 1 obs in k1 feat 1... 
        # landmark 2: unbound anywhere, projects onto feature 2
        m, _ = ms.add_mappoints_raw(
            m, jnp.asarray(pts[[0, 0, 2]]), jnp.ones(3, bool),
            jnp.asarray(descs[[0, 0, 2]]), jnp.zeros(3, jnp.int32))
        m = m._replace(
            kf_mp=m.kf_mp.at[0, 0].set(0).at[1, 0].set(0),
            mp_normal=m.mp_normal.at[:3].set(
                jnp.asarray(pts[[0, 0, 2]] / np.linalg.norm(
                    pts[[0, 0, 2]], axis=1, keepdims=True))),
            mp_min_dist=m.mp_min_dist.at[:3].set(0.5),
            # max_dist ~= creation distance so the predicted level is 0,
            # matching the level-0 test features
            mp_max_dist=m.mp_max_dist.at[:3].set(
                jnp.asarray(np.linalg.norm(pts[[0, 0, 2]], axis=1) * 1.1)))
        out = local_mapping.fuse_into_keyframe(
            m, jnp.int32(1), K, width=100, height=100, scale_factor=1.2,
            n_levels=4)
        m2 = out.map
        # landmark 2 attached to feature 2 of kf 1
        assert int(m2.kf_mp[1, 2]) == 2
        assert int(out.n_attached) >= 1


class TestAtlas:
    def test_switch_and_stamp(self):
        m = ms.empty_map(4, 8, 4)
        no = jnp.full((4,), ms.NO_MP, jnp.int32)
        m, k0 = ms.add_keyframe(m, _feats(n=4), jnp.eye(4), 0.0, no, -1)
        m = ms.switch_map(m, 1)
        m, k1 = ms.add_keyframe(m, _feats(n=4, seed=1), jnp.eye(4), 1.0, no, -1)
        assert int(m.kf_map_id[0]) == 0 and int(m.kf_map_id[1]) == 1
        m, slots = ms.add_mappoints(
            m, jnp.ones((2, 3)), jnp.ones(2, bool),
            jnp.zeros((2, 8), jnp.uint32), 1,
            1, jnp.asarray([0, 1], jnp.int32), 1, jnp.asarray([2, 3], jnp.int32))
        assert int(m.mp_map_id[0]) == 1

    def test_erase_active_map(self):
        m = ms.empty_map(4, 8, 4)
        no = jnp.full((4,), ms.NO_MP, jnp.int32)
        m, _ = ms.add_keyframe(m, _feats(n=4), jnp.eye(4), 0.0, no, -1)
        m = ms.switch_map(m, 1)
        m, _ = ms.add_keyframe(m, _feats(n=4, seed=1), jnp.eye(4), 1.0, no, -1)
        m, _ = ms.add_mappoints(
            m, jnp.ones((1, 3)), jnp.ones(1, bool),
            jnp.zeros((1, 8), jnp.uint32), 1,
            1, jnp.zeros(1, jnp.int32), 1, jnp.ones(1, jnp.int32))
        m = ms.erase_active_map(m)
        assert bool(m.kf_valid[0]) and not bool(m.kf_valid[1])
        assert not bool(m.mp_valid[0])

    def test_merge_active_into(self):
        from multi_orbslam3_jax.geometry import sim3
        m = ms.empty_map(4, 8, 4)
        no = jnp.full((4,), ms.NO_MP, jnp.int32)
        m, _ = ms.add_keyframe(m, _feats(n=4), jnp.eye(4), 0.0, no, -1)
        m = ms.switch_map(m, 1)
        T1 = np.eye(4, dtype=np.float32); T1[0, 3] = 2.0
        m, _ = ms.add_keyframe(m, _feats(n=4, seed=1), jnp.asarray(T1), 1.0,
                               no, -1)
        m, _ = ms.add_mappoints(
            m, jnp.asarray([[1.0, 0.0, 3.0]]), jnp.ones(1, bool),
            jnp.zeros((1, 8), jnp.uint32), 1,
            1, jnp.zeros(1, jnp.int32), 1, jnp.ones(1, jnp.int32))
        # identity Sim3: merging just relabels
        m2 = ms.merge_active_into(m, 0, sim3.identity())
        assert int(m2.active_map) == 0
        assert int(m2.kf_map_id[1]) == 0 and int(m2.mp_map_id[0]) == 0
        np.testing.assert_allclose(np.array(m2.kf_pose[1]), T1, atol=1e-5)
        np.testing.assert_allclose(np.array(m2.mp_pos[0]), [1.0, 0.0, 3.0],
                                   atol=1e-5)
