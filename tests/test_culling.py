import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.frontend.extractor import FrameFeatures
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.pipeline import culling


def _feats(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return FrameFeatures(
        uv=jnp.asarray(rng.uniform(0, 100, (n, 2)).astype(np.float32)),
        uv_und=jnp.asarray(rng.uniform(0, 100, (n, 2)).astype(np.float32)),
        response=jnp.ones(n), level=jnp.zeros(n, jnp.int32),
        angle=jnp.zeros(n),
        desc=jnp.asarray(rng.randint(0, 2**32, (n, 8), dtype=np.uint32)),
        valid=jnp.ones(n, bool))


def _map_with_redundant_kf():
    """4 KFs all observing the same 8 landmarks => middle KFs redundant."""
    m = ms.empty_map(8, 64, 16)
    no = jnp.full((16,), ms.NO_MP, jnp.int32)
    for i in range(4):
        m, _ = ms.add_keyframe(m, _feats(seed=i), jnp.eye(4), float(i), no,
                               i - 1)
    B = 8
    idx = jnp.arange(B, dtype=jnp.int32)
    m, slots = ms.add_mappoints(m, jnp.ones((B, 3)), jnp.ones(B, bool),
                                jnp.zeros((B, 8), jnp.uint32), 0,
                                0, idx, 1, idx)
    # KFs 2,3 observe the same landmarks
    kfmp = m.kf_mp
    kfmp = kfmp.at[2, idx].set(slots)
    kfmp = kfmp.at[3, idx].set(slots)
    return m._replace(kf_mp=kfmp)


class TestCulling:
    def test_redundant_kf_detected(self):
        m = _map_with_redundant_kf()
        protect = jnp.zeros(8, bool)
        red = culling.redundant_keyframes(m, protect)
        # every KF sees only landmarks seen by >= 3 others => all redundant
        assert bool(red[:4].all())

    def test_protect_mask(self):
        m = _map_with_redundant_kf()
        protect = jnp.ones(8, bool)
        red = culling.redundant_keyframes(m, protect)
        assert not bool(red.any())

    def test_cull_round(self):
        m = _map_with_redundant_kf()
        protect = jnp.zeros(8, bool).at[0].set(True).at[3].set(True)
        m2, n_kf, n_mp = culling.cull(m, protect, max_kf_per_round=2)
        assert n_kf == 2
        assert not bool(m2.kf_valid[1]) and not bool(m2.kf_valid[2])
        assert bool(m2.kf_valid[0]) and bool(m2.kf_valid[3])
        # landmarks survive (still observed by KF0/KF3)
        assert int(m2.mp_valid.sum()) == 8

    def test_orphan_mappoints(self):
        m = _map_with_redundant_kf()
        # add a landmark observed by nothing but its creation pair, then
        # strip one side so it has a single observation
        idx = jnp.asarray([8], jnp.int32)
        m, slots = ms.add_mappoints(
            m, jnp.ones((1, 3)), jnp.ones(1, bool),
            jnp.zeros((1, 8), jnp.uint32), 0, 0, idx, 1, idx)
        m = m._replace(kf_mp=m.kf_mp.at[1, 8].set(ms.NO_MP))
        # not old enough yet (ref_kf=0, n_kf=4, age=3 -> 0 <= 1 ok) => old
        orphans = culling.orphan_mappoints(m)
        assert bool(orphans[int(slots[0])])
        # the well-observed landmarks stay
        assert int(orphans.sum()) == 1
