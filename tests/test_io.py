import os

import jax.numpy as jnp
import numpy as np

from multi_orbslam3_jax.dataio import checkpoint, tum
from multi_orbslam3_jax.map import mapstate as ms


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        m = ms.empty_map(8, 32, 16)
        m = m._replace(mp_pos=m.mp_pos.at[0].set(jnp.asarray([1.0, 2.0, 3.0])),
                       n_kf=jnp.int32(3))
        path = str(tmp_path / "map.npz")
        checkpoint.save_map(path, m, extra={"kf_map": np.arange(8)})
        m2, extra = checkpoint.load_map(path)
        np.testing.assert_allclose(np.asarray(m2.mp_pos[0]), [1.0, 2.0, 3.0])
        assert int(m2.n_kf) == 3
        np.testing.assert_array_equal(extra["kf_map"], np.arange(8))


class TestTum:
    def test_roundtrip(self, tmp_path):
        from multi_orbslam3_jax.geometry import se3
        T = np.asarray(se3.exp(jnp.asarray([0.1, -0.2, 0.3, 1.0, 2.0, 3.0])))
        path = str(tmp_path / "traj.txt")
        tum.write_tum(path, [(1.5, T), (2.0, np.eye(4, dtype=np.float32))])
        out = tum.read_tum(path)
        assert len(out) == 2
        assert abs(out[0][0] - 1.5) < 1e-6
        np.testing.assert_allclose(out[0][1], T, atol=1e-4)
