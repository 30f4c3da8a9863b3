"""Essential-graph auditor (reference Map::CheckEssentialGraph,
src/Map.cc:591): catches seeded corruptions and passes on healthy maps
produced by the real pipeline + server merge/cull flow."""

import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.map import mapstate as ms
from multi_orbslam3_jax.map.audit import (EssentialGraphError,
                                          check_essential_graph)


def _small_config():
    return cfg.synthetic_mono(width=320, height=240).replace(
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048,
                          max_obs=16384, max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024,
            local_ba_iters=8),
        # short CI sequences never reach the production 12-KF maturity gate
        loop=cfg.LoopConfig(min_map_kfs=6, event_interval_kfs=2))


def _healthy_map(n_frames=25):
    from multi_orbslam3_jax.pipeline.system import MonoSlam
    c = _small_config()
    seq = synthetic.make_sequence(c, n_frames=n_frames, n_points=500,
                                  seed=3, trajectory="forward")
    slam = MonoSlam(c, enable_loop_closing=False)
    for i in range(n_frames):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
    slam._adopt_pending(force=True)
    return slam.m


class TestAuditor:
    def test_healthy_map_passes(self):
        m = _healthy_map()
        stats = check_essential_graph(m)
        assert stats["n_kf"] >= 2
        assert stats["n_roots"] >= 1

    def test_catches_cycle(self):
        m = _healthy_map()
        # seed a 2-cycle: parent[a] = b, parent[b] = a
        par = np.asarray(m.kf_parent)
        valid = np.nonzero(np.asarray(m.kf_valid))[0]
        a, b = int(valid[1]), int(valid[2])
        par = par.copy()
        par[a] = b
        par[b] = a
        m2 = m._replace(kf_parent=jnp.asarray(par))
        with pytest.raises(EssentialGraphError, match="cycle|self"):
            check_essential_graph(m2)

    def test_catches_erased_parent(self):
        m = _healthy_map()
        valid = np.nonzero(np.asarray(m.kf_valid))[0]
        # erase a mid-chain keyframe WITHOUT re-parenting (the corruption
        # erase_keyframe normally prevents)
        k = int(valid[1])
        kv = np.asarray(m.kf_valid).copy()
        kv[k] = False
        m2 = m._replace(kf_valid=jnp.asarray(kv))
        with pytest.raises(EssentialGraphError, match="erased"):
            check_essential_graph(m2)

    def test_catches_out_of_range_ref(self):
        m = _healthy_map()
        ref = np.asarray(m.mp_ref_kf).copy()
        alive = np.nonzero(np.asarray(m.mp_valid))[0]
        ref[alive[0]] = 10 ** 6
        m2 = m._replace(mp_ref_kf=jnp.asarray(ref))
        with pytest.raises(EssentialGraphError, match="reference"):
            check_essential_graph(m2)

    def test_erase_keyframe_keeps_graph_sane(self):
        m = _healthy_map()
        valid = np.nonzero(np.asarray(m.kf_valid))[0]
        m2 = ms.erase_keyframe(m, jnp.int32(int(valid[1])))
        check_essential_graph(m2)


@pytest.mark.slow
def test_server_merge_and_cull_keep_graph_sane():
    """The auditor wired into the collaborative flow: after ingest,
    cross-agent merge, culling and GBA the server arena's essential
    graph stays valid (reference LoopClosing.cc:1097-1099 asserts)."""
    from multi_orbslam3_jax.collab.client import CollabClient
    from multi_orbslam3_jax.collab.server import CollabServer
    from multi_orbslam3_jax.collab.transport import InProcessTransport
    c = _small_config()
    F = 30
    seq0 = synthetic.make_sequence(c, n_frames=F, n_points=600, seed=11,
                                   trajectory="forward", phase=0.0)
    seq1 = synthetic.make_sequence(c, n_frames=F, n_points=600, seed=11,
                                   trajectory="forward", phase=0.35)
    tr = InProcessTransport()
    c0 = CollabClient(c, agent_id=0, transport=tr)
    c1 = CollabClient(c, agent_id=1, transport=tr)
    server = CollabServer(c, tr, n_agents=2, arena_kf=192, arena_mp=8192)
    merges_seen = 0
    for i in range(F):
        c0.process_frame(seq0.images[i], float(seq0.timestamps[i]))
        c1.process_frame(seq1.images[i], float(seq1.timestamps[i]))
        c0.comm_cycle()
        c1.comm_cycle()
        server.comm_cycle()
        if server.stats["merges"] > merges_seen or i % 8 == 7:
            merges_seen = server.stats["merges"]
            check_essential_graph(server.m, kf_map=server.kf_map)
    assert server.stats["merges"] >= 1
    check_essential_graph(server.m, kf_map=server.kf_map)
