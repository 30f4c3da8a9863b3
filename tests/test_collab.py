import numpy as np
import jax.numpy as jnp
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.collab import protocol
from multi_orbslam3_jax.collab.client import CollabClient
from multi_orbslam3_jax.collab.server import CollabServer
from multi_orbslam3_jax.collab.transport import (InProcessTransport,
                                                 SocketTransportClient,
                                                 SocketTransportServer)
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate


def small_config():
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048, max_obs=16384,
                          max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(local_ba_kfs=8, local_ba_fixed_kfs=4,
                                             local_ba_points=1024,
                                             local_ba_iters=8),
        bow=cfg.BoWConfig(branching=6, levels=3),
        # short CI sequences never reach the production 12-KF maturity gate
        loop=cfg.LoopConfig(min_map_kfs=6, event_interval_kfs=2),
    )


class TestProtocol:
    def test_roundtrip(self):
        rng = np.random.RandomState(0)
        kfs = protocol.KFPayload(
            agent=2, local_id=np.arange(3, dtype=np.int32),
            timestamp=np.arange(3.0),
            ref_ids=np.full((3, 3), -1, np.int32),
            T_rel=np.zeros((3, 3, 4, 4), np.float32),
            T_abs=np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
            is_first=np.asarray([True, False, False]),
            uv=rng.rand(3, 8, 2).astype(np.float32),
            desc=rng.randint(0, 2**32, (3, 8, 8), dtype=np.uint32),
            level=np.zeros((3, 8), np.int32),
            angle=np.zeros((3, 8), np.float32),
            feat_valid=np.ones((3, 8), bool),
            mp_local=np.full((3, 8), -1, np.int32))
        delta = protocol.MapDelta(agent=2, seq=5, kfs=kfs, closest_kf=1)
        data = delta.to_bytes()
        out = protocol.MapDelta.from_bytes(data)
        assert out.agent == 2 and out.seq == 5 and out.closest_kf == 1
        np.testing.assert_array_equal(out.kfs.desc, kfs.desc)
        np.testing.assert_array_equal(out.kfs.local_id, kfs.local_id)
        assert out.mps is None

    def test_socket_transport(self):
        srv = SocketTransportServer()
        cli = SocketTransportClient(agent=1, host="127.0.0.1", port=srv.port)
        cli.send_up(1, b"hello-up")
        import time
        for _ in range(100):
            msgs = srv.poll_up(1)
            if msgs:
                break
            time.sleep(0.01)
        assert msgs == [b"hello-up"]
        srv.send_down(1, b"hello-down")
        for _ in range(100):
            msgs = cli.poll_down(1)
            if msgs:
                break
            time.sleep(0.01)
        assert msgs == [b"hello-down"]
        cli.close()
        srv.close()


@pytest.mark.slow
class TestCollabSingleAgent:
    def test_server_mirrors_client_map(self):
        c = small_config()
        seq = synthetic.make_sequence(c, n_frames=25, n_points=500, seed=7,
                                      trajectory="forward")
        tr = InProcessTransport()
        client = CollabClient(c, agent_id=0, transport=tr)
        server = CollabServer(c, tr, n_agents=1, arena_kf=128, arena_mp=4096)
        for i in range(seq.images.shape[0]):
            client.process_frame(seq.images[i], float(seq.timestamps[i]))
            client.comm_cycle()
            server.comm_cycle()
        n_client_kf = int(client.slam.m.n_kf)
        assert server.stats["kf_ingested"] == n_client_kf
        assert server.stats["mp_ingested"] > 50
        assert server.stats["dropped_kf"] == 0
        # server poses should match client poses (no corrections happened)
        book = server.agents[0]
        for lid, slot in book.kf_l2s.items():
            np.testing.assert_allclose(
                np.array(server.m.kf_pose[slot]),
                np.array(client.slam.m.kf_pose[lid]), atol=4e-2)
        # associations landed
        n_assoc = int(jnp.sum(server.m.kf_mp >= 0))
        assert n_assoc > 100, f"only {n_assoc} associations on server"


@pytest.mark.slow
class TestCollabTwoAgents:
    def test_cross_agent_merge(self):
        c = small_config()
        # two agents traverse the SAME world with a time offset so their
        # fields of view overlap
        seq0 = synthetic.make_sequence(c, n_frames=30, n_points=600, seed=11,
                                       trajectory="forward", phase=0.0)
        seq1 = synthetic.make_sequence(c, n_frames=30, n_points=600, seed=11,
                                       trajectory="forward", phase=0.35)
        tr = InProcessTransport()
        c0 = CollabClient(c, agent_id=0, transport=tr)
        c1 = CollabClient(c, agent_id=1, transport=tr)
        server = CollabServer(c, tr, n_agents=2, arena_kf=192, arena_mp=8192)
        for i in range(30):
            c0.process_frame(seq0.images[i], float(seq0.timestamps[i]))
            c1.process_frame(seq1.images[i], float(seq1.timestamps[i]))
            c0.comm_cycle()
            c1.comm_cycle()
            server.comm_cycle()
        assert server.stats["kf_ingested"] > 10
        # both agents contributed
        agents_present = set(
            np.array(server.m.kf_agent)[np.array(server.m.kf_valid)])
        assert agents_present == {0, 1}
        # the shared world should trigger a cross-agent merge
        assert server.stats["merges"] >= 1, \
            f"no merge happened: {server.stats}"
        # after merge every valid KF is in one sub-map
        valid = np.array(server.m.kf_valid)
        maps = set(server.kf_map[valid])
        assert len(maps) == 1, f"sub-maps after merge: {maps}"
        # corrections flowed back to clients
        total_corr = (c0.stats["corrections_applied"]
                      + c1.stats["corrections_applied"])
        assert total_corr > 0


class TestInertialUplink:
    def test_gauge_handoff(self):
        # server re-gauges its copy of an agent's sub-map when the delta
        # carries mScale/mRgw (Communicator::RunServer ApplyScaledRotation)
        c = small_config()
        tr = InProcessTransport()
        server = CollabServer(c, tr, n_agents=1, arena_kf=32, arena_mp=256)
        n = c.orb.n_features
        rng = np.random.RandomState(5)
        kfs = protocol.KFPayload(
            agent=0, local_id=np.asarray([0], np.int32),
            timestamp=np.asarray([0.0]),
            ref_ids=np.full((1, 3), -1, np.int32),
            T_rel=np.zeros((1, 3, 4, 4), np.float32),
            T_abs=np.eye(4, dtype=np.float32)[None],
            is_first=np.asarray([True]),
            uv=rng.rand(1, n, 2).astype(np.float32) * 100,
            desc=rng.randint(0, 2**32, (1, n, 8), dtype=np.uint32),
            level=np.zeros((1, n), np.int32),
            angle=np.zeros((1, n), np.float32),
            feat_valid=np.ones((1, n), bool),
            mp_local=np.full((1, n), -1, np.int32))
        mps = protocol.MPPayload(
            agent=0, local_id=np.asarray([0], np.int32),
            ref_kf_local=np.asarray([-1], np.int32),
            pos_rel=np.zeros((1, 3), np.float32),
            pos_abs=np.asarray([[1.0, 2.0, 3.0]], np.float32),
            desc=rng.randint(0, 2**32, (1, 8), dtype=np.uint32))
        tr.send_up(0, protocol.MapDelta(agent=0, seq=1, kfs=kfs, mps=mps,
                                        inertial=True).to_bytes())
        server.comm_cycle()
        assert server.stats["kf_ingested"] == 1
        assert server.agents[0].inertial
        # now the gauge event: scale 2, identity rotation
        tr.send_up(0, protocol.MapDelta(
            agent=0, seq=2, scale=2.0,
            R_gw=np.eye(3, dtype=np.float32), inertial=True).to_bytes())
        server.comm_cycle()
        assert server.stats.get("gauge_applied", 0) == 1
        slot = server.agents[0].mp_l2s[0]
        np.testing.assert_allclose(np.array(server.m.mp_pos[slot]),
                                   [2.0, 4.0, 6.0], atol=1e-5)
        kslot = server.agents[0].kf_l2s[0]
        # T_cw' = [R, s*t] gauge update keeps the camera seeing the same
        # (rescaled) scene: translation doubles with identity R/t=0 -> stays 0
        np.testing.assert_allclose(np.array(server.m.kf_pose[kslot]),
                                   np.eye(4), atol=1e-5)


@pytest.mark.slow
class TestCrossAgentDownlink:
    def test_client_tracks_foreign_landmarks(self):
        """VERDICT #2 done-criterion: after the server merges two agents'
        maps, the vicinity downlink ships agent A's keyframes/landmarks to
        agent B (full payloads, server identity), B ingests them, and B's
        live tracking locks onto A's landmarks (reference
        Map::PackVicinityToMsg2 + ProcessKfInClient,
        src/Map.cc:935-1042, src/Communicator.cc:1324-1477)."""
        c = small_config()
        seq0 = synthetic.make_sequence(c, n_frames=32, n_points=600, seed=11,
                                       trajectory="forward", phase=0.0)
        seq1 = synthetic.make_sequence(c, n_frames=32, n_points=600, seed=11,
                                       trajectory="forward", phase=0.35)
        tr = InProcessTransport()
        c0 = CollabClient(c, agent_id=0, transport=tr)
        c1 = CollabClient(c, agent_id=1, transport=tr)
        server = CollabServer(c, tr, n_agents=2, arena_kf=192, arena_mp=8192)
        for i in range(32):
            c0.process_frame(seq0.images[i], float(seq0.timestamps[i]))
            c1.process_frame(seq1.images[i], float(seq1.timestamps[i]))
            c0.comm_cycle()
            c1.comm_cycle()
            server.comm_cycle()
        assert server.stats["merges"] >= 1, f"no merge: {server.stats}"
        # foreign content reached at least one client
        total_fkf = c0.stats["foreign_kf"] + c1.stats["foreign_kf"]
        total_fmp = c0.stats["foreign_mp"] + c1.stats["foreign_mp"]
        assert total_fkf > 0, "no foreign keyframes downlinked"
        assert total_fmp > 0, "no foreign landmarks downlinked"
        # live tracking locked onto the other agent's landmarks
        # (mp_found counts inlier associations, MapPoint::IncreaseFound)
        found = 0
        for cl in (c0, c1):
            f = np.array(cl.slam.m.mp_found)
            found += int(f[cl._is_foreign_mp].sum())
        assert found > 0, "clients never tracked foreign landmarks"
        # foreign entities were NOT re-uplinked as the client's own: every
        # server-side mapping points at a LIVE landmark, and any mapping
        # whose owner differs went through fusion forwarding (the
        # reference's MapPoint::Replace moves observers' pointers to the
        # survivor, which may belong to another client) — never through a
        # duplicate ingest.
        n_cross = 0
        for a, book in server.agents.items():
            own = np.asarray(sorted(book.mp_l2s.values()))
            if len(own):
                owners = np.array(server.m.mp_agent)[own]
                valid = np.array(server.m.mp_valid)[own]
                n_cross += int(np.sum(owners[valid] != a))
        assert n_cross == 0 or server.stats.get("xfuse_mp", 0) > 0, (
            "cross-owner local-id mappings without any fusion event",
            n_cross, server.stats)


class LossyTransport(InProcessTransport):
    """Drops and reorders a fraction of payloads in both directions —
    the chaos harness for the ack/resend + reorder-buffer machinery."""

    def __init__(self, drop=0.2, reorder=0.2, seed=0):
        super().__init__()
        self.rng = np.random.RandomState(seed)
        self.drop = drop
        self.reorder = reorder
        self._delay_up = {}    # agent -> [payload]
        self._delay_down = {}

    def send_up(self, agent, payload):
        if self.rng.rand() < self.drop:
            return
        if self.rng.rand() < self.reorder:
            self._delay_up.setdefault(agent, []).append(payload)
            return
        super().send_up(agent, payload)
        for p in self._delay_up.pop(agent, []):   # delayed -> out of order
            super().send_up(agent, p)

    def send_down(self, agent, payload):
        if self.rng.rand() < self.drop:
            return
        if self.rng.rand() < self.reorder:
            self._delay_down.setdefault(agent, []).append(payload)
            return
        super().send_down(agent, payload)
        for p in self._delay_down.pop(agent, []):
            super().send_down(agent, p)


@pytest.mark.slow
class TestMessageLossChaos:
    def test_two_agent_run_survives_20pct_loss(self):
        """VERDICT #10 done-criterion: drop/reorder 20% of deltas both
        ways; the 2-agent run still converges — resends recover dropped
        full payloads, the reorder buffer restores in-order ingest, and
        tombstones keep late messages harmless (reference Map.cc:185-236,
        Communicator.h:162-165)."""
        c = small_config()
        seq0 = synthetic.make_sequence(c, n_frames=30, n_points=600, seed=11,
                                       trajectory="forward", phase=0.0)
        seq1 = synthetic.make_sequence(c, n_frames=30, n_points=600, seed=11,
                                       trajectory="forward", phase=0.35)
        tr = LossyTransport(drop=0.2, reorder=0.2, seed=3)
        c0 = CollabClient(c, agent_id=0, transport=tr)
        c1 = CollabClient(c, agent_id=1, transport=tr)
        server = CollabServer(c, tr, n_agents=2, arena_kf=192, arena_mp=8192)
        for i in range(30):
            c0.process_frame(seq0.images[i], float(seq0.timestamps[i]))
            c1.process_frame(seq1.images[i], float(seq1.timestamps[i]))
            c0.comm_cycle()
            c1.comm_cycle()
            server.comm_cycle()
        # a few extra comm-only cycles drain resends
        for _ in range(12):
            c0.comm_cycle()
            c1.comm_cycle()
            server.comm_cycle()
        assert c0.stats["resends"] + c1.stats["resends"] > 0, \
            "chaos harness never triggered a resend"
        # server eventually ingested (almost) all keyframes of both agents
        n_kf_clients = sum(
            int(np.sum(~cl._is_foreign_kf[:int(cl.slam.m.n_kf)]))
            for cl in (c0, c1))
        assert server.stats["kf_ingested"] >= n_kf_clients - 2, \
            (server.stats["kf_ingested"], n_kf_clients)
        assert server.stats["merges"] >= 1, f"no merge: {server.stats}"
        # no corruption: every arena pose finite, no duplicate ingest
        assert bool(jnp.all(jnp.isfinite(server.m.kf_pose)))
        for cl in (c0, c1):
            book = server.agents[cl.agent]
            slots = list(book.kf_l2s.values())
            assert len(slots) == len(set(slots)), "duplicate KF ingest"
