"""Bench-scale collaborative accuracy regression (round-3 VERDICT Next
#3): at 150-frame bench scale, agent1's final server trajectory was
3.59 m off over a 10.8 m span while unit-scale collab tests passed —
merge + pose graph + GBA + culling + pose-locking only interacted
wrongly at scale. This drill reproduces the bench shape (circular arcs
with phase offsets, merges, GBA on events, culling on) at CI-feasible
size and gates EACH agent's server-arena keyframe trajectory at the
bench criterion: ATE < 0.02 x span (reference evaluation protocol,
src/ServerSystem.cc:134-185)."""

import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.collab.client import CollabClient
from multi_orbslam3_jax.collab.server import CollabServer
from multi_orbslam3_jax.collab.transport import InProcessTransport
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate


@pytest.mark.slow
def test_two_agent_server_trajectory_accuracy():
    # small capacities but the TRAINED 10k-word vocabulary: the 216-word
    # toy tree lacks the discrimination to fire cross-agent merges
    # reliably on this geometry
    c = cfg.small_synthetic().replace(bow=cfg.BoWConfig(10, 4))
    n_agents, n_frames = 2, 112
    seqs = [synthetic.make_sequence(c, n_frames=n_frames, n_points=900,
                                    seed=31, trajectory="circle",
                                    phase=1.1 + 0.55 * a,
                                    arc=1.8 * np.pi)
            for a in range(n_agents)]
    tr = InProcessTransport()
    clients = [CollabClient(c, a, tr) for a in range(n_agents)]
    server = CollabServer(c, tr, n_agents=n_agents)
    for i in range(n_frames):
        for a, cl in enumerate(clients):
            cl.process_frame(seqs[a].images[i], float(seqs[a].timestamps[i]))
            cl.comm_cycle()
        server.comm_cycle()
    server.drain_gba()

    assert server.stats["merges"] >= 1, server.stats
    # each agent's final server keyframe trajectory within 2% of span
    ts_all = np.asarray(seqs[0].timestamps)
    ts_all = ts_all - ts_all[0]
    kf_valid = np.array(server.m.kf_valid)
    kf_agent = np.array(server.m.kf_agent)
    kf_ts = np.array(server.m.kf_timestamp)
    kf_pose = np.array(server.m.kf_pose)
    for a in range(n_agents):
        sel = np.nonzero(kf_valid & (kf_agent == a))[0]
        assert len(sel) >= 8, (a, len(sel))
        fr = np.asarray([int(np.argmin(np.abs(ts_all - t)))
                         for t in kf_ts[sel]])
        est = ate.camera_centers(kf_pose[sel])
        gt = ate.camera_centers(seqs[a].T_cw[fr])
        span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
        rmse = ate.ate_rmse(est, gt)
        # bench criterion: ATE < 0.02 x span per agent. Standalone mono
        # on this generator/config runs at 0.012-0.020 x span, and the
        # full collaborative chain (cross-agent association uplink,
        # whole-overlap SearchAndFuse, landmark pose locks, post-GBA
        # outlier-KF culling) measures 0.013-0.015 x span — collaboration
        # must not degrade the standalone accuracy.
        assert rmse < 0.02 * max(span, 1.0), (
            f"agent{a} server-trajectory ATE {rmse:.3f} over span "
            f"{span:.2f} (gate 0.02 x span); stats={server.stats}")
