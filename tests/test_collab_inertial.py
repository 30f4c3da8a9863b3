"""Inertial collaborative E2E: a mono-inertial agent + a mono agent
share one world through the server. Exercises the full distributed
visual-inertial ladder the reference runs for IMU_MONOCULAR clients:

- uplink gated until VI init stage 1 passes (Atlas::GetInertialBA1,
  reference Atlas.cc:134,155);
- IMU-init re-gauge shipped as scale/Rgw and applied server-side
  (Map::ApplyScaledRotation, Communicator.cc:240-252);
- cross-agent merge between a metric (inertial) and an up-to-scale
  (mono) sub-map;
- pose-locked corrections flowing back to both agents.
"""

import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.collab.client import CollabClient
from multi_orbslam3_jax.collab.server import CollabServer
from multi_orbslam3_jax.collab.transport import InProcessTransport
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate


def _config():
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        orb=cfg.ORBConfig(n_features=256, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048,
                          max_obs=16384, max_obs_per_kf=256),
        local_mapping=cfg.LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024,
            local_ba_iters=8),
        # short CI sequences never reach the production 12-KF maturity
        # gate; keep the machinery testable at small scale
        loop=cfg.LoopConfig(min_map_kfs=6, event_interval_kfs=2),
    )


@pytest.mark.slow
def test_inertial_agent_collaborates():
    c = _config()
    F = 70
    seq_vi = synthetic.make_sequence(c, n_frames=F, n_points=600, seed=31,
                                     trajectory="forward", imu=True,
                                     lateral=0.8, sway_freq=0.15)
    seq_mono = synthetic.make_sequence(c, n_frames=F, n_points=600, seed=31,
                                       trajectory="forward", phase=0.3,
                                       lateral=0.8, sway_freq=0.15)
    tr = InProcessTransport()
    cl_vi = CollabClient(c, 0, tr, inertial=True)
    cl_mono = CollabClient(c, 1, tr)
    server = CollabServer(c, tr, n_agents=2)

    sent_before_init = 0
    for i in range(F):
        dt = np.diff(seq_vi.imu_t[i], prepend=seq_vi.imu_t[i][0] - 1 / 200.0)
        dt = np.where(seq_vi.imu_t[i] > 0, np.maximum(dt, 0), 0)
        cl_vi.process_frame_imu(seq_vi.images[i],
                                float(seq_vi.timestamps[i]),
                                seq_vi.imu_acc[i], seq_vi.imu_gyro[i], dt)
        cl_mono.process_frame(seq_mono.images[i],
                              float(seq_mono.timestamps[i]))
        if not cl_vi.slam.inertial_ready:
            sent_before_init = cl_vi.stats["deltas_sent"]
        cl_vi.comm_cycle()
        cl_mono.comm_cycle()
        # GBA after loop/merge events, like the reference
        # (LoopClosing::RunGlobalBundleAdjustment); with a mixed
        # visual+inertial arena the GBA holds the metric agents' poses
        server.comm_cycle(run_gba_on_events=True)

    # the VIBA1 uplink gate held: nothing published before init
    assert cl_vi.slam.imu_initialized, cl_vi.slam.stats
    assert sent_before_init == 0
    assert cl_vi.stats["deltas_sent"] > 0
    # the server learned the agent is inertial and holds its keyframes
    assert server.agents[0].inertial
    assert server.stats["kf_ingested"] > 8
    n_vi_kf = sum(1 for s in np.asarray(server.m.kf_agent)[
        np.asarray(server.m.kf_valid)] if s == 0)
    assert n_vi_kf > 3
    # cross-agent merge between the inertial and mono sub-maps happened
    assert server.stats["merges"] >= 1, server.stats
    # corrections flowed back to both agents
    assert cl_vi.stats["corrections_applied"] > 0
    assert cl_mono.stats["corrections_applied"] > 0
    # accuracy: both agents near GT (post-init segment for the VI agent)
    init_f = cl_vi.slam.stats["imu_init_frame"] + 2
    est = np.stack([T for _, T in cl_vi.slam.trajectory])[init_f:]
    gt = seq_vi.T_cw[init_f:]
    rmse = ate.ate_rmse(ate.camera_centers(est), ate.camera_centers(gt))
    g = ate.camera_centers(gt)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    assert rmse < 0.12 * max(span, 1.0), (rmse, span)
    # gravity-gauge integrity THROUGH the merge + GBA + correction chain
    # (reference OptimizeEssentialGraph4DoF, Optimizer.cc:8430): the
    # init estimates gravity within a couple degrees on this synthetic
    # excitation; what the 4-DoF machinery must guarantee is that the
    # correction chain never TILTS the gauge further — the round-2
    # failure mode was a 5-6 degree jump landing with the corrections.
    z = np.array([0.0, 0.0, 1.0])
    tilts = []
    for T_e, T_g in zip(est, gt):
        a = T_e[:3, :3] @ z
        b = T_g[:3, :3] @ z
        cosang = np.clip(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)),
                         -1.0, 1.0)
        tilts.append(np.degrees(np.arccos(cosang)))
    tilts = np.asarray(tilts)
    assert float(tilts.mean()) < 3.0, (tilts.mean(), tilts.max())
    # no tilt JUMP through the correction/merge events: the late-segment
    # tilt stays within 1.5 deg of the early (near-init) tilt
    head = float(tilts[:8].mean())
    tail = float(tilts[-8:].mean())
    assert tail - head < 1.5, (head, tail)
    # the mono agent's per-frame log spans two gauges (its map was pulled
    # to metric scale at the merge and its live frame re-based — the
    # client-side correction propagation), so evaluate the POST-merge
    # segment. The merge fires right after the VI agent's IMU init (both
    # agents see the same world), and the downlink lands one frame later
    # — anchor the window to the init frame, not a fixed index.
    start = max(50, init_f + 4)
    est_m = np.stack([T for _, T in cl_mono.slam.trajectory])[start:]
    gt_m = seq_mono.T_cw[start:]
    rmse_m = ate.ate_rmse(ate.camera_centers(est_m),
                          ate.camera_centers(gt_m))
    assert rmse_m < 0.12 * max(span, 1.0), rmse_m


@pytest.mark.slow
def test_preintegration_uplink_and_server_inertial_ba():
    """The preintegration uplink (reference ships mpImuPreintegrated +
    velocity inside KF messages) and its three server consumers:
    chain bookkeeping, MergePrevious-on-erase (Communicator.cc:319-341),
    and the FullInertialBA analog (Optimizer.cc:449)."""
    from multi_orbslam3_jax.imu import preintegration as pre

    c = _config()
    F = 60
    seq = synthetic.make_sequence(c, n_frames=F, n_points=600, seed=7,
                                  trajectory="forward", imu=True,
                                  lateral=0.8, sway_freq=0.15)
    tr = InProcessTransport()
    cl = CollabClient(c, 0, tr, inertial=True)
    server = CollabServer(c, tr, n_agents=1)
    for i in range(F):
        dt = np.diff(seq.imu_t[i], prepend=seq.imu_t[i][0] - 1 / 200.0)
        dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0), 0)
        cl.process_frame_imu(seq.images[i], float(seq.timestamps[i]),
                             seq.imu_acc[i], seq.imu_gyro[i], dt)
        cl.comm_cycle()
        server.comm_cycle()

    # T_bc reached the server (non-identity in the synthetic config)
    assert server.agents[0].T_bc is not None
    np.testing.assert_allclose(server.agents[0].T_bc,
                               np.asarray(cl.slam.T_bc), atol=1e-6)
    valid = np.asarray(server.m.kf_valid)
    own = np.nonzero(valid & (np.asarray(server.m.kf_agent) == 0))[0]
    assert len(own) >= 4
    # every non-first own keyframe carries a preintegration window whose
    # span matches the keyframe timestamp gap
    ts = np.asarray(server.m.kf_timestamp)[own]
    dts = server.kf_imu[own, pre.FLAT_DT]
    assert np.all(dts[1:] > 0), dts
    np.testing.assert_allclose(dts[1:], np.diff(ts), atol=2e-2)
    # velocities uplinked alongside
    assert np.any(np.abs(server.kf_imu[own[1:], pre.FLAT_DIM:]) > 1e-3)

    # MergePrevious on erasure: fold a middle keyframe's window into its
    # successor; the successor's span becomes the sum of both
    mid = int(own[2])
    nxt = int(own[3])
    span_before = float(server.kf_imu[nxt, pre.FLAT_DT])
    erased_span = float(server.kf_imu[mid, pre.FLAT_DT])
    server._merge_preint_forward(mid, 0)
    assert float(server.kf_imu[mid, pre.FLAT_DT]) == 0.0
    np.testing.assert_allclose(float(server.kf_imu[nxt, pre.FLAT_DT]),
                               span_before + erased_span, atol=1e-5)
    # restore for the BA below (re-split is impossible; just re-run on the
    # merged chain — the pair mid->nxt is simply wider now)
    server.m = server.m._replace(
        kf_valid=server.m.kf_valid.at[mid].set(False))

    # FullInertialBA analog: windows sweep the chain and keep the map
    # consistent with ground truth
    pose_before = np.asarray(server.m.kf_pose)
    n_win = server.run_inertial_refinement()
    assert n_win >= 1
    pose_after = np.asarray(server.m.kf_pose)
    assert np.all(np.isfinite(pose_after[own[own != mid]]))
    # accuracy preserved (or improved) vs ground truth keyframe poses
    from multi_orbslam3_jax.eval import ate as ate_m
    kf_ts = np.asarray(server.m.kf_timestamp)[own[own != mid]]
    idx = [int(np.argmin(np.abs(np.asarray(seq.timestamps) - t)))
           for t in kf_ts]
    gt_c = ate_m.camera_centers(seq.T_cw[idx])
    for est in (pose_before, pose_after):
        c_est = ate_m.camera_centers(est[own[own != mid]])
        r = ate_m.ate_rmse(c_est, gt_c)
        span = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
        assert r < 0.15 * max(span, 1.0), r
