"""Full-arena inertial GBA (round-4 VERDICT Missing #3 / Next #6).

The reference's post-loop/merge global BA on inertial maps is
Optimizer::FullInertialBA — ONE joint solve over ALL keyframes with
preintegration + reprojection factors (src/Optimizer.cc:449-517, invoked
from LoopClosing::RunGlobalBundleAdjustment, LoopClosing.cc:2619+). A
windowed sweep cannot redistribute error across a whole arc: each window
anchors on the (drifted) prefix and the local landmarks agree with the
local drift, so vision is locally happy and the global bend survives.
The IMU chain, being metric and gravity-aligned, DOES observe the bend.

Drill: a 56-KF single-agent inertial arena whose poses and landmarks
carry a self-consistent accumulated yaw drift (observations rendered
from the drifted geometry — vision alone cannot detect it), with
preintegration windows computed from the TRUE motion. The full joint
solve must recover most of the drift; the windowed pass must not.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.collab.server import CollabServer
from multi_orbslam3_jax.collab.transport import InProcessTransport
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.eval import ate
from multi_orbslam3_jax.imu import preintegration as pre


def _config():
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(
        orb=cfg.ORBConfig(n_features=128, n_levels=4),
        map=cfg.MapConfig(max_keyframes=64, max_mappoints=2048,
                          max_obs=16384, max_obs_per_kf=128),
        local_mapping=cfg.LocalMappingConfig(
            local_ba_kfs=8, local_ba_fixed_kfs=4, local_ba_points=1024),
    )


def _build_drifted_arena(c, F=56, n_pts=800, seed=11,
                         yaw_drift_per_kf=np.deg2rad(0.35)):
    """Server arena with self-consistently drifted poses+landmarks and
    TRUE-motion preintegration rows."""
    rng = np.random.RandomState(seed)
    seq = synthetic.make_sequence(c, n_frames=F, n_points=n_pts,
                                  seed=seed, trajectory="circle",
                                  imu=True, arc=1.2 * np.pi)
    K = np.array([[c.camera.fx, 0, c.camera.cx],
                  [0, c.camera.fy, c.camera.cy], [0, 0, 1.0]])
    T_gt = np.asarray(seq.T_cw, np.float64)
    pts_w = None
    # world landmarks: re-sample the generator's world
    pts_w, _ = synthetic.make_world(n_pts, seed)

    # accumulated yaw drift: warp pose i by W_i (world-frame yaw about
    # the trajectory centroid), landmarks ride their reference keyframe
    centers_gt = ate.camera_centers(T_gt)
    pivot = centers_gt.mean(0)

    def warp(i):
        th = yaw_drift_per_kf * i
        R = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
        W = np.eye(4)
        W[:3, :3] = R
        W[:3, 3] = pivot - R @ pivot
        return W

    T_drift = np.stack([T_gt[i] @ np.linalg.inv(warp(i))
                        for i in range(F)])

    N = c.orb.n_features
    m_kf_uv = np.zeros((F, N, 2), np.float32)
    m_kf_mp = np.full((F, N), -1, np.int32)
    m_feat_ok = np.zeros((F, N), bool)
    mp_ref = np.full(n_pts, -1, np.int32)
    # assign each landmark's reference KF = first KF that sees it
    for i in range(F):
        pc = pts_w @ T_gt[i, :3, :3].T + T_gt[i, :3, 3]
        uv = (pc @ K.T)
        z = uv[:, 2]
        uv = uv[:, :2] / np.maximum(z[:, None], 1e-6)
        vis = (z > 0.2) & (uv[:, 0] >= 4) & (uv[:, 0] < c.camera.width - 4) \
            & (uv[:, 1] >= 4) & (uv[:, 1] < c.camera.height - 4)
        cand = np.nonzero(vis)[0]
        rng.shuffle(cand)
        cand = cand[:N]
        mp_ref[cand[mp_ref[cand] < 0]] = i
        for f, j in enumerate(cand):
            m_kf_mp[i, f] = j
            m_feat_ok[i, f] = True
    # drifted landmark positions: p' = T'_ref^-1 (T_ref p)
    ref_ok = mp_ref >= 0
    ref_safe = np.maximum(mp_ref, 0)
    x_cam = np.einsum("kij,kj->ki", T_gt[ref_safe][:, :3, :3], pts_w) \
        + T_gt[ref_safe][:, :3, 3]
    p_drift = np.einsum(
        "kij,kj->ki",
        np.linalg.inv(T_drift[ref_safe])[:, :3, :3], x_cam) \
        + np.linalg.inv(T_drift[ref_safe])[:, :3, 3]
    p_drift = np.where(ref_ok[:, None], p_drift, 0.0)
    # observations from the TRUE geometry (+0.5 px noise): the drifted
    # STATE disagrees with them, like a real post-loop arena. The
    # windowed pass (pinned landmarks, drifted anchors) cannot recover —
    # each window just re-fits poses to the drifted landmark field — but
    # the full joint solve with free landmarks + IMU factors can.
    for i in range(F):
        sel = m_kf_mp[i] >= 0
        j = m_kf_mp[i][sel]
        pc = pts_w[j] @ T_gt[i, :3, :3].T + T_gt[i, :3, 3]
        uv = pc @ K.T
        m_kf_uv[i][sel] = (
            uv[:, :2] / np.maximum(uv[:, 2:3], 1e-6)
            + rng.normal(0.0, 0.5, (len(j), 2))).astype(np.float32)

    tr = InProcessTransport()
    server = CollabServer(c, tr, n_agents=1)
    m = server.m
    ts = np.asarray(seq.timestamps, np.float64)
    ts = (ts - ts[0]).astype(np.float32)
    m = m._replace(
        kf_pose=m.kf_pose.at[:F].set(jnp.asarray(T_drift, jnp.float32)),
        kf_valid=m.kf_valid.at[:F].set(True),
        kf_timestamp=m.kf_timestamp.at[:F].set(jnp.asarray(ts)),
        kf_agent=m.kf_agent.at[:F].set(0),
        kf_parent=m.kf_parent.at[1:F].set(
            jnp.arange(F - 1, dtype=jnp.int32)),
        kf_uv=m.kf_uv.at[:F].set(jnp.asarray(m_kf_uv)),
        kf_feat_valid=m.kf_feat_valid.at[:F].set(jnp.asarray(m_feat_ok)),
        kf_mp=m.kf_mp.at[:F].set(jnp.asarray(m_kf_mp)),
        mp_pos=m.mp_pos.at[:n_pts].set(jnp.asarray(p_drift, jnp.float32)),
        mp_valid=m.mp_valid.at[:n_pts].set(jnp.asarray(ref_ok)),
        mp_ref_kf=m.mp_ref_kf.at[:n_pts].set(jnp.asarray(mp_ref)),
        mp_agent=m.mp_agent.at[:n_pts].set(0),
        n_kf=jnp.int32(F), n_mp=jnp.int32(n_pts))
    server.m = m
    server.kf_map[:F] = 0
    server.mp_map[:n_pts] = 0
    server.kf_local[:F] = np.arange(F)
    book = server.agents[0]
    book.inertial = True
    book.map_id = 0
    book.last_kf_slot = F - 1
    book.kf_l2s = {i: i for i in range(F)}
    # TRUE-motion preintegration windows constructed EXACTLY from the
    # ground-truth states (inverse of the residual model: dR = R_i^T R_j,
    # dV = R_i^T (v_j - v_i - g dt), dP = R_i^T (p_j - p_i - v_i dt -
    # 0.5 g dt^2)) with realistic covariances. Integrating the rendered
    # IMU stream instead leaves O(dt^2) model error that the whitened
    # information (~1e6) amplifies into factors that FIGHT the (exact)
    # visual evidence — the drill must measure the solver, not the
    # generator's integration accuracy.
    centers = ate.camera_centers(T_gt)
    g_vec = np.array([0.0, 0.0, -float(c.imu.gravity)])
    ts64 = np.asarray(ts, np.float64)
    dt_f = np.diff(ts64)
    R_wb = np.linalg.inv(T_gt)[:, :3, :3]      # T_bc = identity
    vel = np.gradient(centers, axis=0) / np.gradient(ts64)[:, None]
    cov = np.diag([1e-4] * 3 + [2.5e-3] * 3 + [1e-3] * 3)
    for i in range(1, F):
        dt = float(dt_f[i - 1])
        Ri = R_wb[i - 1]
        dR = Ri.T @ R_wb[i]
        dV = Ri.T @ (vel[i] - vel[i - 1] - g_vec * dt)
        dP = Ri.T @ (centers[i] - centers[i - 1] - vel[i - 1] * dt
                     - 0.5 * g_vec * dt * dt)
        p = pre.empty_preintegrated()
        p = p._replace(dR=jnp.asarray(dR, jnp.float32),
                       dV=jnp.asarray(dV, jnp.float32),
                       dP=jnp.asarray(dP, jnp.float32),
                       dT=jnp.float32(dt),
                       cov=jnp.asarray(cov, jnp.float32))
        server.kf_imu[i, :pre.FLAT_DIM] = pre.preint_to_flat(p)
        server.kf_imu[i, pre.FLAT_DIM:] = vel[i]
    server.kf_imu[0, pre.FLAT_DIM:] = vel[0]
    return server, T_gt, seq


def _arena_ate(server, T_gt, F):
    est = ate.camera_centers(np.array(server.m.kf_pose[:F]))
    gt = ate.camera_centers(T_gt)
    return ate.ate_rmse(est, gt, with_scale=False)


@pytest.mark.slow
def test_full_inertial_gba_beats_windowed():
    c = _config()
    F = 56
    server, T_gt, _ = _build_drifted_arena(c, F=F)
    ate0 = _arena_ate(server, T_gt, F)
    assert ate0 > 0.10, f"drill produced no drift (ate0={ate0:.3f})"

    # windowed pass (pinned landmarks) first: cannot undo arc-wide
    # drift. Snapshot/restore the solver-visible state around it (the
    # server object holds unpicklable transport handles).
    snap_m, snap_imu = server.m, server.kf_imu.copy()
    n_w = server.run_inertial_refinement()
    assert n_w > 0
    ate_w = _arena_ate(server, T_gt, F)
    server.m, server.kf_imu = snap_m, snap_imu

    # full joint solve (FullInertialBA analog)
    n_f = server.run_full_inertial_ba(iters=12)
    assert n_f == 1
    ate_f = _arena_ate(server, T_gt, F)

    assert ate_f < 0.6 * ate0, (
        f"full inertial GBA did not reduce drift: {ate0:.3f} -> {ate_f:.3f}")
    assert ate_f < 0.8 * ate_w, (
        f"full solve ({ate_f:.3f}) must beat windowed ({ate_w:.3f}); "
        f"drift before: {ate0:.3f}")
