"""Global-BA measurement on a synthetic server arena.

``make_server_arena`` builds a geometrically consistent multi-agent map
in the CollabServer's real state layout; ``measure_gba`` times
CollabServer.run_global_ba on it, on one device or with the
observations sharded over every visible device (``distributed=True``).
The ``gba_large`` bench cell and ``chip_smoke.py`` (and its ``--four``
comparison) use both.
"""

from __future__ import annotations

import time


def make_server_arena(n_kf: int = 48, n_mp: int = 3072, n_feat: int = 256,
                      n_agents: int = 2, seed: int = 0):
    """A CollabServer whose arena holds a consistent multi-agent map:
    KF poses along a path, landmarks in front, kf_uv = true projections,
    kf_mp associations filled — run_global_ba sees its real data layout."""
    import jax.numpy as jnp
    import numpy as np

    from multi_orbslam3_jax import config as cfg
    from multi_orbslam3_jax.collab.server import CollabServer
    from multi_orbslam3_jax.collab.transport import InProcessTransport
    from multi_orbslam3_jax.geometry import camera as cam
    from multi_orbslam3_jax.geometry import se3

    rng = np.random.RandomState(seed)
    c = cfg.synthetic_mono().replace(
        orb=cfg.ORBConfig(n_features=n_feat),
        map=cfg.MapConfig(max_keyframes=n_kf, max_mappoints=n_mp,
                          max_obs_per_kf=n_feat))
    server = CollabServer(c, InProcessTransport(), n_agents=n_agents,
                          arena_kf=n_kf, arena_mp=n_mp)
    K = server.K
    # landmarks spread ALONG the trajectory (cameras advance 0.15/KF in
    # x): a fixed box leaves large arenas with near-zero observation
    # density past the first ~50 keyframes
    # camera CENTER is -R^T t: with t_x = +0.15k the centers march in
    # NEGATIVE x
    x_span = 4.0 + 0.15 * n_kf
    pts = np.stack([rng.uniform(-x_span, 4, n_mp),
                    rng.uniform(-2, 2, n_mp),
                    rng.uniform(4, 10, n_mp)], 1).astype(np.float32)
    # bounded attitude wobble: an unbounded 0.01*k yaw had large arenas
    # pointing away from the landmark field entirely
    poses = np.stack([np.asarray(se3.exp(jnp.asarray(
        [0.0, 0.08 * np.sin(k / 7.0), 0.0,
         0.15 * k, 0.02 * (k % 3), 0.0],
        jnp.float32))) for k in range(n_kf)])
    kf_mp = np.full((n_kf, n_feat), -1, np.int32)
    kf_uv = np.zeros((n_kf, n_feat, 2), np.float32)
    feat_valid = np.zeros((n_kf, n_feat), bool)
    order = np.argsort(pts[:, 0])
    px_sorted = pts[order, 0]
    for k in range(n_kf):
        # candidate landmarks near this camera's x (frustum prefilter —
        # a whole-arena random sample leaves big arenas nearly obs-free)
        xk = -0.15 * k
        lo, hi = np.searchsorted(px_sorted, (xk - 8.0, xk + 8.0))
        cand = order[lo:hi]
        if len(cand) < n_feat:
            cand = order[max(0, lo - n_feat):hi + n_feat]
        vis = rng.choice(cand, min(n_feat, len(cand)), replace=False)
        if len(vis) < n_feat:
            vis = np.concatenate([vis, rng.choice(n_mp, n_feat - len(vis))])
        p_c = pts[vis] @ poses[k][:3, :3].T + poses[k][:3, 3]
        uv = np.stack([float(K.fx) * p_c[:, 0] / p_c[:, 2] + float(K.cx),
                       float(K.fy) * p_c[:, 1] / p_c[:, 2] + float(K.cy)],
                      1)
        ok = (p_c[:, 2] > 0.3) & (uv[:, 0] > 0) & (uv[:, 0] < 640) \
            & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        kf_mp[k, ok] = vis[ok]
        kf_uv[k] = uv + rng.randn(n_feat, 2) * 0.5
        feat_valid[k] = ok
    agents = np.arange(n_kf) % n_agents
    server.m = server.m._replace(
        kf_pose=jnp.asarray(poses), kf_valid=jnp.ones(n_kf, bool),
        kf_agent=jnp.asarray(agents.astype(np.int32)),
        kf_uv=jnp.asarray(kf_uv), kf_mp=jnp.asarray(kf_mp),
        kf_feat_valid=jnp.asarray(feat_valid),
        n_kf=jnp.int32(n_kf),
        mp_pos=jnp.asarray(pts + rng.randn(n_mp, 3).astype(np.float32)
                           * 0.03),
        mp_valid=jnp.ones(n_mp, bool), n_mp=jnp.int32(n_mp))
    server.kf_map[:] = 0
    server.kf_local[:] = np.arange(n_kf)
    return server


def measure_gba(server, distributed: bool, iters: int = 4,
                cg_iters: int = 25):
    """Run ``server.run_global_ba`` once to compile (set-up), then again
    from the same arena, timed. Returns (report, poses, points): PCG
    iterations/s of the whole call, chi2 before/after the timed solve,
    and whether every pose and landmark came out finite."""
    import jax
    import numpy as np

    m0 = server.m
    walls = []
    for _ in range(2):
        server.m = m0
        t0 = time.perf_counter()
        server.run_global_ba(iters=iters, cg_iters=cg_iters,
                             distributed=distributed)
        jax.block_until_ready((server.m.kf_pose, server.m.mp_pos))
        walls.append(time.perf_counter() - t0)
    poses = np.asarray(server.m.kf_pose)
    points = np.asarray(server.m.mp_pos)
    chi2_in, chi2 = server.stats["gba_chi2"]
    report = {"gba_iters_per_s": round(iters * cg_iters / walls[1], 2),
              "wall_s": round(walls[1], 3),
              "setup_s": round(walls[0] - walls[1], 2),
              "pcg_iters": iters * cg_iters,
              "chi2_in": chi2_in, "chi2": chi2,
              "finite": bool(np.isfinite(poses).all()
                             and np.isfinite(points).all())}
    return report, poses, points
