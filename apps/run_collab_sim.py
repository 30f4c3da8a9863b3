#!/usr/bin/env python
"""N-agent collaborative run in one process (in-process transport).

Replaces the reference's multi-launch topology (launch_server.sh +
launch_client_*.sh playing rosbags into N client processes +
Server_euroc.launch): all agents traverse one shared synthetic world with
phase-offset trajectories, the server fuses their maps, and the report
carries per-agent ATE plus server fusion statistics. This is the 2-agent
collaborative configuration of BASELINE.json run end-to-end.

Usage:
    python apps/run_collab_sim.py --out /tmp/collab --agents 2 --frames 40
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--gba", action="store_true",
                    help="run server global BA after merge events")
    ap.add_argument("--inertial", default="",
                    help="comma-separated agent ids running mono-inertial "
                         "(the reference's IMU_MONOCULAR collab mode)")
    ap.add_argument("--plot", action="store_true",
                    help="also write a top-down map PNG (needs matplotlib)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    from multi_orbslam3_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    inertial_ids = {int(x) for x in args.inertial.split(",") if x != ""}

    import numpy as np

    from multi_orbslam3_jax import config as cfg
    from multi_orbslam3_jax.collab.client import CollabClient
    from multi_orbslam3_jax.collab.server import CollabServer
    from multi_orbslam3_jax.collab.transport import InProcessTransport
    from multi_orbslam3_jax.dataio import synthetic, tum
    from multi_orbslam3_jax.eval import ate

    c = cfg.synthetic_mono()
    seqs = [synthetic.make_sequence(
        c, n_frames=args.frames, n_points=800, seed=31,
        trajectory="forward", phase=0.35 * a, imu=a in inertial_ids,
        lateral=0.8 if a in inertial_ids else 0.4,
        sway_freq=0.15 if a in inertial_ids else 0.08)
        for a in range(args.agents)]
    tr = InProcessTransport()
    clients = [CollabClient(c, a, tr, inertial=a in inertial_ids)
               for a in range(args.agents)]
    server = CollabServer(c, tr, n_agents=args.agents)

    t0 = time.perf_counter()
    for i in range(args.frames):
        for a, cl in enumerate(clients):
            t = float(seqs[a].timestamps[i])
            if a in inertial_ids:
                dt = np.diff(seqs[a].imu_t[i],
                             prepend=seqs[a].imu_t[i][0] - 1 / 200.0)
                dt = np.where(seqs[a].imu_t[i] > 0, np.maximum(dt, 0), 0)
                cl.process_frame_imu(seqs[a].images[i], t,
                                     seqs[a].imu_acc[i],
                                     seqs[a].imu_gyro[i], dt)
            else:
                cl.process_frame(seqs[a].images[i], t)
            cl.comm_cycle()
        server.comm_cycle(run_gba_on_events=args.gba)
    wall = time.perf_counter() - t0

    report = {
        "agents": args.agents, "frames": args.frames,
        "total_fps": round(args.agents * args.frames / wall, 2),
        "server": server.stats,
        "comm_bytes_up": tr.bytes_up, "comm_bytes_down": tr.bytes_down,
        "clients": [cl.stats | cl.slam.stats for cl in clients],
    }
    for a, cl in enumerate(clients):
        est = np.stack([T for _, T in cl.slam.trajectory])
        gt = seqs[a].T_cw
        report[f"ate_agent{a}"] = round(ate.ate_rmse(
            ate.camera_centers(est), ate.camera_centers(gt)), 4)
        tum.write_tum(os.path.join(args.out, f"agent{a}_traj.txt"),
                      cl.slam.keyframe_trajectory())
    if args.plot:
        from multi_orbslam3_jax.eval import viewer
        viewer.plot_map(server.m, os.path.join(args.out, "server_map.png"),
                        title=f"server arena ({args.agents} agents, "
                              f"{server.stats['merges']} merges)")
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
