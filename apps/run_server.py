#!/usr/bin/env python
"""Multi-process collaborative server over TCP.

Replaces the reference's orb_slam3_ros_server node + Server_euroc.launch:
listens for client delta streams on a socket, fuses maps, sends locked
corrections back. Pair with apps/run_client.py processes.

Usage:
    python apps/run_server.py --port 7007 --agents 2 --out /tmp/server \
        [--duration 120] [--plot]

Each process that opens a GPU reserves most of its memory at start. On
one card, give the server and every client a share, e.g. 0.3 each for a
server and two clients:
    XLA_PYTHON_CLIENT_MEM_FRACTION=0.3 python apps/run_server.py ...
or give each process a card of its own with CUDA_VISIBLE_DEVICES.
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
    ap.add_argument("--port", type=int, default=7007)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--out", required=True)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--cycle", type=float, default=0.05)
    ap.add_argument("--idle-exit", type=float, default=0.0,
                    help="exit once every client has disconnected for "
                         "this many seconds (0 = run full duration)")
    ap.add_argument("--small", action="store_true",
                    help="reduced config for smoke runs (must match the "
                         "clients')")
    ap.add_argument("--plot", action="store_true",
                    help="also write a top-down map PNG (needs matplotlib)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    from multi_orbslam3_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from multi_orbslam3_jax import config as cfg
    from multi_orbslam3_jax.collab.server import CollabServer
    from multi_orbslam3_jax.collab.transport import SocketTransportServer
    from multi_orbslam3_jax.dataio import checkpoint, tum

    c = cfg.small_synthetic() if args.small else cfg.synthetic_mono()
    tr = SocketTransportServer(port=args.port)
    print(f"server listening on :{tr.port}", flush=True)
    server = CollabServer(c, tr, n_agents=args.agents)
    t_end = time.time() + args.duration
    saw_client = False
    idle_since = None
    while time.time() < t_end:
        server.comm_cycle()
        if args.idle_exit > 0:
            live = tr.connected_agents()
            if live:
                saw_client = True
                idle_since = None
            elif saw_client:
                idle_since = idle_since or time.time()
                if time.time() - idle_since > args.idle_exit:
                    break
        time.sleep(args.cycle)
    server.drain_gba()
    checkpoint.save_map(os.path.join(args.out, "server_map.npz"), server.m,
                        extra={"kf_map": server.kf_map,
                               "mp_map": server.mp_map})
    if args.plot:
        from multi_orbslam3_jax.eval import viewer
        viewer.plot_map(server.m, os.path.join(args.out, "server_map.png"),
                        title="server arena")
    # server keyframe trajectory per agent (SaveKeyFrameTrajectoryEuRoC)
    import numpy as np
    valid = np.array(server.m.kf_valid)
    ts = np.array(server.m.kf_timestamp)
    poses = np.array(server.m.kf_pose)
    agents = np.array(server.m.kf_agent)
    for a in range(args.agents):
        sel = valid & (agents == a)
        traj = [(float(ts[i]), poses[i]) for i in np.nonzero(sel)[0]]
        tum.write_tum(os.path.join(args.out, f"agent{a}_server_traj.txt"),
                      traj)
    print(json.dumps(server.stats))
    tr.close()


if __name__ == "__main__":
    main()
