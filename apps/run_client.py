#!/usr/bin/env python
"""Multi-process collaborative client over TCP.

Replaces the reference's orb_slam3_ros_client node + Client<k>_euroc
.launch: runs MonoSlam on a synthetic or EuRoC sequence and streams map
deltas to a run_server.py process.

Usage:
    python apps/run_client.py --agent 0 --server localhost:7007 \
        --out /tmp/client0 [--frames 60] [--euroc /path/MH_01]

Each process that opens a GPU reserves most of its memory at start. On
one card, give the server and every client a share, e.g. 0.3 each for a
server and two clients:
    XLA_PYTHON_CLIENT_MEM_FRACTION=0.3 python apps/run_client.py ...
or give each process a card of its own with CUDA_VISIBLE_DEVICES.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agent", type=int, required=True)
    ap.add_argument("--server", default="127.0.0.1:7007")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--euroc", default=None)
    ap.add_argument("--inertial", action="store_true",
                    help="mono-inertial agent (the reference's "
                         "IMU_MONOCULAR collaborative mode)")
    ap.add_argument("--small", action="store_true",
                    help="reduced config for smoke runs (must match the "
                         "server's)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    from multi_orbslam3_jax.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    host, port = args.server.rsplit(":", 1)

    import numpy as np

    from multi_orbslam3_jax import config as cfg
    from multi_orbslam3_jax.collab.client import CollabClient
    from multi_orbslam3_jax.collab.transport import SocketTransportClient
    from multi_orbslam3_jax.dataio import synthetic, tum

    if args.euroc:
        c = cfg.euroc_mono_inertial() if args.inertial else cfg.euroc_mono()
    elif args.small:
        c = cfg.small_synthetic()
    else:
        c = cfg.synthetic_mono()
    tr = SocketTransportClient(args.agent, host, int(port))
    client = CollabClient(c, args.agent, tr, inertial=args.inertial)
    if args.euroc:
        from multi_orbslam3_jax.dataio import euroc
        for item in euroc.EurocSequence(args.euroc, imu=args.inertial,
                                        max_frames=args.frames):
            if args.inertial:
                t, img, acc, gyro, dt = item
                client.process_frame_imu(img, t, acc, gyro, dt)
            else:
                t, img = item
                client.process_frame(img, t)
            client.comm_cycle()
    else:
        seq = synthetic.make_sequence(c, n_frames=args.frames, n_points=800,
                                      seed=31, phase=0.35 * args.agent,
                                      imu=args.inertial,
                                      lateral=0.8 if args.inertial else 0.4,
                                      sway_freq=0.15 if args.inertial
                                      else 0.08)
        for i in range(args.frames):
            t = float(seq.timestamps[i])
            if args.inertial:
                dt = np.diff(seq.imu_t[i],
                             prepend=seq.imu_t[i][0] - 1 / 200.0)
                dt = np.where(seq.imu_t[i] > 0, np.maximum(dt, 0), 0)
                client.process_frame_imu(seq.images[i], t, seq.imu_acc[i],
                                         seq.imu_gyro[i], dt)
            else:
                client.process_frame(seq.images[i], t)
            client.comm_cycle()
    tum.write_tum(os.path.join(args.out, "KeyFrameTrajectory.txt"),
                  client.slam.keyframe_trajectory())
    print(json.dumps(client.stats | client.slam.stats))
    tr.close()


if __name__ == "__main__":
    main()
