"""Write a synthetic sequence to disk in the EuRoC ASL layout.

The reference's whole validation story is EuRoC rosbags -> trajectory ->
ATE (ros/launch/Server_euroc.launch, src/ServerSystem.cc:134-185). Tests
and benchmarks have no EuRoC copy, so this utility materializes a
rendered ground-truth sequence as a miniature ASL tree —
mav0/cam0/data.csv + data/*.png, mav0/imu0/data.csv,
mav0/state_groundtruth_estimate0/data.csv — with REAL epoch-scale
nanosecond timestamps (~1.4e9 s), so the EuRoC code paths (loader, csv
parsing, timestamp normalization, bench_euroc, run_slam --euroc) run
end-to-end in CI exactly as they would on the real dataset.
"""

from __future__ import annotations

import os

import numpy as np

from multi_orbslam3_jax.dataio import png

# EuRoC MH_01 starts around this epoch nanosecond stamp
EPOCH0_NS = 1403636579763555584


def write_mini_asl(root: str, seq, epoch0_ns: int = EPOCH0_NS) -> str:
    """Materialize a SyntheticSequence as an ASL tree under `root`.
    Returns root."""
    mav = os.path.join(root, "mav0")
    cam_data = os.path.join(mav, "cam0", "data")
    os.makedirs(cam_data, exist_ok=True)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)

    F = seq.images.shape[0]
    ts_ns = (epoch0_ns
             + (np.asarray(seq.timestamps, np.float64) * 1e9)).astype(
        np.int64)
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i in range(F):
            name = f"{ts_ns[i]}.png"
            img = np.clip(np.asarray(seq.images[i]), 0, 255).astype(np.uint8)
            png.write_gray(os.path.join(cam_data, name), img)
            f.write(f"{ts_ns[i]},{name}\n")

    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,"
                "a_RS_S_x,a_RS_S_y,a_RS_S_z\n")
        if getattr(seq, "imu_t", None) is not None:
            for i in range(F):
                tlist = np.asarray(seq.imu_t[i], np.float64)
                for j in range(tlist.shape[0]):
                    if tlist[j] <= 0:
                        continue
                    t_ns = int(epoch0_ns + tlist[j] * 1e9)
                    g = seq.imu_gyro[i][j]
                    a = seq.imu_acc[i][j]
                    f.write(f"{t_ns},{g[0]},{g[1]},{g[2]},"
                            f"{a[0]},{a[1]},{a[2]}\n")

    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for i in range(F):
            T = np.asarray(seq.T_cw[i], np.float64)
            c = -T[:3, :3].T @ T[:3, 3]
            # quaternion from R_wc (w, x, y, z) — bench_euroc only reads
            # positions, but write a valid rotation anyway
            R = T[:3, :3].T
            qw = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2.0
            qx = (R[2, 1] - R[1, 2]) / (4 * qw)
            qy = (R[0, 2] - R[2, 0]) / (4 * qw)
            qz = (R[1, 0] - R[0, 1]) / (4 * qw)
            f.write(f"{ts_ns[i]},{c[0]},{c[1]},{c[2]},"
                    f"{qw},{qx},{qy},{qz}\n")
    return root
