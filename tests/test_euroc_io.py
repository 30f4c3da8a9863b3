"""EuRoC ASL-format loaders: mono + stereo pairing + sensor.yaml
calibration parsing (reference consumes the same data via rosbags,
ros/launch/client_and_server.launch)."""

import os

import numpy as np

from multi_orbslam3_jax.dataio import euroc, png


def _make_fake_euroc(root, n_frames=5, drop_right=1):
    """EuRoC directory skeleton: mav0/{cam0,cam1,imu0} with sensor.yaml,
    data.csv, and gradient PNGs. cam1 drops one frame to exercise the
    pairing skip."""
    t0 = 1403636579763555584
    dt = 50_000_000                      # 20 fps in ns
    for cam, fu, cx in (("cam0", 458.654, 367.215), ("cam1", 457.587, 379.999)):
        d = os.path.join(root, "mav0", cam)
        os.makedirs(os.path.join(d, "data"))
        with open(os.path.join(d, "sensor.yaml"), "w") as f:
            f.write(f"""sensor_type: camera
T_BS:
  rows: 4
  cols: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, {'-0.0216401454975' if cam == 'cam0' else '-0.0198435579556'},
         0.999557249008, 0.0149672133247, 0.025715529948, {'-0.064676986768' if cam == 'cam0' else '0.0453689425024'},
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [{fu}, 457.296, {cx}, 248.375]
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
""")
        rows = ["#timestamp [ns],filename"]
        for i in range(n_frames):
            if cam == "cam1" and i == drop_right:
                continue
            ts = t0 + i * dt
            name = f"{ts}.png"
            rows.append(f"{ts},{name}")
            yy, xx = np.mgrid[0:480, 0:752]
            img = ((xx * 0.3 + yy * 0.2 + i * 10) % 255).astype(np.uint8)
            png.write_gray(os.path.join(d, "data", name), img)
        with open(os.path.join(d, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    # IMU: 200 Hz
    imu_dir = os.path.join(root, "mav0", "imu0")
    os.makedirs(imu_dir)
    rows = ["#timestamp,wx,wy,wz,ax,ay,az"]
    for k in range(n_frames * 10):
        ts = t0 + k * 5_000_000
        rows.append(f"{ts},0.01,-0.02,0.005,0.1,-9.7,0.3")
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def test_mono_loader(tmp_path):
    _make_fake_euroc(str(tmp_path))
    assert euroc.available(str(tmp_path))
    seq = euroc.EurocSequence(str(tmp_path), imu=True)
    items = list(seq)
    assert len(items) == 5
    t, img, acc, gyro, dt = items[2]
    assert img.shape == (480, 752) and img.dtype == np.float32
    assert acc.shape[1] == 3 and gyro.shape[1] == 3
    assert acc.shape[0] == 10           # 200 Hz / 20 fps
    assert np.allclose(acc[0], [0.1, -9.7, 0.3])
    assert abs(dt.sum() - 0.05) < 1e-6


def test_stereo_loader_rectifies_and_pairs(tmp_path):
    _make_fake_euroc(str(tmp_path))
    seq = euroc.EurocStereoSequence(str(tmp_path), imu=True)
    # EuRoC-like 11 cm baseline from the T_BS pair above
    assert 0.09 < seq.baseline < 0.13
    assert seq.K_new[0, 0] > 100 and seq.K_new[0, 2] == 752 / 2
    items = list(seq)
    assert len(items) == 4              # one right frame dropped
    t, left, right, acc, gyro, dt = items[0]
    assert left.shape == (480, 752) and right.shape == (480, 752)
    assert left.dtype == np.float32
    assert np.isfinite(left).all() and left.max() > 10
    # T_rect_body: rigid transform
    R = seq.T_rect_body[:3, :3]
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-9)


def test_camera_yaml_parse(tmp_path):
    _make_fake_euroc(str(tmp_path))
    K, d, T_BS, (w, h) = euroc.read_camera_yaml(
        os.path.join(str(tmp_path), "mav0", "cam0", "sensor.yaml"))
    assert K[0, 0] == 458.654 and K[1, 2] == 248.375
    assert len(d) == 5 and d[0] == -0.28340811 and d[4] == 0.0
    assert (w, h) == (752, 480)
    assert abs(np.linalg.det(T_BS[:3, :3]) - 1.0) < 1e-6
