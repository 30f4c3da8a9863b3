"""Stereo rectification: epipolar row alignment, disparity law, and
remap correctness (reference consumes pre-rectified stereo computed from
the same calibration data, ORB-SLAM3 EuRoC.yaml LEFT/RIGHT R,P)."""

import numpy as np

from multi_orbslam3_jax.dataio import rectify


def _project_raw(K, D, R, t, pts):
    """Project world points through a raw distorted pinhole."""
    pc = pts @ R.T + t
    x = pc[:, 0] / pc[:, 2]
    y = pc[:, 1] / pc[:, 2]
    xd, yd = rectify._radtan_distort(x, y, np.asarray(D))
    return np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


def _calib():
    K0 = np.array([[400.0, 0, 160], [0, 398.0, 122], [0, 0, 1.0]])
    K1 = np.array([[402.0, 0, 158], [0, 401.0, 119], [0, 0, 1.0]])
    D0 = (-0.28, 0.07, 1e-4, -2e-5, 0.0)
    D1 = (-0.28, 0.07, 1e-5, 1e-5, 0.0)
    # right camera: 11cm baseline with a small rotation (EuRoC-like)
    import jax.numpy as jnp

    from multi_orbslam3_jax.geometry import so3
    R_10 = np.asarray(so3.exp(jnp.asarray([0.004, -0.007, 0.003])))
    t_10 = np.array([-0.110, 0.0004, -0.0008])
    T_10 = np.eye(4)
    T_10[:3, :3] = R_10
    T_10[:3, 3] = t_10
    return K0, D0, K1, D1, T_10


def test_rows_align_and_disparity():
    K0, D0, K1, D1, T_10 = _calib()
    W, H = 320, 240
    maps = rectify.rectify_pair(K0, D0, K1, D1, T_10, W, H)
    assert abs(maps.baseline - 0.110) < 1e-3

    rng = np.random.RandomState(0)
    pts = np.stack([rng.uniform(-1.5, 1.5, 200), rng.uniform(-1, 1, 200),
                    rng.uniform(2.0, 8.0, 200)], -1)
    # rectified projections: rotate into the rectified frames, apply K_new
    pc0 = pts @ maps.R0.T
    uv0 = (pc0 / pc0[:, 2:]) @ maps.K_new.T
    R_10, t_10 = T_10[:3, :3], T_10[:3, 3]
    pc1 = (pts @ R_10.T + t_10) @ maps.R1.T
    uv1 = (pc1 / pc1[:, 2:]) @ maps.K_new.T
    inb = ((uv0[:, 0] > 5) & (uv0[:, 0] < W - 5) & (uv0[:, 1] > 5)
           & (uv0[:, 1] < H - 5) & (uv1[:, 0] > 5) & (uv1[:, 0] < W - 5))
    assert inb.sum() > 50
    # 1) epipolar rows align
    row_err = np.abs(uv0[inb, 1] - uv1[inb, 1])
    assert row_err.max() < 0.05, row_err.max()
    # 2) disparity = f b / z (z in the rectified frame)
    disp = uv0[inb, 0] - uv1[inb, 0]
    z = pc0[inb, 2]
    pred = maps.K_new[0, 0] * maps.baseline / z
    assert np.abs(disp - pred).max() < 0.05


def test_remap_consistency():
    """Sampling the rectified image at a rectified projection returns the
    raw image's intensity at the raw projection of the same point."""
    K0, D0, K1, D1, T_10 = _calib()
    W, H = 320, 240
    maps = rectify.rectify_pair(K0, D0, K1, D1, T_10, W, H)
    # smooth raw image so bilinear interpolation errors stay tiny
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    raw = (128 + 60 * np.sin(xx / 17.0) * np.cos(yy / 13.0)).astype(
        np.float32)
    rect = rectify.remap(raw, maps.map0)
    rng = np.random.RandomState(1)
    pts = np.stack([rng.uniform(-1, 1, 100), rng.uniform(-0.7, 0.7, 100),
                    rng.uniform(2.5, 6.0, 100)], -1)
    uv_raw = _project_raw(K0, np.asarray(D0), np.eye(3), np.zeros(3), pts)
    pc0 = pts @ maps.R0.T
    uv_rect = (pc0 / pc0[:, 2:]) @ maps.K_new.T
    inb = ((uv_rect[:, 0] > 8) & (uv_rect[:, 0] < W - 8)
           & (uv_rect[:, 1] > 8) & (uv_rect[:, 1] < H - 8)
           & (uv_raw[:, 0] > 8) & (uv_raw[:, 0] < W - 8)
           & (uv_raw[:, 1] > 8) & (uv_raw[:, 1] < H - 8))
    assert inb.sum() > 30

    def sample(img, uv):
        x0 = np.floor(uv[:, 0]).astype(int)
        y0 = np.floor(uv[:, 1]).astype(int)
        fx = uv[:, 0] - x0
        fy = uv[:, 1] - y0
        return (img[y0, x0] * (1 - fx) * (1 - fy)
                + img[y0, x0 + 1] * fx * (1 - fy)
                + img[y0 + 1, x0] * (1 - fx) * fy
                + img[y0 + 1, x0 + 1] * fx * fy)

    v_raw = sample(raw, uv_raw[inb])
    v_rect = sample(rect, uv_rect[inb])
    assert np.abs(v_raw - v_rect).max() < 2.0

    # identity case: no distortion, pure-x baseline -> near-identity maps
    Ki = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1.0]])
    Ti = np.eye(4)
    Ti[0, 3] = -0.2
    m2 = rectify.rectify_pair(Ki, (0, 0, 0, 0, 0), Ki, (0, 0, 0, 0, 0),
                              Ti, W, H)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    assert np.abs(m2.map0[..., 0] - gx).max() < 1e-6
    assert np.abs(m2.map0[..., 1] - gy).max() < 1e-6
    assert abs(m2.baseline - 0.2) < 1e-9
