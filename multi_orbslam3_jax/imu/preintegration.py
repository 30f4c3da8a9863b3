"""On-manifold IMU preintegration (Forster-style, as the reference's
IMU::Preintegrated — src/ImuTypes.cc IntegrateNewMeasurement/
MergePrevious/GetDeltaRotation etc.).

A preintegration window is a fixed-capacity batch of (acc, gyro, dt)
samples (padding has dt = 0 and integrates to identity), folded with
lax.scan. Tracked state: delta R/v/p, the five bias Jacobians, the 9x9
preintegration covariance, and the integration time — everything needed
for the EdgeInertial-analog residuals and for first-order bias updates
without re-integration.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.geometry import so3


class ImuCalib(NamedTuple):
    gyro_noise2: jnp.ndarray   # () sigma^2 * rate (discrete, applied per dt)
    acc_noise2: jnp.ndarray
    gyro_walk2: jnp.ndarray
    acc_walk2: jnp.ndarray
    T_bc: jnp.ndarray          # (4, 4) body-from-camera extrinsics
    gravity: jnp.ndarray       # () magnitude

    @classmethod
    def from_config(cls, imu_cfg) -> "ImuCalib":
        f = jnp.float32
        return cls(gyro_noise2=f(imu_cfg.gyro_noise ** 2 * imu_cfg.rate_hz),
                   acc_noise2=f(imu_cfg.acc_noise ** 2 * imu_cfg.rate_hz),
                   gyro_walk2=f(imu_cfg.gyro_walk ** 2),
                   acc_walk2=f(imu_cfg.acc_walk ** 2),
                   T_bc=jnp.asarray(imu_cfg.T_bc, f).reshape(4, 4),
                   gravity=f(imu_cfg.gravity))


class Preintegrated(NamedTuple):
    dR: jnp.ndarray        # (3, 3)
    dV: jnp.ndarray        # (3,)
    dP: jnp.ndarray        # (3,)
    JRg: jnp.ndarray       # (3, 3) d dR / d bg
    JVg: jnp.ndarray       # (3, 3)
    JVa: jnp.ndarray       # (3, 3)
    JPg: jnp.ndarray       # (3, 3)
    JPa: jnp.ndarray       # (3, 3)
    cov: jnp.ndarray       # (9, 9) order (phi, v, p)
    dT: jnp.ndarray        # () total time
    bg: jnp.ndarray        # (3,) gyro bias used at integration
    ba: jnp.ndarray        # (3,) acc bias used at integration


def empty_preintegrated(bg=None, ba=None) -> Preintegrated:
    z3 = jnp.zeros(3)
    z33 = jnp.zeros((3, 3))
    return Preintegrated(dR=jnp.eye(3), dV=z3, dP=z3, JRg=z33, JVg=z33,
                         JVa=z33, JPg=z33, JPa=z33, cov=jnp.zeros((9, 9)),
                         dT=jnp.float32(0.0),
                         bg=z3 if bg is None else bg,
                         ba=z3 if ba is None else ba)


@jax.jit
def preintegrate(acc: jnp.ndarray, gyro: jnp.ndarray, dt: jnp.ndarray,
                 bg: jnp.ndarray, ba: jnp.ndarray,
                 calib: ImuCalib) -> Preintegrated:
    """acc/gyro: (S, 3); dt: (S,) with zeros for padding slots."""

    def step(c: Preintegrated, x):
        a, w, h = x
        a = a - c.ba
        w = w - c.bg
        active = h > 0.0
        h = jnp.where(active, h, 0.0)
        dRk = so3.exp(w * h)
        Jr = so3.right_jacobian(w * h)
        a_hat = so3.hat(a)
        # position/velocity first (use pre-update dR)
        dP = c.dP + c.dV * h + 0.5 * (c.dR @ a) * h * h
        dV = c.dV + (c.dR @ a) * h
        JPa = c.JPa + c.JVa * h - 0.5 * c.dR * h * h
        JPg = c.JPg + c.JVg * h - 0.5 * (c.dR @ a_hat @ c.JRg) * h * h
        JVa = c.JVa - c.dR * h
        JVg = c.JVg - (c.dR @ a_hat @ c.JRg) * h
        JRg = dRk.T @ c.JRg - Jr * h
        # covariance propagation (phi, v, p)
        A = jnp.zeros((9, 9))
        A = A.at[0:3, 0:3].set(dRk.T)
        A = A.at[3:6, 0:3].set(-(c.dR @ a_hat) * h)
        A = A.at[6:9, 0:3].set(-0.5 * (c.dR @ a_hat) * h * h)
        A = A.at[3:6, 3:6].set(jnp.eye(3))
        A = A.at[6:9, 3:6].set(jnp.eye(3) * h)
        A = A.at[6:9, 6:9].set(jnp.eye(3))
        B = jnp.zeros((9, 6))
        B = B.at[0:3, 0:3].set(Jr * h)
        B = B.at[3:6, 3:6].set(c.dR * h)
        B = B.at[6:9, 3:6].set(0.5 * c.dR * h * h)
        Q = jnp.diag(jnp.concatenate([
            jnp.full(3, calib.gyro_noise2), jnp.full(3, calib.acc_noise2)]))
        cov = A @ c.cov @ A.T + B @ (Q * jnp.maximum(h, 1e-9)) @ B.T
        dR = c.dR @ dRk
        new = Preintegrated(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                            JPg=JPg, JPa=JPa, cov=cov, dT=c.dT + h,
                            bg=c.bg, ba=c.ba)
        # padding slots keep the old state
        keep = lambda n, o: jnp.where(active, n, o)  # noqa: E731
        merged = jax.tree_util.tree_map(keep, new, c)
        return merged, None

    init = empty_preintegrated(bg, ba)
    out, _ = jax.lax.scan(step, init, (acc, gyro, dt))
    return out


def bias_corrected_delta(p: Preintegrated, bg: jnp.ndarray, ba: jnp.ndarray):
    """First-order delta update for a new bias (reference GetDeltaRotation/
    Velocity/Position with updated bias)."""
    dbg = bg - p.bg
    dba = ba - p.ba
    dR = p.dR @ so3.exp(p.JRg @ dbg)
    dV = p.dV + p.JVg @ dbg + p.JVa @ dba
    dP = p.dP + p.JPg @ dbg + p.JPa @ dba
    return dR, dV, dP


def predict_state(R_wb: jnp.ndarray, v_w: jnp.ndarray, p_w: jnp.ndarray,
                  preint: Preintegrated, gravity_w: jnp.ndarray,
                  bg: jnp.ndarray, ba: jnp.ndarray):
    """Propagate a world-frame body state through a preintegration window
    (reference Tracking::PredictStateIMU, src/Tracking.cc:1363)."""
    dR, dV, dP = bias_corrected_delta(preint, bg, ba)
    t = preint.dT
    R2 = R_wb @ dR
    v2 = v_w + gravity_w * t + R_wb @ dV
    p2 = p_w + v_w * t + 0.5 * gravity_w * t * t + R_wb @ dP
    return R2, v2, p2


def merge_preintegrated(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Compose two consecutive windows (reference MergePrevious, used when a
    culled keyframe's window folds into its successor's,
    src/Communicator.cc:319-341).

    The two windows may have been integrated at different biases (the
    client's bias evolves per frame after IMU init; the reference
    re-integrates both windows at a common bias in MergePrevious). The
    merged window is stamped with p1's bias, so p2's deltas are first
    first-order-corrected to p1's bias — otherwise the stored bias would
    be inconsistent with the p2 segment and uncorrectable later via
    bias_corrected_delta."""
    dR2, dV2, dP2 = bias_corrected_delta(p2, p1.bg, p1.ba)
    dR = p1.dR @ dR2
    dV = p1.dV + p1.dR @ dV2
    dP = p1.dP + p1.dV * p2.dT + p1.dR @ dP2
    # jacobian composition (first order, at the corrected deltas)
    JRg = dR2.T @ p1.JRg + p2.JRg
    JVg = p1.JVg + p1.dR @ p2.JVg - p1.dR @ so3.hat(dV2) @ p1.JRg
    JVa = p1.JVa + p1.dR @ p2.JVa
    JPg = p1.JPg + p1.JVg * p2.dT + p1.dR @ p2.JPg \
        - p1.dR @ so3.hat(dP2) @ p1.JRg
    JPa = p1.JPa + p1.JVa * p2.dT + p1.dR @ p2.JPa
    # covariance: transport p1's through p2's window + add p2's
    A = jnp.zeros((9, 9))
    A = A.at[0:3, 0:3].set(dR2.T)
    A = A.at[3:6, 0:3].set(-p1.dR @ so3.hat(dV2))
    A = A.at[6:9, 0:3].set(-p1.dR @ so3.hat(dP2))
    A = A.at[3:6, 3:6].set(jnp.eye(3))
    A = A.at[6:9, 3:6].set(jnp.eye(3) * p2.dT)
    A = A.at[6:9, 6:9].set(jnp.eye(3))
    cov = A @ p1.cov @ A.T + p2.cov
    return Preintegrated(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                         JPg=JPg, JPa=JPa, cov=cov, dT=p1.dT + p2.dT,
                         bg=p1.bg, ba=p1.ba)


# ----------------------------------------------------------------------
# wire flattening (the preintegration uplink: the reference ships
# mpImuPreintegrated inside KF messages so the server can run
# FullInertialBA and merge windows when it culls keyframes —
# src/KeyFrame.cc ConvertToMessage / src/Communicator.cc:319-341)
# ----------------------------------------------------------------------
FLAT_DIM = 148  # dR 9 + dV 3 + dP 3 + 5 Jacobians 45 + cov 81 + dT 1 +
#                 bg 3 + ba 3
FLAT_DT = 141   # offset of dT within a flat row (9+3+3+45+81)
FLAT_BG = 142   # offset of bg (3,)
FLAT_BA = 145   # offset of ba (3,)


def preint_to_flat(p: Preintegrated) -> np.ndarray:
    """Flatten one Preintegrated into a (FLAT_DIM,) float32 row."""
    import numpy as _np
    parts = [_np.asarray(p.dR).reshape(-1), _np.asarray(p.dV).reshape(-1),
             _np.asarray(p.dP).reshape(-1), _np.asarray(p.JRg).reshape(-1),
             _np.asarray(p.JVg).reshape(-1), _np.asarray(p.JVa).reshape(-1),
             _np.asarray(p.JPg).reshape(-1), _np.asarray(p.JPa).reshape(-1),
             _np.asarray(p.cov).reshape(-1),
             _np.asarray(p.dT).reshape(-1),
             _np.asarray(p.bg).reshape(-1), _np.asarray(p.ba).reshape(-1)]
    return _np.concatenate(parts).astype(_np.float32)


def flat_to_preint(row) -> Preintegrated:
    """Inverse of preint_to_flat (accepts numpy or jax rows)."""
    r = jnp.asarray(row, jnp.float32)
    o = 0

    def take(n, shape):
        nonlocal o
        v = r[o:o + n].reshape(shape)
        o += n
        return v

    return Preintegrated(
        dR=take(9, (3, 3)), dV=take(3, (3,)), dP=take(3, (3,)),
        JRg=take(9, (3, 3)), JVg=take(9, (3, 3)), JVa=take(9, (3, 3)),
        JPg=take(9, (3, 3)), JPa=take(9, (3, 3)), cov=take(81, (9, 9)),
        dT=take(1, ()), bg=take(3, (3,)), ba=take(3, (3,)))
