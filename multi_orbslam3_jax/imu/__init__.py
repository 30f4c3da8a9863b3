"""IMU preintegration + inertial state types.

Replaces the reference's src/ImuTypes.cc (Preintegrated: 15x15 covariance,
bias Jacobians, manifold integration) with a lax.scan formulation over
fixed-capacity measurement windows.
"""

from multi_orbslam3_jax.imu.preintegration import (  # noqa: F401
    ImuCalib, Preintegrated, preintegrate, merge_preintegrated,
    predict_state, bias_corrected_delta)
