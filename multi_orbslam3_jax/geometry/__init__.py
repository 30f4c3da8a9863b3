"""Manifold geometry + camera models (pure JAX, fully batchable).

Replaces the reference's Converter.cc (cv::Mat/Eigen/g2o conversions),
the Lie helpers inside ImuTypes.cc/G2oTypes.cc, and CameraModels/.
"""

from multi_orbslam3_jax.geometry import so3, se3, sim3, camera, triangulation  # noqa: F401
