"""Trajectory evaluation (ATE RMSE with Sim3/SE3 Umeyama alignment)."""

from multi_orbslam3_jax.eval.ate import ate_rmse, umeyama_align  # noqa: F401
