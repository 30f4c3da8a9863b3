"""Batched robust nonlinear least squares on the device.

Replaces g2o + the reference's 8.7k-line Optimizer.cc with dense-block
Gauss-Newton/LM formulations: observations are fixed-shape masked arrays,
the reduced camera system is built with dense contractions (dense-E
Schur complement), and robust weighting is elementwise work. Sparse
graph bookkeeping disappears — window membership masks replace it.
"""

from multi_orbslam3_jax.opt.pose_opt import pose_optimization  # noqa: F401
from multi_orbslam3_jax.opt.local_ba import bundle_adjust  # noqa: F401
