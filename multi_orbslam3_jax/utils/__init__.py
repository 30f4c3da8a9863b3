"""Cross-cutting utilities: stage timing, structured logging."""

from multi_orbslam3_jax.utils.timing import StageTimer, timed  # noqa: F401
