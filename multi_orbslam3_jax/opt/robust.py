"""Robust kernels + chi-squared thresholds (reference g2o RobustKernelHuber
usage throughout Optimizer.cc; thresholds 5.991 / 7.815 are the 2-/3-dof
95% chi2 quantiles used for mono/stereo edges)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def f32_matmuls(fn):
    """Trace the wrapped function with float32 ("highest") matmul
    precision. On an NVIDIA GPU, JAX's default runs f32 dot/einsum on
    the tensor cores in TF32, which keeps about 3 decimal digits; the
    optimizer stack (normal equations, Schur products, PCG recurrences)
    is ill-conditioned enough that such rounding stalls or diverges it.
    Apply UNDER @jax.jit so the context is active at trace time.
    Frontend compute (pyramids, matching, covisibility) keeps the fast
    default."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


def huber_weight(chi2: jnp.ndarray, delta2: float) -> jnp.ndarray:
    """IRLS weight for the Huber kernel given squared error chi2 and squared
    threshold delta2: w = 1 inside, delta/|e| outside."""
    return jnp.where(chi2 <= delta2, 1.0,
                     jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))


def cauchy_weight(chi2: jnp.ndarray, delta2: float) -> jnp.ndarray:
    return 1.0 / (1.0 + chi2 / delta2)
