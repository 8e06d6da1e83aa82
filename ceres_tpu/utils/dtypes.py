"""Precision policy helpers.

The reference runs fp64 end to end (Eigen doubles; CUDA kernels in double,
reference: include/ceres/jet.h). The framework is dtype-parametric: float64
when `jax_enable_x64` is active (the correctness baseline, used by the CPU
test suite), float32 otherwise (the fast device path). f32 contractions run
at full f32 precision: see `full_f32_matmuls`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


def default_dtype():
    """Solver working dtype: f64 under x64, else f32."""
    return jnp.float64 if x64_enabled() else jnp.float32


def accum_dtype():
    """Dtype for cost/norm accumulation (promoted where hardware allows)."""
    return jnp.float64 if x64_enabled() else jnp.float32


def finfo_eps(dtype=None) -> float:
    return float(np.finfo(np.dtype(dtype or default_dtype())).eps)


def tiny(dtype=None) -> float:
    return float(np.finfo(np.dtype(dtype or default_dtype())).tiny)


def full_f32_matmuls(fn):
    """Run `fn` with every f32 contraction it traces at full f32 precision.

    On the H100 an f32 dot_general at DEFAULT (or HIGH) precision runs in
    TF32, which keeps about 5e-4 relative of each operand. The public entry
    points that compile device code (solve, Evaluator, Covariance, tiny and
    gradient-problem solvers) are wrapped in this scope, so normal
    matrices, Schur blocks, dense factorizations, PCG and dogleg inner
    products, covariance and user functors all keep f32 products. The scope
    is part of jit's cache key, so it applies to everything traced inside.
    bf16 operands (the mixed-precision copies) are unaffected.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
