"""First-order (general unconstrained) optimization API.

reference: gradient_problem.h, gradient_problem_solver.h/.cc,
first_order_function.h, autodiff_first_order_function.h. Design: the
user writes one JAX scalar function f(x); jax.value_and_grad supplies the
gradient (the analog of AutoDiffFirstOrderFunction's Jet evaluation), the
manifold supplies the retraction, and the shared LineSearchDriver
(solvers/line_search.py) runs LBFGS/BFGS/NCG/steepest descent.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .manifolds import EuclideanManifold, Manifold
from .types import MinimizerType, Summary, TerminationType
from .utils.dtypes import default_dtype, full_f32_matmuls


class GradientProblem:
    """An unconstrained minimization problem min_x f(x) with an optional
    manifold on x. reference: gradient_problem.h."""

    def __init__(self, f: Callable, manifold: Optional[Manifold] = None, size: int = None):
        self.f = f
        self.manifold = manifold
        if manifold is None and size is None:
            raise ValueError("provide `size` when no manifold is given")
        self.size = manifold.ambient_size if manifold is not None else int(size)

    @property
    def tangent_size(self) -> int:
        return self.manifold.tangent_size if self.manifold is not None else self.size


@full_f32_matmuls
def solve_gradient_problem(options, problem: GradientProblem, x0) -> tuple:
    """Minimize; returns (x, Summary). reference: GradientProblemSolver::Solve
    (gradient_problem_solver.cc)."""
    from .solvers.line_search import LineSearchDriver

    total_start = time.time()
    summary = Summary()
    summary.minimizer_type = MinimizerType.LINE_SEARCH
    summary.line_search_direction_type = options.line_search_direction_type
    summary.num_parameters = problem.size
    summary.num_effective_parameters = problem.tangent_size

    dtype = options.dtype or default_dtype()
    x0 = jnp.asarray(np.asarray(x0, dtype=np.float64), dtype=dtype)

    manifold = problem.manifold

    cost_fn = jax.jit(problem.f)

    if manifold is None or isinstance(manifold, EuclideanManifold):

        @jax.jit
        def grad_fn(x):
            return jax.value_and_grad(problem.f)(x)

        @jax.jit
        def plus_fn(x, step):
            return x + step

    else:

        @jax.jit
        def grad_fn(x):
            c, g_ambient = jax.value_and_grad(problem.f)(x)
            # tangent gradient = PlusJacobian(x)^T ambient gradient
            # (gradient_problem.cc Evaluate)
            return c, manifold.plus_jacobian(x).T @ g_ambient

        @jax.jit
        def plus_fn(x, step):
            return manifold.plus(x, step)

    driver = LineSearchDriver(options, cost_fn, grad_fn, plus_fn, problem.tangent_size)
    x = driver.minimize(x0, summary)
    summary.total_time_in_seconds = time.time() - total_start
    summary.minimizer_time_in_seconds = summary.total_time_in_seconds
    return np.asarray(x), summary


def numeric_diff_first_order(
    f: Callable,
    method: str = "CENTRAL",
    relative_step_size: float = 1e-6,
    min_step_size: float = 1e-12,
):
    """Wrap a scalar objective so its gradient is finite differences.

    Parity: numeric_diff_first_order_function.h — a FirstOrderFunction for
    objectives that are not differentiable by the autodiff engine. The
    wrapped function is a drop-in `GradientProblem` objective: its
    custom_jvp pushes forward the finite-difference gradient, so
    jax.value_and_grad works unchanged.
    """
    method = method.upper()
    if method not in ("CENTRAL", "FORWARD"):
        raise ValueError(f"unknown numeric diff method {method}")

    @jax.custom_jvp
    def wrapped(x):
        return f(x)

    @wrapped.defjvp
    def wrapped_jvp(primals, tangents):
        (x,) = primals
        (dx,) = tangents
        v = f(x)
        step = jnp.maximum(relative_step_size * jnp.abs(x), min_step_size)

        def col(i):
            e = jnp.zeros_like(x).at[i].set(step[i])
            if method == "FORWARD":
                return (f(x + e) - v) / step[i]
            return (f(x + e) - f(x - e)) / (2.0 * step[i])

        g = jnp.stack([col(i) for i in range(x.shape[0])])
        return v, jnp.vdot(g, dx)

    return wrapped
