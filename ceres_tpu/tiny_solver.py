"""TinySolver: self-contained dense LM for small fixed-size problems,
fully compiled as one lax.while_loop (zero host round-trips).

reference: tiny_solver.h (400 LoC header-only dense LM). The twist:
because the whole solve is one jitted graph, it vmaps — `tiny_solve_batched`
solves thousands of independent small problems in parallel, a capability the
reference does not have (and the seed of the fully-on-device solve path).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .autodiff import value_and_jacobians
from .utils.dtypes import full_f32_matmuls


@dataclasses.dataclass(frozen=True)
class TinySolverOptions:
    max_num_iterations: int = 50
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    function_tolerance: float = 1e-6
    initial_trust_region_radius: float = 1e4


class TinySolverResult(NamedTuple):
    x: jnp.ndarray
    cost: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray


def _lm_state(x, cost, radius, it, done):
    return (x, cost, radius, it, done)


@full_f32_matmuls
@partial(jax.jit, static_argnums=(0, 2))
def tiny_solve(residual_fn: Callable, x0, options: TinySolverOptions = TinySolverOptions()):
    """Minimize 0.5 |r(x)|^2 for a single small dense problem.

    residual_fn: x -> residual vector (JAX-traceable).
    """

    def eval_all(x):
        r, (jac,) = value_and_jacobians(lambda ps, d: residual_fn(ps[0]), (x,), ())
        cost = 0.5 * jnp.vdot(r, r)
        g = jac.T @ r
        jtj = jac.T @ jac
        return cost, r, jac, g, jtj

    def body(state):
        x, cost, radius, it, done = state
        _, r, jac, g, jtj = eval_all(x)
        diag = jnp.clip(jnp.diag(jtj), 1e-6, 1e32)
        a = jtj + jnp.diag(diag) / radius
        step = -jnp.linalg.solve(a, g)
        m_new = jac @ step
        model_cost_change = -(jnp.vdot(m_new, r) + 0.5 * jnp.vdot(m_new, m_new))

        x_new = x + step
        r_new = residual_fn(x_new)
        cost_new = 0.5 * jnp.vdot(r_new, r_new)
        rho = (cost - cost_new) / jnp.where(
            model_cost_change > 0, model_cost_change, 1.0
        )
        accept = jnp.logical_and(model_cost_change > 0, rho > 1e-3)
        accept = jnp.logical_and(accept, jnp.isfinite(cost_new))

        radius_up = radius / jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        radius_new = jnp.where(accept, jnp.minimum(radius_up, 1e16), radius / 2.0)

        x_out = jnp.where(accept, x_new, x)
        cost_out = jnp.where(accept, cost_new, cost)

        g_done = jnp.max(jnp.abs(g)) <= options.gradient_tolerance
        step_done = jnp.logical_and(
            accept,
            jnp.linalg.norm(step)
            <= options.parameter_tolerance
            * (jnp.linalg.norm(x) + options.parameter_tolerance),
        )
        f_done = jnp.logical_and(
            accept,
            jnp.abs(cost - cost_new) <= options.function_tolerance * cost,
        )
        r_done = radius_new < 1e-32
        done_new = g_done | step_done | f_done | r_done
        return _lm_state(x_out, cost_out, radius_new, it + 1, done_new)

    def cond(state):
        _, _, _, it, done = state
        return jnp.logical_and(it < options.max_num_iterations, ~done)

    r0 = residual_fn(x0)
    cost0 = 0.5 * jnp.vdot(r0, r0)
    init = _lm_state(
        x0,
        cost0,
        jnp.asarray(options.initial_trust_region_radius, x0.dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
    )
    x, cost, radius, it, done = jax.lax.while_loop(cond, body, init)
    return TinySolverResult(x=x, cost=cost, iterations=it, converged=done)


@full_f32_matmuls
def tiny_solve_batched(residual_fn, x0_batch, options: TinySolverOptions = TinySolverOptions()):
    """vmap of tiny_solve over a batch of problems: x0_batch [n, p];
    residual_fn maps [p] -> [r]."""
    return jax.vmap(lambda x0: tiny_solve(residual_fn, x0, options))(x0_batch)


def cost_function_adapter(cost, data=()):
    """Adapt a single-block CostFunction to a tiny_solve residual function.

    Parity: tiny_solver_cost_function_adapter.h — run an existing
    Problem-style cost (autodiff, numeric, or analytic; see
    tiny_solver_autodiff_function.h for the autodiff case, which plain
    `tiny_solve(fn, x0)` already covers) through the dense TinySolver.
    """

    def residual_fn(x):
        return cost.fn((x,), data)

    return residual_fn
