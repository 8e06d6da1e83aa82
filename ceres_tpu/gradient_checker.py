"""Gradient checking: autodiff vs numeric derivatives of cost functors.

reference: gradient_checker.cc (285) + gradient_checking_cost_function.cc
(wired via Solver::Options::check_gradients, solver.cc:765-775). The
framework's autodiff is JAX's, so a mismatch indicates a functor that is not
JAX-differentiable at the evaluation point (custom ops, non-smooth branches)
— exactly the class of bug the reference's checker catches for hand-written
Jets.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .autodiff import CostFunction, value_and_jacobians
from .manifolds import Manifold


@dataclasses.dataclass
class GradientCheckResult:
    ok: bool
    max_relative_error: float
    jacobians: list  # autodiff, per parameter block (tangent space)
    numeric_jacobians: list
    error_log: str = ""


def check_gradients(
    cost_function: CostFunction,
    params: list,
    data: tuple = (),
    manifolds: list = None,
    relative_step_size: float = 1e-6,
    relative_precision: float = 1e-8,
) -> GradientCheckResult:
    """Compare the functor's autodiff Jacobians against central differences,
    in the tangent space of each block (reference: GradientChecker::Probe)."""
    params = [jnp.asarray(np.asarray(p, dtype=np.float64)) for p in params]
    data = tuple(jnp.asarray(np.asarray(d)) for d in data)
    k = len(params)
    manifolds = manifolds or [None] * k

    _, jacs_ad = value_and_jacobians(cost_function.fn, tuple(params), data)
    jacs_ad = list(jacs_ad)
    for i, m in enumerate(manifolds):
        if m is not None:
            jacs_ad[i] = jacs_ad[i] @ m.plus_jacobian(params[i])

    numeric = []
    for i, m in enumerate(manifolds):
        tsize = m.tangent_size if m is not None else params[i].shape[0]
        cols = []
        for j in range(tsize):
            step = relative_step_size * max(float(jnp.abs(params[i][j]) if m is None else 1.0), 1.0)
            d = jnp.zeros(tsize).at[j].set(step)
            if m is None:
                pp = params[i] + d
                pm = params[i] - d
            else:
                pp = m.plus(params[i], d)
                pm = m.plus(params[i], -d)
            fp = cost_function.fn(tuple(params[:i] + [pp] + params[i + 1 :]), data)
            fm = cost_function.fn(tuple(params[:i] + [pm] + params[i + 1 :]), data)
            cols.append((np.asarray(fp) - np.asarray(fm)) / (2 * step))
        numeric.append(np.stack(cols, axis=1))

    max_rel = 0.0
    log_lines = []
    for i in range(k):
        a = np.asarray(jacs_ad[i])
        n = numeric[i]
        denom = np.maximum(np.abs(a), np.abs(n))
        denom = np.where(denom > 0, denom, 1.0)
        rel = np.abs(a - n) / denom
        # absolute filter for near-zero entries
        rel = np.where(np.maximum(np.abs(a), np.abs(n)) < 1e-10, 0.0, rel)
        worst = float(rel.max()) if rel.size else 0.0
        if worst > max_rel:
            max_rel = worst
        if worst > relative_precision:
            log_lines.append(
                f"parameter block {i}: max relative error {worst:.3e}\n"
                f"autodiff:\n{a}\nnumeric:\n{n}"
            )

    return GradientCheckResult(
        ok=max_rel <= relative_precision,
        max_relative_error=max_rel,
        jacobians=[np.asarray(j) for j in jacs_ad],
        numeric_jacobians=numeric,
        error_log="\n".join(log_lines),
    )
