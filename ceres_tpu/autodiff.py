"""Forward-mode autodiff of cost functors, batched per signature.

The reference differentiates each residual block with Jet<double, N> forward
autodiff inside a CUDA thread (include/ceres/jet.h, internal/autodiff.h:318
AutoDifferentiate). Here JAX *is* the autodiff: a cost functor is a plain
JAX-traceable function

    fn(params: tuple[Array, ...], data: tuple[Array, ...]) -> Array[r]

and the whole Jet machinery collapses to `jax.linearize` + one pushforward per
tangent direction, vmapped over all residual blocks of a signature. The
primal is evaluated exactly once (unlike naive jacfwd+call), mirroring the
reference's single-pass Jet evaluation.

Numeric differentiation (numeric_diff_cost_function.h) is provided as a
functor transformer so non-differentiable user code still batches the same
way.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def value_and_jacobians(fn: Callable, params: tuple, data):
    """Evaluate fn and its Jacobians w.r.t. every entry of `params`.

    Args:
      fn: fn(params_tuple, data) -> residual vector [r].
      params: tuple of 1-D arrays (one per parameter block).
      data: per-block data pytree (closed over; not differentiated).

    Returns:
      (residuals [r], tuple of Jacobians [r, size_i]).

    One primal evaluation + sum(size_i) linear pushforwards, the exact cost
    profile of the reference's Jet evaluation (autodiff.h:318).
    """
    sizes = [int(p.shape[0]) for p in params]
    total = int(np.sum(sizes))
    dtype = params[0].dtype

    res, jvp = jax.linearize(lambda *ps: fn(ps, data), *params)

    eye = jnp.eye(total, dtype=dtype)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)

    def _match_vma(t, p):
        # Under shard_map the primals are varying over the mesh axes; basis
        # tangents are replicated constants and must be pcast to match.
        try:
            vma = jax.typeof(p).vma
        except AttributeError:
            return t
        if vma:
            return jax.lax.pcast(t, tuple(vma), to="varying")
        return t

    def push(col):
        tangents = tuple(
            _match_vma(col[offs[i] : offs[i + 1]], params[i])
            for i in range(len(sizes))
        )
        return jvp(*tangents)

    jac_cols = jax.vmap(push)(eye)  # [total, r]
    jac = jnp.swapaxes(jac_cols, 0, 1)  # [r, total]
    jacs = tuple(jac[:, offs[i] : offs[i + 1]] for i in range(len(sizes)))
    return res, jacs


def batched_value_and_jacobians(fn: Callable, params: tuple, data):
    """vmap of `value_and_jacobians` over a batch of residual blocks.

    Args:
      fn: single-block functor as above.
      params: tuple of [n, size_i] gathered parameter batches.
      data: pytree with leading batch axis n (or empty tuple).

    Returns:
      (residuals [n, r], tuple of Jacobians [n, r, size_i]).
    """
    return jax.vmap(lambda ps, d: value_and_jacobians(fn, ps, d))(params, data)


def batched_values(fn: Callable, params: tuple, data):
    """vmap residual-only evaluation: returns [n, r]."""
    return jax.vmap(lambda ps, d: fn(ps, d))(params, data)


def numeric_diff(
    fn: Callable,
    method: str = "CENTRAL",
    relative_step_size: float = 1e-6,
    min_step_size: float = 1e-12,
    ridders_extrapolations: int = 10,
    ridders_epsilon: float = 1e-12,
    ridders_step_shrink: float = 2.0,
):
    """Wrap a (possibly non-JAX-differentiable) functor so its 'linearize' is
    finite differences; parity with NumericDiffCostFunction
    (include/ceres/numeric_diff_cost_function.h, internal/numeric_diff.h).

    Returns a new functor usable anywhere a differentiable one is, via
    jax.custom_jvp: the JVP pushes forward the finite-difference Jacobian, so
    `value_and_jacobians` above works unchanged.
    """
    method = method.upper()
    if method not in ("CENTRAL", "FORWARD", "RIDDERS"):
        raise ValueError(f"unknown numeric diff method {method}")

    def jac_fd(params, data):
        """Finite-difference Jacobians, tuple of [r, size_i]."""
        jacs = []
        f0 = None
        if method == "FORWARD":
            f0 = fn(params, data)
        for i, p in enumerate(params):
            step = jnp.maximum(relative_step_size * jnp.abs(p), min_step_size)

            def col(j, p=p, i=i, step=step):
                dp = jnp.zeros_like(p).at[j].set(step[j])
                pp = params[:i] + (p + dp,) + params[i + 1 :]
                if method == "FORWARD":
                    return (fn(pp, data) - f0) / step[j]
                pm = params[:i] + (p - dp,) + params[i + 1 :]
                if method == "CENTRAL":
                    return (fn(pp, data) - fn(pm, data)) / (2.0 * step[j])
                # RIDDERS: Richardson extrapolation of central differences
                # (numeric_diff.h EvaluateRiddersJacobianColumn).
                def central(h):
                    dpj = jnp.zeros_like(p).at[j].set(h)
                    return (
                        fn(params[:i] + (p + dpj,) + params[i + 1 :], data)
                        - fn(params[:i] + (p - dpj,) + params[i + 1 :], data)
                    ) / (2.0 * h)

                h0 = step[j] * 8.0
                tableau = [central(h0)]
                best = tableau[0]
                fac = ridders_step_shrink * ridders_step_shrink
                h = h0
                for k in range(1, ridders_extrapolations):
                    h = h / ridders_step_shrink
                    new_row = [central(h)]
                    f = fac
                    for m in range(k):
                        new_row.append(
                            (new_row[m] * f - tableau[m]) / (f - 1.0)
                        )
                        f = f * fac
                    tableau = new_row
                    best = tableau[-1]
                return best

            cols = [col(j) for j in range(p.shape[0])]
            jacs.append(jnp.stack(cols, axis=1))
        return jacs

    @jax.custom_jvp
    def wrapped(params, data):
        return fn(params, data)

    @wrapped.defjvp
    def wrapped_jvp(primals, tangents):
        params, data = primals
        dparams, _ = tangents
        val = fn(params, data)
        jacs = jac_fd(params, data)
        out_tangent = sum(
            jnp.einsum("rp,p->r", j, dp) for j, dp in zip(jacs, dparams)
        )
        return val, out_tangent

    return wrapped


class CostFunction:
    """A residual functor with a static residual count.

    The analog of AutoDiffCostFunction (autodiff_cost_function.h): the
    user writes one JAX function; grouping by (fn, sizes, loss, manifolds)
    batches all blocks sharing it into a single compiled evaluation — the
    same role type-bucketing plays in the reference
    (problem_cuda.h:462-468).
    """

    def __init__(self, fn: Callable, num_residuals: int, name: str | None = None):
        if num_residuals <= 0:
            raise ValueError("num_residuals must be static and positive")
        self.fn = fn
        self.num_residuals = int(num_residuals)
        self.name = name or getattr(fn, "__name__", "cost")

    def __call__(self, params, data):
        return self.fn(params, data)


def analytic_diff(fn: Callable, jac: Callable):
    """Wrap a functor whose Jacobians are user-supplied closed forms.

    Parity: SizedCostFunction / analytic CostFunction::Evaluate
    (include/ceres/sized_cost_function.h; examples
    helloworld_analytic_diff.cc, rosenbrock_analytic_diff.cc). The reference
    lets the user hand-write `Evaluate(parameters, residuals, jacobians)`;
    here the user writes `jac(params, data) -> tuple of [r, size_i]` arrays
    and jax.custom_jvp routes every downstream linearize/vmap/jit through it,
    so analytic blocks batch and fuse exactly like autodiff blocks.
    """

    @jax.custom_jvp
    def wrapped(params, data):
        return fn(params, data)

    @wrapped.defjvp
    def wrapped_jvp(primals, tangents):
        params, data = primals
        dparams, _ = tangents
        val = fn(params, data)
        jacs = jac(params, data)
        if len(jacs) != len(params):
            raise ValueError(
                f"jac returned {len(jacs)} Jacobians for {len(params)} "
                "parameter blocks"
            )
        nr = jnp.shape(val)[0] if jnp.ndim(val) else 1
        for i, (j, p) in enumerate(zip(jacs, params)):
            expect = (nr, jnp.shape(jnp.asarray(p))[0])
            got = jnp.shape(jnp.asarray(j))
            if tuple(got) != expect:
                raise ValueError(
                    f"analytic Jacobian for parameter block {i} has shape "
                    f"{tuple(got)}; expected [num_residuals, block_size] = "
                    f"{expect}"
                )
        out_tangent = sum(
            jnp.einsum("rp,p->r", jnp.asarray(j), dp)
            for j, dp in zip(jacs, dparams)
        )
        return val, out_tangent

    return wrapped


class AnalyticCostFunction(CostFunction):
    """CostFunction with user-supplied analytic Jacobians.

    Parity: sized_cost_function.h — the user hand-derives d(residual)/d(block)
    instead of relying on autodiff. `jac(params, data)` must return one
    [num_residuals, block_size] array per parameter block.
    """

    def __init__(
        self,
        fn: Callable,
        jac: Callable,
        num_residuals: int,
        name: str | None = None,
    ):
        super().__init__(
            analytic_diff(fn, jac),
            num_residuals,
            name=name or getattr(fn, "__name__", "analytic_cost"),
        )


class NumericDiffCostFunction(CostFunction):
    """CostFunction differentiated by finite differences.

    Parity: numeric_diff_cost_function.h (CENTRAL/FORWARD/RIDDERS).
    """

    def __init__(
        self,
        fn: Callable,
        num_residuals: int,
        method: str = "CENTRAL",
        relative_step_size: float = 1e-6,
        name: str | None = None,
    ):
        super().__init__(
            numeric_diff(fn, method=method, relative_step_size=relative_step_size),
            num_residuals,
            name=name or getattr(fn, "__name__", "numeric_cost"),
        )
