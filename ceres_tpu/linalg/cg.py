"""Preconditioned conjugate gradients, generic over a matvec closure.

Counterpart of the reference's ConjugateGradientsSolver
(internal/ceres/conjugate_gradients_solver.h:108-311), which is templated
over the vector type so one implementation serves Eigen and CUDA vectors.
Here the same genericity comes for free: vectors are jnp arrays (replicated
under sharding; the matvec performs any cross-device psum internally), and
the loop is a `lax.while_loop` so the entire solve stays on device — the
analog of CudaCgnrSolver keeping the whole CG loop on the GPU
(cgnr_solver.cc:294-340).

Termination mirrors the reference: residual tolerance |r| <= tol*|b|,
Q-based stagnation test (Martin & Tisseur), max iterations, and breakdown
guards on rho and pAp.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray
    final_norm: jnp.ndarray
    converged: jnp.ndarray
    # True when the iteration stopped on a numerical breakdown (p'Ap <= 0 or
    # rho == 0 with a non-negligible residual) rather than on the residual /
    # Q-test / max-iteration criteria — the PCG analog of a failed
    # factorization, used by Covariance to tell "rank deficient" apart from
    # "merely ran out of iterations" (reference conjugate_gradients_solver.h
    # breakdown guards).
    breakdown: jnp.ndarray


# Vector protocol: every CG vector is a pytree (a flat jnp array, or the
# per-class transposed-table "tvec" form of jacobian.py — the layout that
# keeps the whole PCG loop free of physical [cnt, s] <-> [s, cnt]
# relayouts). The reference achieves the same genericity by
# templating ConjugateGradientsSolver over the vector type
# (conjugate_gradients_solver.h:54-60).


def _tmap(f, *ts):
    return jax.tree_util.tree_map(f, *ts)


def _tvdot(a, b):
    parts = [
        jnp.vdot(x, y)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))
    ]
    return sum(parts[1:], parts[0])


def _tnorm(a):
    return jnp.sqrt(_tvdot(a, a))


def conjugate_gradients(
    matvec: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    preconditioner: Optional[Callable] = None,
    max_iterations: int = 500,
    min_iterations: int = 0,
    tolerance: float = 1e-9,
    q_tolerance: float = 0.0,
) -> CGResult:
    """Solve A x = b with PCG; A must be SPD (as an operator).

    Args:
      matvec: x -> A x (may psum internally under shard_map).
      preconditioner: r -> M^{-1} r (identity if None).
      tolerance: stop when |r| <= tolerance * |b| (the reference's r_e
        criterion, conjugate_gradients_solver.h:214-233).
      q_tolerance: stop when the relative change of the quadratic model
        Q(x) = -0.5 x'(b + r) falls below it (reference :240-270).
    """
    dtype = jax.tree_util.tree_leaves(b)[0].dtype
    x0 = _tmap(jnp.zeros_like, b) if x0 is None else x0
    prec = preconditioner if preconditioner is not None else (lambda r: r)

    norm_b = _tnorm(b)
    tol_r = tolerance * norm_b

    r0 = _tmap(lambda bb, ax: bb - ax, b, matvec(x0))

    def cond(state):
        _x, _r, _rho, _p, _q, it, done, _bd = state
        return jnp.logical_and(it < max_iterations, jnp.logical_not(done))

    def body(state):
        x, r, z_rho, p, q_prev, it, _, bd = state
        z = prec(r)
        rho_new = _tvdot(r, z)
        first = it == 0
        beta = jnp.where(first, 0.0, rho_new / jnp.where(z_rho != 0, z_rho, 1.0))
        p_new = _tmap(lambda zz, pp: zz + beta * pp, z, p)
        ap = matvec(p_new)
        pap = _tvdot(p_new, ap)
        alpha = jnp.where(pap > 0, rho_new / jnp.where(pap != 0, pap, 1.0), 0.0)
        x_new = _tmap(lambda xx, pp: xx + alpha * pp, x, p_new)
        r_new = _tmap(lambda rr, aa: rr - alpha * aa, r, ap)

        # Q-test (Nash truncated-Newton criterion, reference
        # conjugate_gradients_solver.h:244-283): with Q(x) = x'Ax - 2b'x and
        # r = b - Ax, Q_i = -x·(b + r); terminate when
        # i * (Q_i - Q_{i-1}) / Q_i < q_tolerance (signed test).
        q_new = -_tvdot(x_new, _tmap(lambda bb, rr: bb + rr, b, r_new))
        it_new = it + 1
        zeta = jnp.where(
            q_new != 0,
            it_new.astype(q_new.dtype)
            * (q_new - q_prev)
            / jnp.where(q_new != 0, q_new, 1.0),
            jnp.asarray(jnp.inf, dtype),
        )
        done_q = jnp.logical_and(
            q_tolerance > 0,
            jnp.logical_and(it_new >= min_iterations, zeta < q_tolerance),
        )
        done_r = jnp.logical_and(
            it_new >= min_iterations, _tnorm(r_new) <= tol_r
        )
        done_breakdown = jnp.logical_and(
            jnp.logical_or(pap <= 0, rho_new == 0),
            jnp.logical_not(done_r),
        )
        done = jnp.logical_or(done_q, jnp.logical_or(done_r, done_breakdown))
        return (
            x_new,
            r_new,
            rho_new,
            p_new,
            q_new,
            it_new,
            done,
            jnp.logical_or(bd, done_breakdown),
        )

    init = (
        x0,
        r0,
        jnp.asarray(0.0, dtype),
        _tmap(jnp.zeros_like, b),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0, jnp.int32),
        _tnorm(r0) <= tol_r,
        jnp.asarray(False),
    )
    x, r, _, _, _, it, _, bd = jax.lax.while_loop(cond, body, init)
    final_norm = _tnorm(r)
    return CGResult(
        x=x,
        iterations=it,
        final_norm=final_norm,
        converged=final_norm <= tol_r,
        breakdown=bd,
    )
