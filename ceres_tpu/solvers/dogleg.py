"""Dogleg trust-region strategy (traditional + 2D subspace).

reference: dogleg_strategy.cc (718 LoC). Behaviour implemented fresh from
the classic algorithm, matching the reference's structure: a Gauss-Newton
point from the configured linear solver, the Cauchy point along the scaled
steepest-descent direction, and either the piecewise-linear dogleg path
(TRADITIONAL_DOGLEG) or exact minimization over span{gradient, GN} with the
trust-region constraint (SUBSPACE_DOGLEG). All branch logic is select-based
so the whole step is one compiled graph.

Boundary subproblem: the reference forms a quartic in the Lagrange
multiplier y and takes companion-matrix roots
(dogleg_strategy.cc MakePolynomialForBoundaryConstrainedProblem +
polynomial.cc FindPolynomialRoots). Here the subspace Hessian
B = basis^T (J'J + D) basis is positive definite by construction (clamped
diagonal floor), so the boundary minimizer is the UNIQUE Lagrange
multiplier y* > 0 solving the secular equation

    || (B + y I)^-1 g ||^2 = r^2

in the 2x2 eigenbasis of B — the same stationarity system the quartic
encodes, restricted to the PD branch that contains the constrained
minimum. A bracketed bisection ([0, |g|/r] provably contains y*) run for a
fixed 80 iterations resolves y* to f64 machine precision inside jit — no
complex eigendecomposition needed, so the step stays jit-compilable on any backend.

Gauss-Newton reuse: the GN point does not depend on the radius, so the
strategy exposes `prepare` (GN + Cauchy data, reusable while the Jacobian
is unchanged) and `finish` (radius-dependent selection). The host
trust-region loop caches `prepare` output across consecutive rejected
steps — the role of the reference's `reuse_` flag
(dogleg_strategy.cc:74-107,617-643).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import DoglegType, LinearSolverType, PreconditionerType
from ..linalg.cg import conjugate_gradients
from ..linalg.dense import solve_dense_normal_cholesky, solve_dense_qr
from ..linalg.preconditioners import make_preconditioner
from .strategies import _model_cost_change


def _eigh2(b):
    """Closed-form eigendecomposition of a symmetric 2x2 [[a,c],[c,d]].
    Returns (eigvals [2] ascending, eigvecs [2,2] columns)."""
    a, c, d = b[0, 0], b[0, 1], b[1, 1]
    half_tr = 0.5 * (a + d)
    disc = jnp.sqrt(jnp.maximum(0.25 * (a - d) ** 2 + c * c, 0.0))
    l1 = half_tr - disc
    l2 = half_tr + disc
    # eigenvector for l2: (c, l2 - a) unless degenerate
    v2 = jnp.where(
        jnp.abs(c) > 1e-300,
        jnp.stack([c, l2 - a]),
        jnp.where(a >= d, jnp.stack([1.0, 0.0]), jnp.stack([0.0, 1.0])),
    )
    v2 = v2 / jnp.maximum(jnp.linalg.norm(v2), 1e-300)
    v1 = jnp.stack([-v2[1], v2[0]])
    return jnp.stack([l1, l2]), jnp.stack([v1, v2], axis=1)


def _boundary_minimizer_2d(b, g, radius):
    """Exact minimizer of 0.5 y^T B y + g^T y on ||y|| = radius for PD B.

    Solves the secular equation sum_i gt_i^2/(l_i + y)^2 = r^2 for the
    unique y* >= 0 by fixed-count bisection (the unconstrained minimum is
    assumed outside the ball, which the caller guarantees by selection)."""
    lams, q = _eigh2(b)
    gt = q.T @ g

    def norm2_of_x(y):
        xi = -gt / (lams + y)
        return jnp.vdot(xi, xi)

    # bracket: f(0) >= 0 when the unconstrained min is outside; at
    # y = |g|/r, ||x(y)|| <= |g|/y = r so f <= 0.
    g_norm = jnp.maximum(jnp.linalg.norm(gt), 1e-300)
    lo = jnp.zeros_like(radius)
    hi = g_norm / jnp.maximum(radius, 1e-300)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        outside = norm2_of_x(mid) > radius * radius
        return jnp.where(outside, mid, lo), jnp.where(outside, hi, mid)

    lo, hi = jax.lax.fori_loop(0, 80, body, (lo, hi))
    y_star = 0.5 * (lo + hi)
    x = -gt / (lams + y_star)
    # exact radius on the boundary
    x = x * (radius / jnp.maximum(jnp.linalg.norm(x), 1e-300))
    return q @ x


def make_dogleg_step_fn(program, options, evaluator):
    solver_type = options.linear_solver_type
    dogleg_type = options.dogleg_type
    min_diag = options.min_lm_diagonal
    max_diag = options.max_lm_diagonal

    def gauss_newton(jac_s, res_groups, grad_s, dsq):
        from .strategies import _flat_residuals

        if solver_type == LinearSolverType.DENSE_QR:
            dense = jac_s.to_dense()
            res_flat = _flat_residuals(program, res_groups)
            return solve_dense_qr(dense, res_flat, dsq), jnp.asarray(0, jnp.int32)
        if solver_type == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            dense = jac_s.to_dense()
            res_flat = _flat_residuals(program, res_groups)
            return (
                solve_dense_normal_cholesky(dense, res_flat, dsq),
                jnp.asarray(0, jnp.int32),
            )
        prec = make_preconditioner(PreconditionerType.JACOBI, program, jac_s, dsq=dsq)
        result = conjugate_gradients(
            matvec=lambda v: jac_s.jtj_multiply(v, dsq),
            b=-grad_s,
            preconditioner=prec,
            max_iterations=min(
                options.max_linear_solver_iterations, program.num_effective_parameters
            ),
            tolerance=options.eta,
        )
        return result.x, result.iterations

    def prepare(jac, res_groups, grad, scale):
        """Radius-independent work: scaled GN step + Cauchy data.

        Reusable across consecutive rejected steps (radius-only changes),
        mirroring dogleg_strategy.cc's reuse_ shortcut."""
        jac_s = jac.scale_columns(scale)
        grad_s = grad * scale

        # Small fixed regularization for rank-deficient J'J: the reference
        # escalates mu on failure (dogleg_strategy.cc ComputeGaussNewtonStep);
        # here a clamped diagonal floor plays that role.
        colnorm2 = jac_s.squared_column_norms()
        dsq = jnp.clip(colnorm2, min_diag, max_diag) * 1e-12

        gn, lin_iters = gauss_newton(jac_s, res_groups, grad_s, dsq)

        # Cauchy point: alpha = |g|^2 / |J g|^2
        jg = jac_s.right_multiply(grad_s)
        g_norm2 = jnp.vdot(grad_s, grad_s)
        jg_norm2 = sum(jnp.vdot(m, m) for m in jg)
        if jac_s.axis_name:
            jg_norm2 = jax.lax.psum(jg_norm2, jac_s.axis_name)
        alpha = g_norm2 / jnp.where(jg_norm2 > 0, jg_norm2, 1.0)

        cache = {
            "gn": gn,
            "lin_iters": lin_iters,
            "alpha": alpha,
            "g_norm2": g_norm2,
            "dsq": dsq,
        }
        return cache

    def finish(jac, res_groups, grad, radius, scale, cache):
        jac_s = jac.scale_columns(scale)
        grad_s = grad * scale
        gn = cache["gn"]
        lin_iters = cache["lin_iters"]
        alpha = cache["alpha"]
        g_norm2 = cache["g_norm2"]
        dsq = cache["dsq"]

        gn_norm = jnp.linalg.norm(gn)
        sd = -alpha * grad_s
        sd_norm = jnp.linalg.norm(sd)
        g_norm = jnp.sqrt(g_norm2)
        bound_sd = -(radius / jnp.where(g_norm > 0, g_norm, 1.0)) * grad_s

        if dogleg_type == DoglegType.TRADITIONAL_DOGLEG:
            # Case 1: GN inside the region.
            # Case 2: Cauchy point outside: scale gradient to the boundary.
            # Case 3: interpolate sd -> gn to the boundary.
            diff = gn - sd
            a_ = jnp.vdot(diff, diff)
            b_ = 2.0 * jnp.vdot(sd, diff)
            c_ = jnp.vdot(sd, sd) - radius * radius
            disc = jnp.maximum(b_ * b_ - 4.0 * a_ * c_, 0.0)
            beta = jnp.where(
                a_ > 0, (-b_ + jnp.sqrt(disc)) / jnp.where(a_ > 0, 2.0 * a_, 1.0), 0.0
            )
            interp = sd + jnp.clip(beta, 0.0, 1.0) * diff
            step = jnp.where(
                gn_norm <= radius,
                gn,
                jnp.where(sd_norm >= radius, bound_sd, interp),
            )
        else:
            # SUBSPACE_DOGLEG: exact minimization of the quadratic model on
            # span{grad_s, gn} with ||step|| <= radius
            # (dogleg_strategy.cc ComputeSubspaceDoglegStep).
            v1 = grad_s / jnp.where(g_norm > 0, g_norm, 1.0)
            w = gn - jnp.vdot(gn, v1) * v1
            w_norm = jnp.linalg.norm(w)
            one_dimensional = w_norm <= 1e-12 * jnp.maximum(gn_norm, 1.0)
            v2 = w / jnp.where(w_norm > 0, w_norm, 1.0)
            basis = jnp.stack([v1, v2], axis=1)  # [n, 2]

            jv1 = jac_s.right_multiply(v1)
            jv2 = jac_s.right_multiply(v2)

            def dot_r(a_groups, b_groups):
                s = sum(jnp.vdot(a, b) for a, b in zip(a_groups, b_groups))
                if jac_s.axis_name:
                    s = jax.lax.psum(s, jac_s.axis_name)
                return s

            h = jnp.array(
                [
                    [dot_r(jv1, jv1) + jnp.vdot(v1 * dsq, v1), dot_r(jv1, jv2)],
                    [dot_r(jv1, jv2), dot_r(jv2, jv2) + jnp.vdot(v2 * dsq, v2)],
                ]
            )
            gq = basis.T @ grad_s  # [2]
            # unconstrained minimizer in the subspace
            y_unc = jnp.linalg.solve(h, -gq)
            inside = jnp.linalg.norm(y_unc) <= radius
            y_bnd = _boundary_minimizer_2d(h, gq, radius)
            y = jnp.where(inside, y_unc, y_bnd)
            step = basis @ y
            # 1-D degenerate subspace: move along the gradient to the
            # boundary (dogleg_strategy.cc:305-316)
            step = jnp.where(one_dimensional, bound_sd, step)
            step = jnp.where(gn_norm <= radius, gn, step)

        mcc = _model_cost_change(jac_s, step, res_groups)
        delta = scale * step
        valid = jnp.logical_and(jnp.all(jnp.isfinite(delta)), mcc > 0)
        return delta, mcc, lin_iters, valid

    def step_fn(jac, res_groups, grad, radius, scale):
        return finish(
            jac, res_groups, grad, radius, scale, prepare(jac, res_groups, grad, scale)
        )

    step_fn.prepare = prepare
    step_fn.finish = finish
    return step_fn
