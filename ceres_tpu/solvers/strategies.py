"""Trust-region step computation: Levenberg-Marquardt (and dogleg) strategy
fused with the linear solver into one jitted device function.

reference: levenberg_marquardt_strategy.cc:68-172 + linear_solver.cc dispatch.
Design: column scaling, LM diagonal, the linear solve, and the model-cost
bookkeeping are one compiled graph; the host only sees scalars (radius in,
step validity / model cost change out) — per SURVEY.md §7 "host-side control
loop latency".
"""

from __future__ import annotations



import jax
import jax.numpy as jnp

from ..types import LinearSolverType, PreconditionerType
from ..linalg.cg import conjugate_gradients
from ..linalg.dense import solve_dense_normal_cholesky, solve_dense_qr
from ..linalg.preconditioners import make_preconditioner


def _model_cost_change(jac_scaled, step, res_groups):
    """-m'(r + m/2) with m = J step; reference: trust_region_minimizer.cc
    ComputeTrustRegionStep model_cost_change. Residuals/products are [r, n]
    per group; padded lanes contribute zeros."""
    m_groups = jac_scaled.right_multiply(step)
    mcc = jnp.zeros((), dtype=step.dtype)
    for m, r in zip(m_groups, res_groups):
        mcc = mcc - jnp.sum(m * (r + 0.5 * m))
    if jac_scaled.axis_name:
        mcc = jax.lax.psum(mcc, jac_scaled.axis_name)
    return mcc


def _flat_residuals(program, res_groups):
    """Trim per-group sharding padding and concatenate (dense paths only)."""
    from ..evaluator import flatten_residuals

    return flatten_residuals(program, res_groups)


def make_lm_step_fn(program, options, evaluator):
    """Build the jitted LM step function.

    signature: (arrays, jac, res_groups, grad, radius, scale) ->
       (delta, model_cost_change, lin_iters, step_is_valid)
    """
    solver_type = options.linear_solver_type
    precond_type = options.preconditioner_type
    min_diag = options.min_lm_diagonal
    max_diag = options.max_lm_diagonal
    eta = options.eta
    max_lin_iters = options.max_linear_solver_iterations
    min_lin_iters = options.min_linear_solver_iterations

    def step_fn(jac, res_groups, grad, radius, scale):
        jac_s = jac.scale_columns(scale)
        grad_s = grad * scale

        # LM diagonal D^2 = clamp(diag(J'J), min, max) / radius
        # (levenberg_marquardt_strategy.cc:83-95)
        colnorm2 = jac_s.squared_column_norms()
        dsq = jnp.clip(colnorm2, min_diag, max_diag) / radius

        lin_iters = jnp.asarray(0, jnp.int32)
        if solver_type == LinearSolverType.DENSE_QR:
            dense = jac_s.to_dense()
            res_flat = _flat_residuals(program, res_groups)
            step = solve_dense_qr(dense, res_flat, dsq)
        elif solver_type == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            dense = jac_s.to_dense()
            res_flat = _flat_residuals(program, res_groups)
            if options.use_mixed_precision_solves:
                # f32 factorization + working-dtype refinement
                # (dense_cholesky.h:246, iterative_refiner.cc)
                from ..linalg.dense import solve_dense_normal_cholesky_mixed

                step = solve_dense_normal_cholesky_mixed(
                    dense, res_flat, dsq,
                    refine_iterations=max(
                        1, options.max_num_refinement_iterations or 3
                    ),
                )
            else:
                step = solve_dense_normal_cholesky(dense, res_flat, dsq)
        elif solver_type == LinearSolverType.CGNR:
            prec = make_preconditioner(
                precond_type
                if precond_type
                in (PreconditionerType.IDENTITY, PreconditionerType.JACOBI)
                else PreconditionerType.JACOBI,
                program,
                jac_s,
                dsq=dsq,
            )
            # mixed precision (types.py use_mixed_precision_solves): bf16
            # Jacobian reads in the CG matvec, f32 accumulation/vectors
            jac_mv = (
                jac_s.astype(jnp.bfloat16)
                if options.use_mixed_precision_solves
                else jac_s
            )
            result = conjugate_gradients(
                matvec=lambda v: jac_mv.jtj_multiply(v, dsq),
                b=-grad_s,
                preconditioner=prec,
                max_iterations=min(max_lin_iters, program.num_effective_parameters),
                min_iterations=min_lin_iters,
                # LM maps eta to the Q-based (truncated-Newton) criterion,
                # residual test disabled (levenberg_marquardt_strategy.cc:98-103)
                tolerance=0.0,
                q_tolerance=eta,
            )
            step = result.x
            lin_iters = result.iterations
        elif solver_type in (
            LinearSolverType.ITERATIVE_SCHUR,
            LinearSolverType.DENSE_SCHUR,
            LinearSolverType.SPARSE_SCHUR,
        ):
            from ..linalg.schur import schur_solve

            step, lin_iters = schur_solve(
                program, options, jac_s, res_groups, grad_s, dsq
            )
        else:
            raise NotImplementedError(f"linear solver {solver_type}")

        mcc = _model_cost_change(jac_s, step, res_groups)
        delta = scale * step
        valid = jnp.logical_and(jnp.all(jnp.isfinite(delta)), mcc > 0)
        return delta, mcc, lin_iters, valid

    # prepare/finish split for ITERATIVE_SCHUR: the J-dependent grams and
    # preconditioner tables (schur.schur_prepare, the 74.7 ms build at
    # BAL-1778 scale) are cached and reused across consecutive rejected
    # steps, where only the radius moved; finish rebuilds exactly the
    # dsq-dependent pieces. Consumed by the host loop's prepare cache and
    # by the fused chunk body (fused_loop.make_chunk_fn).
    if (
        solver_type == LinearSolverType.ITERATIVE_SCHUR
        and precond_type
        in (
            PreconditionerType.SCHUR_JACOBI,
            PreconditionerType.JACOBI,
            PreconditionerType.IDENTITY,
        )
        and not getattr(options, "use_explicit_schur_complement", False)
        and not getattr(options, "use_spse_initialization", False)
    ):
        from ..linalg.schur import (
            schur_finish,
            schur_finish_rhs,
            schur_finish_solve,
            schur_prepare,
        )

        def prepare_fn(jac, res_groups, grad, scale):
            return schur_prepare(program, options, jac.scale_columns(scale))

        def finish_fn(jac, res_groups, grad, radius, scale, cache):
            jac_s = jac.scale_columns(scale)
            grad_s = grad * scale
            dsq = jnp.clip(cache["colnorm2"], min_diag, max_diag) / radius
            step, lin_iters = schur_finish(
                program, options, jac_s, res_groups, grad_s, dsq, cache
            )
            mcc = _model_cost_change(jac_s, step, res_groups)
            delta = scale * step
            valid = jnp.logical_and(jnp.all(jnp.isfinite(delta)), mcc > 0)
            return delta, mcc, lin_iters, valid

        # split-dispatch twins (SolverOptions.split_step_dispatch): the
        # host loop issues rhs/preconditioner and PCG/back-substitution as
        # SEPARATE device programs — at BAL-13682 scale the combined
        # executable's workspace can exceed a small device's memory.
        def finish_stage1(jac, res_groups, grad, radius, scale, cache):
            jac_s = jac.scale_columns(scale)
            grad_s = grad * scale
            dsq = jnp.clip(cache["colnorm2"], min_diag, max_diag) / radius
            return schur_finish_rhs(
                program, options, jac_s, grad_s, dsq, cache
            )

        def finish_stage2(jac, res_groups, grad, radius, scale, cache, inter):
            jac_s = jac.scale_columns(scale)
            grad_s = grad * scale
            dsq = jnp.clip(cache["colnorm2"], min_diag, max_diag) / radius
            step, lin_iters = schur_finish_solve(
                program, options, jac_s, grad_s, dsq, cache, inter
            )
            mcc = _model_cost_change(jac_s, step, res_groups)
            delta = scale * step
            valid = jnp.logical_and(jnp.all(jnp.isfinite(delta)), mcc > 0)
            return delta, mcc, lin_iters, valid

        step_fn.prepare = prepare_fn
        step_fn.finish = finish_fn
        step_fn.finish_two_stage = (finish_stage1, finish_stage2)

    if (
        solver_type == LinearSolverType.CGNR
        and precond_type == PreconditionerType.SUBSET
    ):
        # SUBSET preconditioner: host sparse factorization of Q'Q + D'D per
        # outer iteration (subset_preconditioner.cc:68-115 does the same via
        # SuiteSparse); the PCG loop stays on device, each preconditioner
        # application crosses through pure_callback. Not jittable because
        # the factorization consumes concrete Jacobian values.
        from ..linalg.sparse import SubsetPreconditioner

        def subset_step_fn(jac, res_groups, grad, radius, scale):
            rows = getattr(program, "_subset_rows", None)
            if rows is None or len(rows) == 0:
                raise ValueError(
                    "SUBSET preconditioner requires "
                    "residual_blocks_for_subset_preconditioner"
                )
            jac_s = jac.scale_columns(scale)
            grad_s = grad * scale
            colnorm2 = jac_s.squared_column_norms()
            dsq = jnp.clip(colnorm2, min_diag, max_diag) / radius
            prec = SubsetPreconditioner(jac_s, rows, dsq)
            result = conjugate_gradients(
                matvec=lambda v: jac_s.jtj_multiply(v, dsq),
                b=-grad_s,
                preconditioner=prec,
                max_iterations=min(
                    max_lin_iters, program.num_effective_parameters
                ),
                min_iterations=min_lin_iters,
                tolerance=0.0,
                q_tolerance=eta,  # levenberg_marquardt_strategy.cc:98-103
            )
            step = result.x
            mcc = _model_cost_change(jac_s, step, res_groups)
            delta = scale * step
            valid = jnp.logical_and(jnp.all(jnp.isfinite(delta)), mcc > 0)
            return delta, mcc, result.iterations, valid

        subset_step_fn.jittable = False
        return subset_step_fn

    if solver_type == LinearSolverType.SPARSE_SCHUR:
        # Explicit block-sparse S assembled on device, factored on host
        # (schur_complement_solver.cc sparse path + SuiteSparse). Not
        # jittable: the factorization consumes concrete values. Non-BA
        # problem shapes fall back to the implicit dense-S materialization.
        from ..linalg.explicit_schur import solve_sparse_schur
        from ..linalg.schur import schur_solve

        def sparse_schur_step_fn(jac, res_groups, grad, radius, scale):
            jac_s = jac.scale_columns(scale)
            grad_s = grad * scale
            colnorm2 = jac_s.squared_column_norms()
            dsq = jnp.clip(colnorm2, min_diag, max_diag) / radius
            try:
                step, lin_iters = solve_sparse_schur(
                    program, options, jac_s, res_groups, grad_s, dsq
                )
            except ValueError:
                step, lin_iters = schur_solve(
                    program, options, jac_s, res_groups, grad_s, dsq
                )
            mcc = _model_cost_change(jac_s, step, res_groups)
            delta = scale * step
            valid = jnp.logical_and(jnp.all(jnp.isfinite(delta)), mcc > 0)
            return delta, mcc, lin_iters, valid

        sparse_schur_step_fn.jittable = False
        return sparse_schur_step_fn

    if solver_type == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        # Host sparse direct path (scipy SuperLU + refinement) — same
        # CPU-library role as the reference's SuiteSparse backend. The
        # device computes scaling/column norms; the factorization runs on
        # host, so this step function must not be jitted.
        from ..linalg.sparse import solve_sparse_normal_cholesky

        def sparse_step_fn(jac, res_groups, grad, radius, scale):
            jac_s = jac.scale_columns(scale)
            grad_s = grad * scale
            colnorm2 = jac_s.squared_column_norms()
            dsq = jnp.clip(colnorm2, min_diag, max_diag) / radius
            step_np = solve_sparse_normal_cholesky(jac_s, res_groups, grad_s, dsq)
            step = jnp.asarray(step_np, dtype=grad.dtype)
            mcc = _model_cost_change(jac_s, step, res_groups)
            delta = scale * step
            valid = jnp.logical_and(jnp.all(jnp.isfinite(delta)), mcc > 0)
            return delta, mcc, jnp.asarray(1, jnp.int32), valid

        sparse_step_fn.jittable = False
        return sparse_step_fn

    return step_fn


class TrustRegionStepEvaluator:
    """Non-monotonic step acceptance bookkeeping.

    Behavioural parity with the reference TrustRegionStepEvaluator
    (trust_region_step_evaluator.cc:36-113): quality is the max of the
    classic relative decrease and the decrease w.r.t. a reference iterate
    updated every `max_consecutive_nonmonotonic_steps` accepted steps.
    """

    def __init__(self, initial_cost: float, max_consecutive_nonmonotonic_steps: int = 0):
        self.max_consecutive_nonmonotonic_steps = max_consecutive_nonmonotonic_steps
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.accumulated_reference_model_cost_change = 0.0
        self.accumulated_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        relative_decrease = (self.current_cost - cost) / model_cost_change
        historical_relative_decrease = (self.reference_cost - cost) / (
            self.accumulated_reference_model_cost_change + model_cost_change
        )
        return max(relative_decrease, historical_relative_decrease)

    def step_accepted(self, cost: float, model_cost_change: float):
        self.current_cost = cost
        self.accumulated_candidate_model_cost_change += model_cost_change
        self.accumulated_reference_model_cost_change += model_cost_change
        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.accumulated_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.accumulated_candidate_model_cost_change = 0.0
        if (
            self.num_consecutive_nonmonotonic_steps
            == self.max_consecutive_nonmonotonic_steps
        ):
            self.reference_cost = self.candidate_cost
            self.accumulated_reference_model_cost_change = (
                self.accumulated_candidate_model_cost_change
            )
