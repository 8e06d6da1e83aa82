"""Trust-region minimizer: the outer optimization loop.

Behavioural parity with the reference TrustRegionMinimizer
(trust_region_minimizer.cc:66-836): LM/dogleg strategies, Jacobi scaling,
non-monotonic step acceptance, invalid-step retry, and the full set of
convergence tests. Design: every per-iteration tensor computation
(evaluate, step solve, plus, candidate cost) is a jitted device function;
the Python loop only moves scalars (cost, rho, radius), so parameters and
Jacobians never leave the device — removing the reference's per-iteration
D2H Jacobian transfer (README.md:198-200).
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from ..types import (
    CallbackReturnType,
    IterationSummary,
    TerminationType,
    TrustRegionStrategyType,
)
from .strategies import TrustRegionStepEvaluator, make_lm_step_fn


def _finite(x) -> bool:
    return bool(np.isfinite(x))


class _NullExec:
    """No-op ExecutionSummary stand-in (minimize() called without solve())."""

    def record(self, name, seconds, calls=1):
        pass


def _exec(summary):
    return getattr(summary, "execution_summary", None) or _NullExec()


class TrustRegionMinimizer:
    def __init__(self, program, options, evaluator):
        self.program = program
        self.options = options
        self.evaluator = evaluator
        if options.trust_region_strategy_type == TrustRegionStrategyType.LEVENBERG_MARQUARDT:
            raw_step_fn = make_lm_step_fn(program, options, evaluator)
        else:
            from .dogleg import make_dogleg_step_fn

            raw_step_fn = make_dogleg_step_fn(program, options, evaluator)
        self.inner = None
        if options.use_inner_iterations:
            from .inner_iterations import InnerIterationRefiner

            refiner = InnerIterationRefiner(program, options, evaluator)
            if refiner.available:
                self.inner = refiner
        # Dogleg exposes a radius-independent `prepare` (Gauss-Newton +
        # Cauchy) and a radius-dependent `finish`; the host loop caches
        # `prepare` across consecutive rejected steps, the role of the
        # reference's reuse_ flag (dogleg_strategy.cc:74-107,617-643).
        self._prepare_fn = self._finish_fn = None
        self._split_finish = None
        self._prepare_cache = self._prepare_key = None
        from ..types import PreconditionerType

        cluster_gspmd = hasattr(evaluator, "wrap_step_fn") and (
            options.preconditioner_type
            in (
                PreconditionerType.CLUSTER_JACOBI,
                PreconditionerType.CLUSTER_TRIDIAGONAL,
            )
        )
        if not getattr(raw_step_fn, "jittable", True):
            # host-path solvers (e.g. scipy sparse Cholesky) run un-jitted
            self.step_fn = raw_step_fn
        elif hasattr(evaluator, "wrap_step_fn") and not cluster_gspmd:
            self.step_fn = evaluator.wrap_step_fn(raw_step_fn)
        elif cluster_gspmd:
            # visibility preconditioners assemble from host-planned
            # global-lane-order gathers: run the step on the GLOBAL sharded
            # view under jit (XLA GSPMD partitions the products) instead of
            # shard_map — lifting the round-4 "not available for sharded"
            # refusal (visibility_based_preconditioner.cc:574 role).
            import jax

            self.step_fn = jax.jit(raw_step_fn)
        else:
            import jax

            self.step_fn = jax.jit(raw_step_fn)
            if hasattr(raw_step_fn, "prepare"):
                self._prepare_fn = jax.jit(raw_step_fn.prepare)
                self._finish_fn = jax.jit(raw_step_fn.finish)
                if getattr(options, "split_step_dispatch", False) and hasattr(
                    raw_step_fn, "finish_two_stage"
                ):
                    a, b = raw_step_fn.finish_two_stage
                    self._split_finish = (jax.jit(a), jax.jit(b))

        self._fused_chunk_fn = None
        from .fused_loop import eligible, make_chunk_fn

        self._fused_prepare = None
        if eligible(program, options, evaluator, raw_step_fn):
            sharded = evaluator if hasattr(evaluator, "wrap_step_fn") else None
            self._fused_chunk_fn = make_chunk_fn(
                program, options, raw_step_fn, sharded_evaluator=sharded
            )
            # initial prepare cache for the chunk's split step (same
            # condition as make_chunk_fn's use_split)
            if hasattr(raw_step_fn, "prepare") and not getattr(
                program, "has_bounds", False
            ):
                import jax

                if sharded is not None:
                    # the cache must be built in the same sharded
                    # environment the chunk body rebuilds it in
                    self._fused_prepare = sharded.wrap_prepare(
                        raw_step_fn.prepare
                    )
                else:
                    self._fused_prepare = jax.jit(raw_step_fn.prepare)

    def _grad_norms(self, ev, state, grad):
        """(max_norm, norm) of the gradient; with bounds present these are
        projected-gradient norms |x - Plus(x, -g)| so actives at their bound
        stop contributing (trust_region_minimizer.cc:270-295)."""
        import jax.numpy as jnp

        if not getattr(self.program, "has_bounds", False):
            gm = float(jnp.max(jnp.abs(grad))) if grad.size else 0.0
            return gm, float(jnp.linalg.norm(grad))
        diff = state - ev.plus(state, -grad)
        return float(jnp.max(jnp.abs(diff))), float(jnp.linalg.norm(diff))

    def _active_bound_mask(self, state, grad):
        """Active-set mask over tangent coordinates: 0 where the coordinate
        sits exactly at a bound AND the descent direction (-g) points
        outward. Zeroing the column scale freezes those coordinates, so the
        trust-region step slides along the boundary instead of being clipped
        (and having its step-quality ratio destroyed by the lost model
        decrease). Gradient-projection active-set handling of the box
        constraints the reference clamps in PlusWithBoundsClamping."""
        program = self.program
        t_idx, a_idx = program.bound_coordinate_maps()
        if t_idx.size == 0:
            return None
        x = np.asarray(state)[a_idx]
        g = np.asarray(grad)[t_idx]
        lo = program.lower_bound[a_idx]
        hi = program.upper_bound[a_idx]
        active = ((x <= lo) & (g > 0)) | ((x >= hi) & (g < 0))
        if not active.any():
            return None
        mask = np.ones(program.num_effective_parameters)
        mask[t_idx[active]] = 0.0
        return mask

    def _projected_line_search(self, ev, state, delta, cost, grad):
        """Armijo backtracking on f(a) = cost(Plus(x, a*delta)) for bounded
        problems; Plus projects onto the box, so this both enforces the
        constraints and improves the step (trust_region_minimizer.cc:101-106,
        585-633). Returns (scaled delta, num_cost_evaluations)."""
        import jax.numpy as jnp

        opts = self.options
        dphi0 = float(jnp.vdot(grad, delta))
        if not np.isfinite(dphi0) or dphi0 >= 0.0:
            return delta, 0
        c1 = opts.line_search_sufficient_function_decrease
        alpha = 1.0
        evals = 0
        for _ in range(opts.max_num_line_search_step_size_iterations):
            f = float(ev.cost(ev.plus(state, alpha * delta)))
            evals += 1
            if np.isfinite(f) and f <= cost + c1 * alpha * dphi0:
                return (alpha * delta if alpha != 1.0 else delta), evals
            # quadratic interpolation through (0, cost, dphi0), (alpha, f)
            denom = 2.0 * (f - cost - dphi0 * alpha)
            new_alpha = (
                -dphi0 * alpha * alpha / denom
                if np.isfinite(denom) and denom > 0
                else 0.5 * alpha
            )
            new_alpha = max(new_alpha, alpha * opts.max_line_search_step_contraction)
            new_alpha = min(new_alpha, alpha * opts.min_line_search_step_contraction)
            alpha = new_alpha
            if alpha < opts.min_line_search_step_size:
                break
        return delta, evals  # search failed; keep the full step

    def minimize(self, state, summary):
        if self._fused_chunk_fn is not None:
            from .fused_loop import run_fused

            return run_fused(self, state, summary)
        options = self.options
        ev = self.evaluator
        start = time.time()

        radius = float(options.initial_trust_region_radius)
        decrease_factor = 2.0
        num_consecutive_invalid = 0
        iteration_of_last_jacobian = -1
        inner_iterations_enabled = self.inner is not None
        self._prepare_key = None

        exec_sum = _exec(summary)
        t_jac = time.time()
        cost, res_groups, jac, grad = ev.evaluate_groups(state)
        cost = float(cost)
        summary.num_jacobian_evaluations += 1
        summary.jacobian_evaluation_time_in_seconds += time.time() - t_jac
        exec_sum.record("Evaluator::Jacobian", time.time() - t_jac)
        if not _finite(cost):
            from ..evaluator import diagnose_non_finite

            summary.termination_type = TerminationType.FAILURE
            summary.message = (
                "Initial cost evaluation failed (non-finite).\n"
                + diagnose_non_finite(self.program, state)
            )
            return state
        summary.initial_cost = cost + summary.fixed_cost

        # Jacobi column scaling, computed once from the first Jacobian
        # (trust_region_minimizer.cc EvaluateGradientAndJacobian iteration 0).
        # jitted: the one-hot reduction path must fuse (an eager call would
        # materialize the [n, cnt] one-hot).
        if options.jacobi_scaling:
            import jax

            scale = jax.jit(
                lambda j: 1.0 / (1.0 + jnp.sqrt(j.squared_column_norms()))
            )(jac)
        else:
            scale = jnp.ones(self.program.num_effective_parameters, dtype=state.dtype)

        step_evaluator = TrustRegionStepEvaluator(
            cost,
            options.max_consecutive_nonmonotonic_steps
            if options.use_nonmonotonic_steps
            else 0,
        )

        grad_max_norm, grad_norm = self._grad_norms(ev, state, grad)
        it_sum = IterationSummary(
            iteration=0,
            step_is_valid=True,
            step_is_successful=True,
            cost=cost + summary.fixed_cost,
            gradient_max_norm=grad_max_norm,
            gradient_norm=grad_norm,
            trust_region_radius=radius,
            eta=options.eta,
            iteration_time_in_seconds=time.time() - start,
            cumulative_time_in_seconds=time.time() - start,
        )
        summary.iterations.append(it_sum)
        if self._log(it_sum):
            pass

        if grad_max_norm <= options.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = (
                f"Gradient tolerance reached. Gradient max norm {grad_max_norm:e}"
                f" <= {options.gradient_tolerance:e}"
            )
            summary.final_cost = cost + summary.fixed_cost
            return state

        for iteration in range(1, options.max_num_iterations + 1):
            iter_start = time.time()
            if time.time() - start > options.max_solver_time_in_seconds:
                summary.termination_type = TerminationType.NO_CONVERGENCE
                summary.message = "Maximum solver time reached."
                break

            t_solve = time.time()
            iter_scale = scale
            if getattr(self.program, "has_bounds", False):
                mask = self._active_bound_mask(state, grad)
                if mask is not None:
                    iter_scale = scale * jnp.asarray(mask, dtype=state.dtype)

            if iteration in (options.trust_region_minimizer_iterations_to_dump or ()):
                # reference: DumpLinearLeastSquaresProblem called from
                # levenberg_marquardt_strategy.cc:135-147 — exports the LM
                # subproblem min |J D_s step + r|^2 + |D step|^2 for offline
                # analysis. Here: one .npz with the CRS Jacobian, residuals,
                # gradient, Jacobi scale, and trust-region radius.
                import os as _os

                vals, cols, row_ptr = jac.to_crs()
                np.savez(
                    _os.path.join(
                        options.trust_region_problem_dump_directory,
                        f"ceres_tpu_problem_{iteration:03d}.npz",
                    ),
                    jacobian_values=np.asarray(vals),
                    jacobian_cols=cols,
                    jacobian_row_ptr=row_ptr,
                    residuals=np.asarray(
                        __import__(
                            "ceres_tpu.evaluator", fromlist=["flatten_residuals"]
                        ).flatten_residuals(self.program, res_groups)
                    ),
                    gradient=np.asarray(grad),
                    scale=np.asarray(iter_scale),
                    trust_region_radius=radius,
                )
            if self._prepare_fn is not None:
                # reuse the cached prepare while the Jacobian is unchanged
                # (rejected steps only shrink the radius); an active bound
                # mask changes iter_scale per iteration, so the cache must
                # rebuild every time it is in effect
                key = iteration_of_last_jacobian
                if iter_scale is not scale:
                    key = ("masked", iteration)
                if self._prepare_key != key:
                    self._prepare_cache = self._prepare_fn(
                        jac, res_groups, grad, iter_scale
                    )
                    self._prepare_key = key
                if self._split_finish is not None:
                    # two separate device programs (split_step_dispatch):
                    # rhs/preconditioner, then PCG/back-substitution
                    _r = jnp.asarray(radius, state.dtype)
                    inter = self._split_finish[0](
                        jac, res_groups, grad, _r, iter_scale,
                        self._prepare_cache,
                    )
                    delta, mcc, lin_iters, valid = self._split_finish[1](
                        jac, res_groups, grad, _r, iter_scale,
                        self._prepare_cache, inter,
                    )
                else:
                    delta, mcc, lin_iters, valid = self._finish_fn(
                        jac,
                        res_groups,
                        grad,
                        jnp.asarray(radius, state.dtype),
                        iter_scale,
                        self._prepare_cache,
                    )
            else:
                delta, mcc, lin_iters, valid = self.step_fn(
                    jac, res_groups, grad, jnp.asarray(radius, state.dtype), iter_scale
                )
            step_solver_time = time.time() - t_solve
            summary.num_linear_solves += 1
            summary.linear_solver_time_in_seconds += step_solver_time
            exec_sum.record("LinearSolver::Solve", step_solver_time)
            valid = bool(valid)
            mcc = float(mcc)

            it_sum = IterationSummary(
                iteration=iteration,
                step_is_valid=valid,
                trust_region_radius=radius,
                linear_solver_iterations=int(lin_iters),
                step_solver_time_in_seconds=step_solver_time,
            )

            if not valid:
                # reference: HandleInvalidStep -> unsuccessful step, shrink
                # radius (trust_region_minimizer.cc:462-502).
                num_consecutive_invalid += 1
                if num_consecutive_invalid >= options.max_num_consecutive_invalid_steps:
                    summary.termination_type = TerminationType.FAILURE
                    summary.message = (
                        f"{num_consecutive_invalid} consecutive invalid steps."
                    )
                    summary.iterations.append(it_sum)
                    break
                radius, decrease_factor = self._step_rejected(radius, decrease_factor)
                summary.num_unsuccessful_steps += 1
                it_sum.cost = cost + summary.fixed_cost
                self._finish_iteration(summary, it_sum, iter_start, start)
                if radius < options.min_trust_region_radius:
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.message = "Minimum trust region radius reached."
                    break
                continue

            num_consecutive_invalid = 0

            if (
                getattr(self.program, "has_bounds", False)
                or options.trust_region_use_line_search
            ) and options.max_num_line_search_step_size_iterations > 0:
                # With bounds: projected Armijo search (enforces the box +
                # improves the step; upstream runs DoLineSearch only when
                # is_constrained, trust_region_minimizer.cc:101-106).
                # trust_region_use_line_search extends the same Armijo
                # polish to unconstrained problems (where Plus is a plain
                # +), accelerating progress through curved valleys.
                t_ls = time.time()
                delta, ls_evals = self._projected_line_search(
                    ev, state, delta, cost, grad
                )
                summary.num_residual_evaluations += ls_evals
                summary.num_line_search_steps += ls_evals
                if ls_evals:
                    exec_sum.record(
                        "LineSearch::CostEvaluation",
                        time.time() - t_ls,
                        calls=ls_evals,
                    )

            candidate = ev.plus(state, delta)
            t_res = time.time()
            new_cost = float(ev.cost(candidate))
            summary.num_residual_evaluations += 1
            summary.residual_evaluation_time_in_seconds += time.time() - t_res
            exec_sum.record("Evaluator::Residual", time.time() - t_res)

            # inner iterations refine the candidate point
            # (reference: DoInnerIterationsIfNeeded,
            # trust_region_minimizer.cc:504-583)
            if inner_iterations_enabled and _finite(new_cost):
                candidate, refined_cost = self.inner.refine(candidate, new_cost)
                summary.num_inner_iteration_steps += 1
                # credit the inner-iteration decrease to the model too, so
                # the step-quality ratio doesn't over-reward the TR step
                # (trust_region_minimizer.cc:558-560)
                mcc += new_cost - refined_cost
                # disable inner iterations for later TR iterations once
                # their relative progress drops below the tolerance
                # (trust_region_minimizer.cc:564-570)
                rel_progress = (
                    1.0 - refined_cost / new_cost if new_cost > 0 else 0.0
                )
                inner_iterations_enabled = (
                    rel_progress > options.inner_iteration_tolerance
                )
                new_cost = refined_cost

            # with bounds, the projected candidate can move less than |delta|;
            # measure the realized ambient step like the reference
            # (trust_region_minimizer.cc ComputeCandidatePointAndEvaluateCost)
            if getattr(self.program, "has_bounds", False):
                step_norm = float(jnp.linalg.norm(state - candidate))
            else:
                step_norm = float(jnp.linalg.norm(delta))
            x_norm = float(jnp.linalg.norm(state))
            cost_change = cost - new_cost

            it_sum.step_norm = step_norm
            it_sum.cost_change = cost_change

            # parameter tolerance (trust_region_minimizer.cc:686-706)
            if step_norm <= options.parameter_tolerance * (
                x_norm + options.parameter_tolerance
            ):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Parameter tolerance reached. |step| = {step_norm:e}"
                )
                it_sum.cost = cost + summary.fixed_cost
                self._finish_iteration(summary, it_sum, iter_start, start)
                break

            # function tolerance (:708-727)
            if _finite(new_cost) and abs(cost_change) <= options.function_tolerance * cost:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost change|/cost = "
                    f"{abs(cost_change) / max(cost, 1e-300):e}"
                )
                it_sum.cost = min(cost, new_cost) + summary.fixed_cost
                if new_cost < cost:
                    state = candidate
                    cost = new_cost
                self._finish_iteration(summary, it_sum, iter_start, start)
                break

            relative_decrease = (
                step_evaluator.step_quality(new_cost, mcc) if _finite(new_cost) else -1.0
            )
            step_successful = (
                _finite(new_cost)
                and relative_decrease > options.min_relative_decrease
            )
            it_sum.relative_decrease = relative_decrease
            it_sum.step_is_successful = step_successful

            if step_successful:
                # LM radius update (levenberg_marquardt_strategy.cc:157-165)
                radius = radius / max(
                    1.0 / 3.0, 1.0 - (2.0 * relative_decrease - 1.0) ** 3
                )
                radius = min(radius, options.max_trust_region_radius)
                decrease_factor = 2.0
                step_evaluator.step_accepted(new_cost, mcc)
                state = candidate
                cost = new_cost
                summary.num_successful_steps += 1
                if options.update_state_every_iteration:
                    # make the current iterate visible to callbacks
                    # (reference: StateUpdatingCallback, callbacks.cc)
                    self.program.write_state_back(np.asarray(state))

                t_jac = time.time()
                cost_j, res_groups, jac, grad = ev.evaluate_groups(state)
                iteration_of_last_jacobian = iteration
                summary.num_jacobian_evaluations += 1
                summary.jacobian_evaluation_time_in_seconds += time.time() - t_jac
                exec_sum.record("Evaluator::Jacobian", time.time() - t_jac)
                if not _finite(float(cost_j)):
                    summary.termination_type = TerminationType.FAILURE
                    summary.message = "Residual/Jacobian evaluation failed at accepted point."
                    break
                grad_max_norm, grad_norm = self._grad_norms(ev, state, grad)
                it_sum.gradient_max_norm = grad_max_norm
                it_sum.gradient_norm = grad_norm

                if grad_max_norm <= options.gradient_tolerance:
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.message = (
                        f"Gradient tolerance reached. Gradient max norm "
                        f"{grad_max_norm:e}"
                    )
                    it_sum.cost = cost + summary.fixed_cost
                    self._finish_iteration(summary, it_sum, iter_start, start)
                    break
            else:
                radius, decrease_factor = self._step_rejected(radius, decrease_factor)
                summary.num_unsuccessful_steps += 1
                if radius < options.min_trust_region_radius:
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.message = "Minimum trust region radius reached."
                    it_sum.cost = cost + summary.fixed_cost
                    self._finish_iteration(summary, it_sum, iter_start, start)
                    break

            it_sum.cost = cost + summary.fixed_cost
            it_sum.trust_region_radius = radius
            cb = self._finish_iteration(summary, it_sum, iter_start, start)
            if cb == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                summary.termination_type = TerminationType.USER_SUCCESS
                summary.message = "User callback requested termination."
                break
            if cb == CallbackReturnType.SOLVER_ABORT:
                summary.termination_type = TerminationType.USER_FAILURE
                summary.message = "User callback aborted the solve."
                break
        else:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum number of iterations reached."

        summary.final_cost = cost + summary.fixed_cost
        return state

    @staticmethod
    def _step_rejected(radius, decrease_factor):
        """reference: levenberg_marquardt_strategy.cc:166-171."""
        return radius / decrease_factor, 2.0 * decrease_factor

    def _finish_iteration(self, summary, it_sum, iter_start, start):
        now = time.time()
        it_sum.iteration_time_in_seconds = now - iter_start
        it_sum.cumulative_time_in_seconds = now - start
        summary.iterations.append(it_sum)
        self._log(it_sum)
        ret = CallbackReturnType.SOLVER_CONTINUE
        for cb in self.options.callbacks:
            r = cb(it_sum)
            if r == CallbackReturnType.SOLVER_ABORT:
                return CallbackReturnType.SOLVER_ABORT
            if r == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                ret = CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return ret

    def _log(self, it_sum):
        # reference: the LoggingCallback is only installed when
        # options.logging_type != SILENT (solver.cc Minimize +
        # callbacks.cc:40-90); SILENT suppresses progress output regardless
        # of minimizer_progress_to_stdout.
        from ..types import LoggingType

        if self.options.logging_type == LoggingType.SILENT:
            return False
        if self.options.minimizer_progress_to_stdout:
            print(
                f"iter {it_sum.iteration:3d}  cost {it_sum.cost:.6e}  "
                f"cost_change {it_sum.cost_change:.2e}  "
                f"|gradient| {it_sum.gradient_max_norm:.2e}  "
                f"tr_radius {it_sum.trust_region_radius:.2e}  "
                f"li {it_sum.linear_solver_iterations}  "
                f"it_time {it_sum.iteration_time_in_seconds:.3f}s"
            )
            return True
        return False
