"""Solve facade: validate -> compile -> minimize -> summarize.

reference: Solver::Solve pipeline (solver.cc:720-846) + free ceres::Solve.
"""

from __future__ import annotations

import time

import numpy as np

from ..evaluator import Evaluator
from ..utils.dtypes import full_f32_matmuls
from ..types import (
    LinearSolverType,
    MinimizerType,
    Summary,
    TerminationType,
)


@full_f32_matmuls
def solve(options, problem) -> Summary:
    from ..utils.execution_summary import ExecutionSummary

    summary = Summary()
    summary.execution_summary = ExecutionSummary()
    total_start = time.time()

    ok, msg = options.is_valid()
    if not ok:
        summary.termination_type = TerminationType.FAILURE
        summary.message = f"Invalid options: {msg}"
        return summary

    # ---- preprocess (reference: trust_region_preprocessor.cc:373-405) ----
    t0 = time.time()
    summary.num_parameter_blocks = problem.num_parameter_blocks()
    summary.num_parameters = problem.num_parameters()
    summary.num_effective_parameters = problem.num_effective_parameters()
    summary.num_residual_blocks = problem.num_residual_blocks()
    summary.num_residuals = problem.num_residuals()
    summary.minimizer_type = options.minimizer_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.linear_solver_type_used = options.linear_solver_type
    summary.preconditioner_type_used = options.preconditioner_type

    program = problem.compile(options)
    if options.linear_solver_ordering is not None:
        # reference: user linear_solver_ordering group 0 pins the
        # eliminated blocks (reorder_program.cc); here it overrides the
        # automatic independent-set Schur partition. Accepts a flat
        # handle sequence or a ParameterBlockOrdering (ordered_groups.h),
        # whose first group is the eliminated set.
        from ..ordering import eliminated_handles

        program._user_e_blocks = frozenset(
            int(h) for h in eliminated_handles(options.linear_solver_ordering)
        )
        program._schur_partition = None
    from ..types import PreconditionerType

    if (
        options.preconditioner_type == PreconditionerType.SUBSET
        and options.residual_blocks_for_subset_preconditioner
    ):
        program._subset_rows = problem.residual_rows_for_handles(
            options.residual_blocks_for_subset_preconditioner
        )
    summary.num_parameter_blocks_reduced = summary.num_parameter_blocks
    summary.num_parameters_reduced = summary.num_parameters
    summary.num_effective_parameters_reduced = program.num_effective_parameters
    summary.num_residual_blocks_reduced = program.num_residual_blocks
    summary.num_residuals_reduced = program.num_residuals

    if program.num_residuals == 0:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Problem has no residual blocks."
        summary.preprocessor_time_in_seconds = time.time() - t0
        summary.total_time_in_seconds = time.time() - total_start
        return summary

    if options.check_gradients:
        # reference: Solver::Options::check_gradients wires a
        # GradientCheckingCostFunction around every residual block and
        # aborts on mismatch (solver.cc:765-775,
        # gradient_checking_cost_function.cc). Here each signature group's
        # functor is probed once at its first block's current values —
        # groups share one functor, so one probe per group covers every
        # block's code path.
        from ..gradient_checker import check_gradients as _check

        for meta, idx in zip(program.groups, program.group_idx):
            params = [
                program.state0[
                    program.x_offsets[ids[0]] : program.x_offsets[ids[0]]
                    + meta.positions[pos].size
                ]
                for pos, ids in enumerate(idx["block_ids"])
            ]
            data0 = tuple(np.asarray(d)[0] for d in idx["data"])
            res = _check(
                meta.cost_function,
                params,
                data=data0,
                manifolds=[pm.manifold for pm in meta.positions],
                relative_step_size=(
                    options.gradient_check_numeric_derivative_relative_step_size
                ),
                relative_precision=options.gradient_check_relative_precision,
            )
            if not res.ok:
                summary.termination_type = TerminationType.FAILURE
                summary.message = (
                    f"Gradient check failed for cost function "
                    f"'{meta.cost_function.name}': max relative error "
                    f"{res.max_relative_error:.3e}.\n{res.error_log}"
                )
                summary.total_time_in_seconds = time.time() - total_start
                return summary

    if (
        options.mesh is not None
        and options.preconditioner_type == PreconditionerType.SUBSET
    ):
        # the SUBSET apply is a host sparse triangular solve
        # (pure_callback); it cannot run inside the sharded step's
        # shard_map. Downgrade loudly instead of failing deep in the solve.
        import copy
        import logging

        logging.getLogger(__name__).warning(
            "SUBSET preconditioner is host-bound and unavailable for "
            "sharded solves; downgrading to JACOBI"
        )
        options = copy.copy(options)
        options.preconditioner_type = PreconditionerType.JACOBI
    if options.mesh is not None:
        from ..parallel.sharding import ShardedEvaluator

        evaluator = ShardedEvaluator(
            program, options.mesh, axis=options.mesh_axis, dtype=options.dtype
        )
    else:
        evaluator = Evaluator(program, dtype=options.dtype)
    state = program.state_vector(options.dtype)
    summary.preprocessor_time_in_seconds = time.time() - t0

    # ---- minimize ----
    t1 = time.time()
    if options.minimizer_type == MinimizerType.TRUST_REGION:
        from .trust_region import TrustRegionMinimizer

        minimizer = TrustRegionMinimizer(program, options, evaluator)
    else:
        from .line_search import LineSearchMinimizer

        minimizer = LineSearchMinimizer(program, options, evaluator)
    final_state = minimizer.minimize(state, summary)
    summary.minimizer_time_in_seconds = time.time() - t1

    # ---- postprocess ----
    t2 = time.time()
    program.write_state_back(np.asarray(final_state))
    summary.postprocessor_time_in_seconds = time.time() - t2
    summary.total_time_in_seconds = time.time() - total_start
    return summary
