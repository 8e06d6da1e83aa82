"""Per-call execution statistics (reference: ExecutionSummary,
execution_summary.h:89, surfaced in Summary::FullReport) and the
trust-region line-search acceleration for unbounded problems."""

import numpy as np

import ceres_tpu
from ceres_tpu import CostFunction, LinearSolverType, SolverOptions
from ceres_tpu.examples.test_functions import (
    build_curve_fitting_problem,
    rosenbrock_residuals,
)
from ceres_tpu.problem import Problem


def _solve(fused, **kw):
    problem, _ = build_curve_fitting_problem()
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY,
        fused_execution=fused,
        max_num_iterations=10,
        **kw,
    )
    return ceres_tpu.solve(options, problem)


def test_host_loop_per_call_stats():
    s = _solve(fused=False)
    es = s.execution_summary
    assert es is not None
    # counts match the summary counters exactly
    assert es.calls("Evaluator::Jacobian") == s.num_jacobian_evaluations
    assert es.calls("Evaluator::Residual") == s.num_residual_evaluations
    assert es.calls("LinearSolver::Solve") == s.num_linear_solves
    # host-loop timings are fully separated and non-zero
    assert es.seconds("Evaluator::Jacobian") > 0
    assert es.seconds("LinearSolver::Solve") > 0
    report = s.full_report()
    assert "Per-call statistics" in report
    assert "Evaluator::Jacobian" in report


def test_fused_loop_per_call_stats():
    s = _solve(fused=True)
    assert s.used_fused_execution
    es = s.execution_summary
    # chunk wall time is exact and cumulative; in-chunk counts are exact
    assert es.calls("FusedLoop::Chunk") >= 1
    assert es.seconds("FusedLoop::Chunk") > 0
    assert es.calls("Evaluator::Residual [fused]") == s.num_residual_evaluations
    assert es.calls("LinearSolver::Solve [fused]") == s.num_linear_solves
    report = s.full_report()
    assert "FusedLoop::Chunk" in report
    assert "timed inside FusedLoop::Chunk" in report


def test_chunk1_gives_unamortized_iteration_times():
    """fused_execution_chunk_iters=1: one device dispatch per LM iteration,
    so each IterationSummary carries its own (unamortized) wall time and
    #chunks == #iterations."""
    s = _solve(fused=True, fused_execution_chunk_iters=1)
    assert s.used_fused_execution
    es = s.execution_summary
    n_iters = len(s.iterations) - 1  # minus iteration 0
    assert es.calls("FusedLoop::Chunk") == n_iters


def test_tr_line_search_accelerates_rosenbrock():
    """The Armijo polish on valid steps
    (trust_region_use_line_search) reduces the iteration count on a curved
    valley problem. Upstream gates DoLineSearch on is_constrained
    (trust_region_minimizer.cc:101-106); this option extends it to
    unconstrained problems."""

    def build():
        p = Problem()
        h = p.add_parameter_block(np.array([-1.2, 1.0]))
        p.add_residual_block(CostFunction(rosenbrock_residuals, 2), None, [h])
        return p

    def run(use_ls):
        options = SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_QR,
            trust_region_use_line_search=use_ls,
            max_num_iterations=200,
            function_tolerance=0.0,
            parameter_tolerance=1e-14,
            gradient_tolerance=1e-12,
            fused_execution=False,
        )
        s = ceres_tpu.solve(options, build())
        iters = s.num_successful_steps + s.num_unsuccessful_steps
        return s, iters

    s_plain, it_plain = run(False)
    s_ls, it_ls = run(True)
    assert s_ls.final_cost < 1e-12
    assert it_ls < it_plain
    # the line-search evaluations are accounted
    assert s_ls.num_line_search_steps > 0
    assert s_ls.execution_summary.calls("LineSearch::CostEvaluation") > 0
