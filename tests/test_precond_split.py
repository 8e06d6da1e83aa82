"""Preconditioner prepare/finish split.

reference: iterative_schur_complement_solver.cc:95-153 separates
Preconditioner::Update from creation; the split here goes further and
reuses the J-dependent Gram/correction tables across rejected steps.
Tests: (a) the recombined ete solver is EXACTLY the monolithic one (the
Schur operator must always see the true LM diagonal), (b) a finish solve
from the cache reaches the same step as the monolithic schur_solve,
(c) an end-to-end fused solve matches the host loop, and (d) the fused
stats report rebuild-count == jacobian-evaluation count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu
from ceres_tpu import LinearSolverType, PreconditionerType, SolverOptions
from ceres_tpu.io.bal import build_ba_problem, synthetic_bal
from ceres_tpu.linalg.schur import (
    ete_gram_tables,
    ete_solver_from_gram,
    make_ete_solver,
    schur_finish,
    schur_prepare,
    schur_solve,
    schur_views,
)


@pytest.fixture(scope="module")
def setup():
    problem, _, _ = build_ba_problem(synthetic_bal(8, 60, 240, seed=4))
    program = problem.compile()
    ev = program.evaluator()
    state = program.state_vector()
    _, res, jac, grad = ev.evaluate_groups(state)
    return program, res, jac, grad


def test_ete_from_gram_exact(setup):
    program, _res, jac, _grad = setup
    e_mask, _ = program.schur_tangent_masks()
    dsq = jnp.abs(jnp.asarray(
        np.random.default_rng(0).normal(1.0, 0.1,
                                        program.num_effective_parameters)
    )) * jnp.asarray(e_mask, jnp.float64)
    jac_e, _ = schur_views(program, jac)
    mono = make_ete_solver(program, jac_e, dsq)
    split = ete_solver_from_gram(program, ete_gram_tables(program, jac_e), dsq)
    for cls in mono.inv_tables:
        np.testing.assert_allclose(
            np.asarray(split.inv_tables[cls]),
            np.asarray(mono.inv_tables[cls]),
            rtol=1e-12,
        )


@pytest.mark.parametrize(
    "prec",
    [PreconditionerType.SCHUR_JACOBI, PreconditionerType.JACOBI,
     PreconditionerType.IDENTITY],
    ids=lambda p: p.value,
)
def test_finish_matches_monolithic_solve(setup, prec):
    program, res, jac, grad = setup
    options = SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=prec,
        max_linear_solver_iterations=200,
        eta=1e-12,
    )
    colnorm2 = jac.squared_column_norms()
    dsq = jnp.clip(colnorm2, options.min_lm_diagonal,
                   options.max_lm_diagonal) / 1e4

    step_mono, _ = schur_solve(program, options, jac, res, grad, dsq)
    cache = schur_prepare(program, options, jac)
    step_split, _ = schur_finish(program, options, jac, res, grad, dsq, cache)
    # both solve the SAME system to a tight eta -> steps agree. For
    # JACOBI/IDENTITY the preconditioners are bit-identical; SCHUR_JACOBI's
    # cached correction uses dsq=0, so its PCG stops at a slightly
    # different iterate of the same system
    if prec == PreconditionerType.SCHUR_JACOBI:
        tol = dict(rtol=1e-3, atol=1e-6)
    else:
        tol = dict(rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(step_split), np.asarray(step_mono), **tol
    )


def test_fused_split_matches_host_and_reports_rebuilds():
    def run(fused):
        problem, _, _ = build_ba_problem(synthetic_bal(8, 60, 240, seed=5))
        options = SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=10,
            fused_execution=fused,
        )
        return ceres_tpu.solve(options, problem)

    s_f = run(True)
    s_h = run(False)
    assert s_f.used_fused_execution and not s_h.used_fused_execution
    np.testing.assert_allclose(s_f.final_cost, s_h.final_cost, rtol=1e-6)

    stats = s_f.execution_summary
    rebuilds = stats.calls("Preconditioner::Update [fused]")
    jac_evals = stats.calls("Evaluator::Jacobian [fused]")
    assert rebuilds == jac_evals
    # rebuilds happen only on accepted steps: strictly fewer than
    # iterations whenever any step was rejected, never more than successes
    assert rebuilds <= s_f.num_successful_steps + 1


def test_split_step_dispatch_matches_combined():
    """SolverOptions.split_step_dispatch issues the LM step as two device
    programs (rhs/preconditioner, then PCG/back-substitution) — required
    at BAL-13682 scale where one combined executable's workspace exceeds
    a chip's HBM. Bitwise-equal solve vs the combined path."""
    import ceres_tpu
    from ceres_tpu import HuberLoss
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal
    from ceres_tpu.types import (
        LinearSolverType,
        PreconditionerType,
        SolverOptions,
    )

    def run(split):
        bal = synthetic_bal(
            12, 300, 1501, seed=5, observation_noise=2.0, perturb_points=0.5
        )
        problem, _, _ = build_ba_problem(bal, loss=HuberLoss(1.0))
        o = SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=8,
            eta=1e-1,
            max_linear_solver_iterations=25,
            fused_execution=False,
            split_step_dispatch=split,
        )
        return ceres_tpu.solve(o, problem)

    a = run(False)
    b = run(True)
    assert b.final_cost == pytest.approx(a.final_cost, rel=1e-10)
