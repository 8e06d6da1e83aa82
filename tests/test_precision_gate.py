"""Precision gate: the f32 fast path (the device production configuration)
must reach final-cost parity with an f64 solve of the same problem.

BASELINE.json acceptance: "final cost gap vs reference Ceres within its
function tolerance" — the reference is f64 end-to-end (jet.h); our device
path evaluates in f32 (optionally bf16 matvecs). This test solves one
BA-structured problem (Snavely 9+3 blocks, ITERATIVE_SCHUR+SCHUR_JACOBI,
the benchmark configuration) in both dtypes on CPU and gates the relative
final-cost gap at Ceres' default function_tolerance (1e-6). Measured gap
in round 2: ~1e-8 (recorded in BASELINE.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu
from ceres_tpu import (
    LinearSolverType,
    PreconditionerType,
    SolverOptions,
    TerminationType,
)
from ceres_tpu.io.bal import build_ba_problem, synthetic_bal

FUNCTION_TOLERANCE = 1e-6  # Ceres default (solver.h Solver::Options)


def _solve(dtype, mixed=False):
    bal = synthetic_bal(24, 600, 3000, seed=11)
    problem, _, _ = build_ba_problem(bal)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=60,
        dtype=dtype,
        use_mixed_precision_solves=mixed,
    )
    summary = ceres_tpu.solve(options, problem)
    return summary


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "f32+bf16"])
def test_f32_final_cost_matches_f64(mixed):
    s64 = _solve(jnp.float64)
    s32 = _solve(jnp.float32, mixed=mixed)
    assert s64.termination_type in (
        TerminationType.CONVERGENCE, TerminationType.NO_CONVERGENCE
    )
    assert s32.termination_type in (
        TerminationType.CONVERGENCE, TerminationType.NO_CONVERGENCE
    )
    c64, c32 = s64.final_cost, s32.final_cost
    rel_gap = abs(c32 - c64) / max(abs(c64), 1e-300)
    assert rel_gap <= FUNCTION_TOLERANCE, (
        f"f32{'+bf16' if mixed else ''} final cost {c32!r} vs f64 {c64!r}: "
        f"relative gap {rel_gap:.3e} exceeds function_tolerance "
        f"{FUNCTION_TOLERANCE}"
    )


def test_f32_converges_not_just_stalls():
    # the gate above is meaningless if the f32 solve never made progress
    s32 = _solve(jnp.float32)
    assert s32.initial_cost > 2.0 * s32.final_cost, (
        s32.initial_cost, s32.final_cost
    )
