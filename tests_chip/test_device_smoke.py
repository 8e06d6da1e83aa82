"""On-card smoke checks for every change to the device path.

Mirrors the reference's differential strategy
(evaluator_cuda_test.cu.cc:426-456 — same problem through the CPU and CUDA
evaluators, values must match) on the card:

1. f32 on-card cost/residual/gradient vs a CPU-f64 reference evaluation
2. one fused ITERATIVE_SCHUR + SCHUR_JACOBI solve
3. eval output stability across repeated dispatch (determinism)
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.chip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ceres_tpu.evaluator import evaluate  # noqa: E402
from ceres_tpu.io.bal import build_ba_problem, synthetic_bal  # noqa: E402

# ~100k observations: large enough to exercise the bucket/one-hot plans,
# small enough for seconds-scale cached runs
CAMS, PTS, OBS, SEED = 40, 20_000, 100_000, 7


@pytest.fixture(scope="module")
def prog():
    problem, _, _ = build_ba_problem(synthetic_bal(CAMS, PTS, OBS, seed=SEED))
    program = problem.compile()
    arrays = program.arrays(jnp.float32)
    state = program.state_vector(jnp.float32)
    return program, arrays, state


def test_f32_chip_matches_cpu_f64(prog, tmp_path):
    """On-card f32 evaluation against the identical problem evaluated in
    f64 on CPU (a child with JAX_PLATFORMS=cpu, which never opens the
    card)."""
    program, arrays, state = prog
    ref_file = tmp_path / "ref.json"
    script = f"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import json, sys
sys.path.insert(0, {REPO!r})
from ceres_tpu.io.bal import build_ba_problem, synthetic_bal
problem, _, _ = build_ba_problem(synthetic_bal({CAMS}, {PTS}, {OBS}, seed={SEED}))
program = problem.compile()
ev = program.evaluator()
state = program.state_vector()
c, res, jac, grad = ev.evaluate(state)
import numpy as np
json.dump({{"cost": float(c),
           "grad_norm": float(np.linalg.norm(np.asarray(grad))),
           "grad_max": float(np.abs(np.asarray(grad)).max())}},
          open({str(ref_file)!r}, "w"))
"""
    subprocess.run(
        [sys.executable, "-c", script], check=True, timeout=900,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    ref = json.load(open(ref_file))

    f = jax.jit(lambda a, s: evaluate(program, a, s, with_jacobian=True))
    c, _r, _j, g = f(arrays, state)
    c = float(c)
    gnorm = float(jnp.linalg.norm(g))
    gmax = float(jnp.max(jnp.abs(g)))
    assert abs(c - ref["cost"]) <= 1e-4 * abs(ref["cost"])
    assert abs(gnorm - ref["grad_norm"]) <= 1e-3 * abs(ref["grad_norm"])
    assert abs(gmax - ref["grad_max"]) <= 1e-3 * abs(ref["grad_max"])


def test_fused_iterative_schur_solve_on_chip():
    import ceres_tpu
    from ceres_tpu import HuberLoss
    from ceres_tpu.types import (
        LinearSolverType,
        PreconditionerType,
        SolverOptions,
    )

    problem, _, _ = build_ba_problem(
        synthetic_bal(CAMS, PTS, OBS, seed=3, observation_noise=2.0,
                      perturb_points=0.3),
        loss=HuberLoss(1.0),
    )
    options = SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        fused_execution_chunk_iters=5,
        max_num_iterations=10,
        max_linear_solver_iterations=25,
    )
    s = ceres_tpu.solve(options, problem)
    assert s.used_fused_execution
    assert np.isfinite(s.final_cost)
    assert s.final_cost < 0.9 * s.initial_cost
    assert s.num_successful_steps > 0


def test_eval_deterministic_across_dispatches(prog):
    """Deterministic reductions (the atomicAdd-analog guarantee): repeated
    dispatch of the same evaluation must be bitwise stable."""
    program, arrays, state = prog
    f = jax.jit(lambda a, s: evaluate(program, a, s, with_jacobian=True))
    c1, _, _, g1 = f(arrays, state)
    c2, _, _, g2 = f(arrays, state)
    assert float(c1) == float(c2)
    assert np.array_equal(np.asarray(g1), np.asarray(g2))
