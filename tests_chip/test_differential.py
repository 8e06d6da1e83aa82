"""On-card differential mini-suite.

The reference's core CUDA test strategy is on-device differential testing:
the same problem is pushed through the CPU and CUDA evaluators and every
output must match (reference: internal/ceres/evaluator_cuda_test.cu.cc:426-461,
jet_cuda_test.cu.cc). This file is that strategy on the card:

1. mini-BA (quaternion manifold, constant block, Huber + Cauchy, three
   functor types) evaluated on the card in f32 vs CPU f64 — cost, residuals,
   gradient, AND the dense Jacobian, at scale-aware tolerances;
2. a fused-loop chunk vs the host trust-region loop (same chip, same
   dtype) — catches fused-path-only regressions;
3. one sharded evaluation step through shard_map on the device mesh —
   catches sharding lowerings that only the device backend exposes.

The three share one module-scoped fixture.
"""

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
from tests_chip._mini_ba import build_mini_ba  # noqa: E402


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """(program, arrays, state, f64 reference dict) for the mini-BA."""
    problem = build_mini_ba()
    program = problem.compile()
    arrays = program.arrays(jnp.float32)
    state = program.state_vector(jnp.float32)

    ref_file = tmp_path_factory.mktemp("ref") / "ref.npz"
    script = f"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from tests_chip._mini_ba import build_mini_ba
problem = build_mini_ba()
program = problem.compile()
ev = program.evaluator()
state = program.state_vector()
c, res, jac, grad = ev.evaluate_groups(state)
np.savez({str(ref_file)!r},
         cost=np.float64(c),
         grad=np.asarray(grad, np.float64),
         jac=np.asarray(jac.to_dense(), np.float64),
         **{{f"res{{i}}": np.asarray(r, np.float64) for i, r in enumerate(res)}})
"""
    subprocess.run(
        [sys.executable, "-c", script], check=True, timeout=900,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    ref = dict(np.load(ref_file))
    return program, arrays, state, ref


def test_mini_ba_cost_residual_gradient_vs_f64(mini):
    program, arrays, state, ref = mini
    f = jax.jit(lambda a, s: evaluate(program, a, s, with_jacobian=True))
    c, res, jac, grad = f(arrays, state)

    assert abs(float(c) - float(ref["cost"])) <= 1e-4 * abs(float(ref["cost"]))

    g = np.asarray(grad)
    g_scale = float(np.abs(ref["grad"]).max())
    np.testing.assert_allclose(
        g, ref["grad"], rtol=2e-3, atol=1e-4 * g_scale
    )

    for i, r in enumerate(res):
        r_ref = ref[f"res{i}"]
        r_scale = max(float(np.abs(r_ref).max()), 1.0)
        np.testing.assert_allclose(
            np.asarray(r), r_ref, rtol=2e-3, atol=1e-5 * r_scale
        )


def test_mini_ba_jacobian_vs_f64(mini):
    """Dense-Jacobian agreement — every entry of every functor's block,
    through manifold chain rule, loss correction, and constant-block
    masking (the reference gates at 1e-14 in f64-vs-f64;
    evaluator_cuda_test.cu.cc:446-456 — here the card side is f32 so the
    gate is scale-aware)."""
    program, arrays, state, ref = mini
    f = jax.jit(lambda a, s: evaluate(program, a, s, with_jacobian=True))
    _c, _res, jac, _grad = f(arrays, state)
    jd = np.asarray(jac.to_dense())
    j_scale = float(np.abs(ref["jac"]).max())
    np.testing.assert_allclose(
        jd, ref["jac"], rtol=2e-3, atol=2e-5 * j_scale
    )


def test_fused_chunk_matches_host_loop_on_chip():
    """One fused chunk vs the host loop, same chip, same dtype — isolates
    fused-path bugs from precision effects."""
    import ceres_tpu
    from ceres_tpu.types import (
        LinearSolverType,
        PreconditionerType,
        SolverOptions,
    )

    def run(fused):
        problem = build_mini_ba()
        options = SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=PreconditionerType.SCHUR_JACOBI,
            fused_execution=fused,
            fused_execution_chunk_iters=4,
            max_num_iterations=4,
            max_linear_solver_iterations=15,
            function_tolerance=0.0,
            gradient_tolerance=0.0,
            parameter_tolerance=0.0,
        )
        return ceres_tpu.solve(options, problem)

    s_fused = run(True)
    s_host = run(False)
    assert s_fused.used_fused_execution
    assert not s_host.used_fused_execution
    # identical algorithm, identical dtype: per-iteration costs agree to
    # f32 reduction noise
    cf = [it.cost for it in s_fused.iterations]
    ch = [it.cost for it in s_host.iterations]
    n = min(len(cf), len(ch))
    assert n >= 3
    np.testing.assert_allclose(cf[:n], ch[:n], rtol=5e-4)


def test_sharded_step_on_chip():
    """ShardedEvaluator through shard_map on the device mesh (all real
    chips present) vs the unsharded evaluator — exercises the device
    shard_map lowering."""
    from jax.sharding import Mesh

    from ceres_tpu.evaluator import Evaluator
    from ceres_tpu.parallel.sharding import ShardedEvaluator

    problem = build_mini_ba()
    program = problem.compile()
    state = program.state_vector(jnp.float32)

    ev1 = Evaluator(program, dtype=jnp.float32)
    c1, _res1, jac1, g1 = ev1.evaluate_groups(state)

    mesh = Mesh(np.array(jax.devices()), ("dp",))
    evs = ShardedEvaluator(program, mesh, axis="dp", dtype=jnp.float32)
    cs, _ress, jacs, gs = evs.evaluate_groups(state)

    assert abs(float(cs) - float(c1)) <= 1e-5 * (1 + abs(float(c1)))
    g_scale = float(np.abs(np.asarray(g1)).max())
    np.testing.assert_allclose(
        np.asarray(gs), np.asarray(g1), rtol=1e-3, atol=1e-5 * g_scale
    )
    v = jnp.asarray(
        np.random.default_rng(0).normal(
            0, 1, program.num_effective_parameters
        ),
        jnp.float32,
    )
    a = np.asarray(jacs.jtj_multiply(v))
    b = np.asarray(jac1.jtj_multiply(v))
    np.testing.assert_allclose(
        a, b, rtol=1e-3, atol=1e-5 * max(float(np.abs(b).max()), 1.0)
    )
