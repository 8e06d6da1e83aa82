"""CPU tests of chip_smoke.py's pieces and of the card-facing settings: the
device gate, the NumPy Snavely reference, the compile-cache path and the
one-hot contraction precision."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ceres_tpu.jacobian import _onehot_precision  # noqa: E402
from ceres_tpu.utils import compile_cache  # noqa: E402


def test_device_gate_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.gpu_device()


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_numpy_reference_matches_f64_evaluator():
    bal = chip_smoke.make_bal(8, 64, 512)
    problem, cam_ids, pt_ids = chip_smoke.make_problem(bal)
    program = problem.compile()
    cost, _, _, grad = program.evaluator().evaluate(
        program.state_vector(jnp.float64)
    )
    ref_cost, _, _, ref_gc, ref_gp = chip_smoke.reference_evaluation_np(bal)
    assert abs(float(cost) - ref_cost) <= 1e-12 * ref_cost
    grad = np.asarray(grad)
    np.testing.assert_allclose(
        chip_smoke.block_gradient(program, grad, cam_ids, 9), ref_gc,
        rtol=1e-6, atol=1e-7 * np.abs(ref_gc).max(),
    )
    np.testing.assert_allclose(
        chip_smoke.block_gradient(program, grad, pt_ids, 3), ref_gp,
        rtol=1e-6, atol=1e-7 * np.abs(ref_gp).max(),
    )


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_path(monkeypatch, tmp_path, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        expected = os.path.join(REPO, ".jax_cache")
    else:
        expected = str(tmp_path / env_dir)
        monkeypatch.setenv(compile_cache.ENV_VAR, expected)
    try:
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        assert compile_cache.enable_compile_cache() == expected
        configured = jax.config.jax_compilation_cache_dir
        # with the variable set, JAX reads it itself and no directory is
        # set in code
        assert configured == (expected if env_dir is None else "sentinel")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_onehot_contractions_are_full_f32():
    assert _onehot_precision(jnp.float32) == jax.lax.Precision.HIGHEST
    assert _onehot_precision(jnp.float64) == jax.lax.Precision.HIGHEST
    assert _onehot_precision(jnp.bfloat16) is None


def test_solve_traces_with_highest_matmul_precision(monkeypatch):
    """Every compiled solve traces under default_matmul_precision
    'highest', so f32 dots on the card never drop to TF32."""
    import ceres_tpu
    from ceres_tpu.solvers import solver

    seen = []
    orig = solver.Evaluator

    def spy(*args, **kwargs):
        seen.append(jax.config.jax_default_matmul_precision)
        return orig(*args, **kwargs)

    monkeypatch.setattr(solver, "Evaluator", spy)
    problem, _, _ = chip_smoke.make_problem(chip_smoke.make_bal(4, 16, 64))
    ceres_tpu.solve(ceres_tpu.SolverOptions(max_num_iterations=1), problem)
    assert seen == ["highest"]
