"""Benchmark suite covering the reference's published baseline table, on
one NVIDIA GPU.

Reference baselines (BASELINE.md, from the reference README.md:133-200;
NVIDIA V100, BAL problems):
  - BAL-1778  residual-only eval:      0.785 s / 20  =  39.25 ms
  - BAL-1778  jac+residual eval:       3.396 s / 15  = 226.4  ms  (headline)
  - BAL-1778  preprocessor:            7.538 s
  - BAL-13682 jac+residual eval:      17.042 s / 11  = 1549.3 ms
  - LM iteration: the reference publishes no end-to-end iteration rate; the
    comparator used here is the V100's evaluation-only floor per LM
    iteration (one jac+residual + one residual-only candidate eval =
    265.6 ms), which ignores the reference's linear-solve and D2H time.

The BAL files are not bundled and there is no network, so the problems are
synthetic with identical structure and scale (Snavely 9+3 blocks, 2
residuals/observation; BAL-1778: 1778 cameras / 993,923 points / 5,000,000
observations; BAL-13682: 13,682 / 4,456,117 / 28,987,644).

Prints ONE JSON line PER METRIC, each naming the device (device_kind,
device count, and the card's name and power limit); the headline metric
(bal1778_jac_residual_eval_ms) is printed LAST. vs_baseline < 1.0 means
faster than the reference. The parent process never imports JAX; each
phase runs in its own process, one after another, so one process holds the
card at a time. There is no CPU mode: a phase that finds no GPU fails, and
the run exits non-zero if any phase failed.
"""

import json
import os
import subprocess
import sys
import time

HEADLINE = "bal1778_jac_residual_eval_ms"

# V100 numbers from BASELINE.md
BASE_1778_RES_MS = 0.785 / 20 * 1000.0
BASE_1778_JAC_MS = 3.396 / 15 * 1000.0
BASE_1778_PREPROC_S = 7.538
BASE_13682_JAC_MS = 17.042 / 11 * 1000.0
BASE_13682_RES_MS = 3.983 / 20 * 1000.0
BASE_LM_ITER_MS = BASE_1778_JAC_MS + BASE_1778_RES_MS  # V100 eval-only floor

NUM_JAC_EVALS = 15
NUM_RES_EVALS = 20


_DEVICE = {}


def emit(metric, value, unit, baseline, **extra):
    line = {
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": value / baseline,
        "baseline": baseline,
        **_DEVICE,
    }
    line.update(extra)
    print(json.dumps(line), flush=True)


# ---------------------------------------------------------------------- #
# phase workers (each runs in its own interpreter; see main())
# ---------------------------------------------------------------------- #


def _phase_env_setup():
    import jax

    from ceres_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {dev.platform}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _DEVICE.update(
        platform=dev.platform, device_kind=dev.device_kind,
        device_count=len(jax.devices()), card=card,
    )
    return jax, dev


def _build(num_cameras, num_points, num_obs, seed, **bal_kwargs):
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal

    bal = synthetic_bal(num_cameras, num_points, num_obs, seed=seed,
                        **bal_kwargs)
    t0 = time.perf_counter()
    problem, _, _ = build_ba_problem(bal)
    program = problem.compile()
    preproc_s = time.perf_counter() - t0
    return bal, problem, program, preproc_s


def _make_eval_fns(jax, program):
    from ceres_tpu.evaluator import evaluate

    @jax.jit
    def ev_full(arrays, state):
        c, r, j, g = evaluate(program, arrays, state, with_jacobian=True)
        return c, g, j.jac_groups, r

    @jax.jit
    def ev_res(arrays, state):
        c, r, _, _ = evaluate(program, arrays, state, with_jacobian=False)
        return c, r

    return ev_full, ev_res


def _timed_evals(jax, fn, arrays, state, n):
    """Mean ms of n calls, each ending in block_until_ready (one warmup
    call first compiles)."""
    jax.block_until_ready(fn(arrays, state))
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(fn(arrays, state))
    return (time.perf_counter() - t0) / n * 1000.0


def phase_eval1778():
    jax, dev = _phase_env_setup()
    import jax.numpy as jnp

    bal, problem, program, preproc_s = _build(1778, 993_923, 5_000_000, 1)
    emit("bal1778_preprocessor_s", preproc_s, "s", BASE_1778_PREPROC_S)
    ev_full, ev_res = _make_eval_fns(jax, program)
    arrays = program.arrays(jnp.float32)
    state = program.state_vector(jnp.float32)

    res_ms = _timed_evals(jax, ev_res, arrays, state, NUM_RES_EVALS)
    emit(
        "bal1778_residual_eval_ms", res_ms, "ms", BASE_1778_RES_MS,
        num_observations=int(bal.num_observations),
    )
    jac_ms = _timed_evals(jax, ev_full, arrays, state, NUM_JAC_EVALS)
    emit(
        HEADLINE, jac_ms, "ms", BASE_1778_JAC_MS,
        num_observations=int(bal.num_observations),
    )


def _run_lm_config(problem, metric, baseline, mixed=False,
                   fixed_pcg=None, n_iters=16, fused=True, split=False,
                   **extra):
    """One fused-LM benchmark configuration (chunk=1: ONE device dispatch
    per LM iteration, no chunk amortization). Emits the steady-state
    iteration time plus `compile_s` (first dispatch minus steady: the
    compile a warm persistent cache eliminates)."""
    import time as _time

    import numpy as np

    import ceres_tpu
    from ceres_tpu.types import (
        LinearSolverType,
        PreconditionerType,
        SolverOptions,
    )

    options = SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        fused_execution=fused,
        split_step_dispatch=split,
        fused_execution_chunk_iters=1,
        max_num_iterations=n_iters,
        eta=1e-1,
        min_linear_solver_iterations=fixed_pcg or 0,
        max_linear_solver_iterations=fixed_pcg or 25,
        use_mixed_precision_solves=mixed,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        min_trust_region_radius=1e-300,  # don't let radius collapse end it
        max_num_consecutive_invalid_steps=50,  # nor tiny-step rejection
    )
    t0 = _time.perf_counter()
    summary = ceres_tpu.solve(options, problem)
    total = _time.perf_counter() - t0
    iters = max(
        summary.num_successful_steps + summary.num_unsuccessful_steps, 1
    )
    # iteration 1 pays the jit compile; the rest are steady dispatches
    steady = [
        it.iteration_time_in_seconds
        for it in summary.iterations
        if it.iteration > 1
    ]
    if steady:
        lm_s_per_iter = sum(steady) / len(steady)
    else:
        lm_s_per_iter = summary.minimizer_time_in_seconds / iters
    lm_ms = lm_s_per_iter * 1000.0
    first = [
        it.iteration_time_in_seconds
        for it in summary.iterations
        if it.iteration == 1
    ]
    compile_s = max(0.0, (first[0] - lm_s_per_iter)) if first else 0.0
    emit(
        metric,
        lm_ms,
        "ms",
        baseline,
        iterations=iters,
        iterations_per_s=1000.0 / lm_ms,
        fused=bool(summary.used_fused_execution),
        unamortized=True,
        mean_linear_iters=float(
            np.mean([
                it.linear_solver_iterations
                for it in summary.iterations
                if it.iteration > 0
            ])
        ) if len(summary.iterations) > 1 else 0.0,
        total_solve_s=total,
        compile_s=compile_s,
        **extra,
    )


def phase_lm():
    """End-to-end fused LM at BAL-1778 scale: ITERATIVE_SCHUR +
    SCHUR_JACOBI + Huber, the reference's benchmark configuration
    (README.md:143 `--linear_solver=iterative_schur`). Uses a harder
    perturbation than the eval benches so the LM loop keeps doing real
    work across chunks. Three configurations: f32, mixed precision, and
    a FIXED-WORK f32 run at a pinned 25-iteration PCG so trends cannot
    hide behind the adaptive forcing sequence."""
    _phase_env_setup()
    from ceres_tpu import HuberLoss
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal

    bal = synthetic_bal(
        1778,
        993_923,
        5_000_000,
        seed=3,
        observation_noise=2.0,
        perturb_points=0.5,
        perturb_rotation=0.02,
    )
    problem, _, _ = build_ba_problem(bal, loss=HuberLoss(1.0))
    note = "V100 evaluation-only floor (no linear solve included)"
    _run_lm_config(
        problem, "bal1778_lm_iteration_ms", BASE_LM_ITER_MS,
        mixed=False, baseline_note=note,
    )
    _run_lm_config(
        problem, "bal1778_lm_iteration_mixed_ms", BASE_LM_ITER_MS,
        mixed=True, baseline_note=note,
    )
    _run_lm_config(
        problem, "bal1778_lm_iteration_fixed25_ms", BASE_LM_ITER_MS,
        mixed=False, fixed_pcg=25, n_iters=8,
        baseline_note=note + "; PCG pinned to 25 iterations (fixed work)",
    )


def phase_lm13682():
    """LM solve at BAL-13682 scale on one card, mixed precision, through
    the host loop with split dispatches (the shape that fit a 16 GB
    device; making it fused is a ROADMAP reach item)."""
    _phase_env_setup()
    from ceres_tpu import HuberLoss
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal

    bal = synthetic_bal(
        13_682,
        4_456_117,
        28_987_644,
        seed=2,
        observation_noise=2.0,
        perturb_points=0.5,
        perturb_rotation=0.02,
    )
    problem, _, _ = build_ba_problem(bal, loss=HuberLoss(1.0))
    _run_lm_config(
        problem,
        "bal13682_lm_iteration_mixed_ms",
        BASE_13682_JAC_MS + BASE_13682_RES_MS,
        mixed=True,
        n_iters=10,
        fused=False,
        split=True,
        baseline_note=(
            "V100 evaluation-only floor at 13682 scale "
            "(no linear solve included); host-loop split dispatches"
        ),
    )


def phase_eval13682():
    jax, dev = _phase_env_setup()
    import jax.numpy as jnp

    bal, problem, program, _ = _build(13_682, 4_456_117, 28_987_644, 2)
    ev_full, _ = _make_eval_fns(jax, program)
    arrays = program.arrays(jnp.float32)
    state = program.state_vector(jnp.float32)
    jac_ms = _timed_evals(jax, ev_full, arrays, state, 11)
    emit(
        "bal13682_jac_residual_eval_ms", jac_ms, "ms", BASE_13682_JAC_MS,
        num_observations=int(bal.num_observations),
    )


PHASES = {
    "eval1778": (phase_eval1778, 1200),
    "lm": (phase_lm, 2400),
    "lm13682": (phase_lm13682, 2000),
    "eval13682": (phase_eval13682, 1500),
}


def _run_phase(name, timeout):
    """Run one phase in its own process; returns (ok, metric_lines)."""
    env = dict(os.environ, BENCH_PHASE=name)
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            env=env,
            capture_output=True,
            text=True,
            timeout=timeout,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except subprocess.TimeoutExpired as e:
        sys.stderr.write(f"[bench] phase {name} timed out after {timeout}s\n")
        return False, _parse_lines(e.stdout or "")
    if proc.returncode != 0:
        sys.stderr.write(
            f"[bench] phase {name} rc={proc.returncode}\n"
            + (proc.stderr or "")[-2000:]
            + "\n"
        )
    return proc.returncode == 0, _parse_lines(proc.stdout or "")


def _parse_lines(out):
    if isinstance(out, bytes):
        out = out.decode(errors="replace")
    lines = []
    for ln in out.splitlines():
        ln = ln.strip()
        if ln.startswith("{"):
            try:
                lines.append(json.loads(ln))
            except json.JSONDecodeError:
                pass
    return lines


def main():
    collected, failed = [], []
    for name, (_, timeout) in PHASES.items():
        ok, lines = _run_phase(name, timeout)
        collected.extend(lines)
        if not ok:
            failed.append(name)
    headline = [ln for ln in collected if ln.get("metric") == HEADLINE]
    for line in collected:
        if line.get("metric") != HEADLINE:
            print(json.dumps(line), flush=True)
    for line in headline:
        print(json.dumps(line), flush=True)
    if failed:
        sys.stderr.write(f"[bench] failed phases: {', '.join(failed)}\n")
        sys.exit(1)
    if not headline:
        sys.stderr.write("[bench] headline metric missing\n")
        sys.exit(1)


if __name__ == "__main__":
    phase = os.environ.get("BENCH_PHASE")
    if phase:
        PHASES[phase][0]()
    else:
        main()
