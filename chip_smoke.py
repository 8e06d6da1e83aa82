"""Smoke test of the main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 0-4
    python chip_smoke.py --multichip   # four cards: sharded vs single solve

The main path is synthetic Snavely 9+3 bundle adjustment at BAL
problem-1778-993923 counts (1,778 cameras, 993,923 points, 5,000,000
observations, HuberLoss(1.0)), solved with ITERATIVE_SCHUR + SCHUR_JACOBI
on the fused device loop. Every phase prints one JSON object; the last line
is `{"ok": true, "device": {...}}` and appears only when every phase passed.
The script refuses to run without a GPU: a CPU run proves nothing here.

Times printed are smoke timings of single runs, not benchmark numbers.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# BAL problem-1778-993923 counts (Agarwal et al., "Bundle Adjustment in the
# Large"), generated synthetically as in bench.py.
NUM_CAMERAS, NUM_POINTS, NUM_OBSERVATIONS = 1778, 993_923, 5_000_000
BAL_KWARGS = dict(
    seed=3, observation_noise=2.0, perturb_points=0.5, perturb_rotation=0.02
)
HUBER_A = 1.0
JACOBIAN_SAMPLE = 4096
F32_ITERATIONS, MIXED_ITERATIONS, MULTICHIP_ITERATIONS = 5, 3, 3

# Tolerances (f32 on the card against f64 references):
# - cost: each f32 residual carries ~1e-7 relative rounding of the projected
#   pixel, and a tree-ordered f32 sum of 5M terms adds ~1e-6 relative.
COST_RTOL = 1e-5
# - residuals: rounding of the predicted pixel coordinate (~10 ulps of a
#   few hundred pixels) relative to the largest observed coordinate.
RESIDUAL_RTOL = 1e-5
# - Jacobian: f32 forward-mode derivatives vs f64 central differences
#   (~1e-10 truncation), relative to the block's largest entry.
JACOBIAN_RTOL = 1e-4
# - gradient: a few thousand f32 contributions per camera, each with the
#   residual's rounding, relative to the gradient norm.
GRADIENT_RTOL = 1e-4
# - solver matrix: both sides solve to function_tolerance 1e-8, because
#   at the default 1e-6 LM stops this problem ~5e-6 above its minimum (its
#   last steps decrease slowly). f32 then stops at its rounding floor: the
#   residuals of ~2 px are differences of ~300 px projections, each off by
#   ~1e-4 px, so the 4096-term cost is good to a few 1e-6 relative
#   (CPU rehearsal: f32 within 2e-6 of f64 for every solver).
SOLVER_RTOL = 1e-5
SOLVER_FUNCTION_TOLERANCE = 1e-8
# - four cards vs one: the same iterations with different f32 reduction
#   orders in every psum.
MULTICHIP_RTOL = 1e-5

SMALL_BA = (16, 512, 4096)  # cameras, points, observations


def emit(obj) -> None:
    print(json.dumps(obj, default=float), flush=True)


def gpu_device():
    """The first JAX device, which must be a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs an NVIDIA GPU; JAX found platform "
            f"{dev.platform!r}"
        )
    return dev


def card_name_and_power_limit() -> str:
    """nvidia-smi's name and power limit, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


# ---------------------------------------------------------------------- #
# plain f64 reference of the Snavely functor (independent of ceres_tpu)
# ---------------------------------------------------------------------- #


def snavely_residuals_np(cams, pts, obs):
    """BAL reprojection residuals [n, 2] in NumPy: angle-axis rotation
    (Rodrigues, with the small-angle form), negative-z projection, radial
    distortion 1 + k1 r^2 + k2 r^4 (snavely_reprojection_error.h)."""
    aa = cams[:, 0:3]
    theta2 = np.sum(aa * aa, axis=1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, 1e-32))
    axis = aa / theta
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    rotated = (
        cos_t * pts
        + sin_t * np.cross(axis, pts)
        + np.sum(axis * pts, axis=1, keepdims=True) * (1.0 - cos_t) * axis
    )
    rotated = np.where(theta2 < 1e-24, pts + np.cross(aa, pts), rotated)
    p = rotated + cams[:, 3:6]
    xp = -p[:, 0] / p[:, 2]
    yp = -p[:, 1] / p[:, 2]
    r2 = xp * xp + yp * yp
    scale = cams[:, 6] * (1.0 + r2 * (cams[:, 7] + cams[:, 8] * r2))
    return np.stack([scale * xp - obs[:, 0], scale * yp - obs[:, 1]], axis=1)


def huber_np(s, a=HUBER_A):
    """(rho, rho') of the Huber loss at squared norms s."""
    a2 = a * a
    r = np.sqrt(np.maximum(s, a2))
    rho = np.where(s > a2, 2.0 * a * r - a2, s)
    rho1 = np.where(s > a2, a / r, 1.0)
    return rho, rho1


def snavely_jacobian_np(cams, pts, obs):
    """Central-difference f64 Jacobian [n, 2, 12] (9 camera + 3 point
    columns) of snavely_residuals_np."""
    x = np.concatenate([cams, pts], axis=1)
    jac = np.empty((x.shape[0], 2, 12))
    for k in range(12):
        h = 1e-6 * np.maximum(1.0, np.abs(x[:, k]))
        xp, xm = x.copy(), x.copy()
        xp[:, k] += h
        xm[:, k] -= h
        rp = snavely_residuals_np(xp[:, :9], xp[:, 9:], obs)
        rm = snavely_residuals_np(xm[:, :9], xm[:, 9:], obs)
        jac[:, :, k] = (rp - rm) / (2.0 * h[:, None])
    return jac


def reference_evaluation_np(bal):
    """f64 cost, per-observation corrected residuals and rho', and the
    gradient as ([num_cameras, 9], [num_points, 3]) under HuberLoss."""
    cams = bal.cameras[bal.camera_index]
    pts = bal.points[bal.point_index]
    res = snavely_residuals_np(cams, pts, bal.observations)
    rho, rho1 = huber_np(np.sum(res * res, axis=1))
    cost = 0.5 * float(np.sum(rho))
    grad_cam = np.zeros(bal.cameras.shape)
    grad_pt = np.zeros(bal.points.shape)
    # the Jacobian in lane slices bounds the f64 temporaries
    step = 1_000_000
    for s in range(0, res.shape[0], step):
        sl = slice(s, s + step)
        jac = snavely_jacobian_np(cams[sl], pts[sl], bal.observations[sl])
        contrib = np.einsum("nr,nrk->nk", (rho1[sl, None] * res[sl]), jac)
        for k in range(9):
            grad_cam[:, k] += np.bincount(
                bal.camera_index[sl], contrib[:, k], bal.cameras.shape[0]
            )
        for k in range(3):
            grad_pt[:, k] += np.bincount(
                bal.point_index[sl], contrib[:, 9 + k], bal.points.shape[0]
            )
    return cost, res, rho1, grad_cam, grad_pt


# ---------------------------------------------------------------------- #
# problem construction
# ---------------------------------------------------------------------- #


def make_bal(num_cameras, num_points, num_observations):
    from ceres_tpu.io.bal import synthetic_bal

    return synthetic_bal(
        num_cameras, num_points, num_observations, **BAL_KWARGS
    )


def make_problem(bal):
    """A Problem over a private copy of `bal` (solves write back)."""
    from ceres_tpu import HuberLoss
    from ceres_tpu.io.bal import build_ba_problem

    return build_ba_problem(copy.deepcopy(bal), loss=HuberLoss(HUBER_A))


def block_gradient(program, grad, handles, size):
    """[len(handles), size] rows of a flat program-order tangent vector."""
    offs = program.t_offsets[np.asarray(handles)]
    return grad[offs[:, None] + np.arange(size)[None, :]]


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #


def phase_evaluation(bal, dev):
    """Full-width f32 evaluation against the NumPy f64 reference."""
    import jax
    import jax.numpy as jnp

    problem, cam_ids, pt_ids = make_problem(bal)
    program = problem.compile()
    ev = program.evaluator()
    state = program.state_vector(jnp.float32)
    t0 = time.perf_counter()
    cost, res, jac, grad = jax.block_until_ready(ev.evaluate(state))
    cost = float(cost)
    eval_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(ev.evaluate(state))
    eval_s = time.perf_counter() - t0

    ref_cost, ref_res, ref_rho1, ref_gc, ref_gp = reference_evaluation_np(bal)
    errors = {}
    errors["cost"] = abs(cost - ref_cost) / abs(ref_cost)

    grad = np.asarray(grad, np.float64)
    g = np.concatenate([
        block_gradient(program, grad, cam_ids, 9).ravel(),
        block_gradient(program, grad, pt_ids, 3).ravel(),
    ])
    g_ref = np.concatenate([ref_gc.ravel(), ref_gp.ravel()])
    errors["gradient"] = float(
        np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)
    )

    rng = np.random.default_rng(0)
    n = bal.observations.shape[0]
    sample = np.sort(rng.choice(n, min(JACOBIAN_SAMPLE, n), replace=False))
    lanes = np.array([program.handle_entry(0, int(i))[1] for i in sample])
    res = np.asarray(res, np.float64).reshape(-1, 2)[lanes]
    sqrt_rho1 = np.sqrt(ref_rho1[sample])[:, None]
    res_ref = sqrt_rho1 * ref_res[sample]
    errors["residuals"] = float(
        np.abs(res - res_ref).max()
        / np.abs(bal.observations[sample]).max()
    )
    jac_ref = sqrt_rho1[:, :, None] * snavely_jacobian_np(
        bal.cameras[bal.camera_index[sample]],
        bal.points[bal.point_index[sample]],
        bal.observations[sample],
    )
    cam_leaf, pt_leaf = jac.jac_groups[0]
    jl = jnp.asarray(lanes)
    jac_dev = np.concatenate([
        np.asarray(cam_leaf[:, jl], np.float64).reshape(2, 9, -1),
        np.asarray(pt_leaf[:, jl], np.float64).reshape(2, 3, -1),
    ], axis=1).transpose(2, 0, 1)  # [sample, 2, 12]
    per_block = np.abs(jac_dev - jac_ref).max(axis=(1, 2)) / np.abs(
        jac_ref
    ).max(axis=(1, 2))
    errors["jacobian"] = float(per_block.max())
    del jac, res, grad

    tolerances = dict(
        cost=COST_RTOL, residuals=RESIDUAL_RTOL, jacobian=JACOBIAN_RTOL,
        gradient=GRADIENT_RTOL,
    )
    ok = all(errors[k] <= tolerances[k] for k in tolerances)
    emit({
        "phase": "evaluation_f32",
        "ok": ok,
        "num_observations": int(n),
        "cost": cost,
        "reference_cost": ref_cost,
        "max_error": errors,
        "tolerance": tolerances,
        "jacobian_sample_blocks": int(sample.size),
        "smoke_first_call_s": eval_first_s,
        "smoke_eval_s": eval_s,
        "peak_bytes_in_use": peak_bytes(dev),
    })
    return ok


class FusedStepRecorder:
    """Compiles the fused LM chunk ahead of time on its first call, so its
    compile time and `memory_analysis()` can be reported."""

    def __init__(self):
        self.compile_s = None
        self.memory = None

    def __enter__(self):
        from ceres_tpu.solvers import fused_loop

        self._module = fused_loop
        self._orig = fused_loop.make_chunk_fn
        recorder = self

        def make_chunk_fn(*args, **kwargs):
            fn = recorder._orig(*args, **kwargs)
            compiled = []

            def call(*call_args):
                if not compiled:
                    t0 = time.perf_counter()
                    compiled.append(fn.lower(*call_args).compile())
                    recorder.compile_s = time.perf_counter() - t0
                    recorder.memory = _memory_dict(
                        compiled[0].memory_analysis()
                    )
                return compiled[0](*call_args)

            return call

        fused_loop.make_chunk_fn = make_chunk_fn
        return self

    def __exit__(self, *exc):
        self._module.make_chunk_fn = self._orig
        return False


def _memory_dict(ma):
    if ma is None:
        return None
    keys = (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def lm_options(iterations, mixed=False, mesh=None):
    import jax.numpy as jnp

    from ceres_tpu import (
        LinearSolverType,
        PreconditionerType,
        SolverOptions,
    )

    return SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        fused_execution=True,
        fused_execution_chunk_iters=1,
        max_num_iterations=iterations,
        eta=1e-1,
        max_linear_solver_iterations=25,
        use_mixed_precision_solves=mixed,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        dtype=jnp.float32,
        mesh=mesh,
    )


def check_descent(summary):
    """Finite costs that strictly decrease at every successful step."""
    costs = [it.cost for it in summary.iterations]
    if not all(np.isfinite(costs)) or not np.isfinite(summary.final_cost):
        return False
    prev = costs[0]
    for it in summary.iterations[1:]:
        if it.step_is_successful:
            if not it.cost < prev:
                return False
            prev = it.cost
    return summary.num_successful_steps > 0


def phase_lm(bal, mixed, iterations, dev):
    import ceres_tpu

    problem, _, _ = make_problem(bal)
    with FusedStepRecorder() as rec:
        t0 = time.perf_counter()
        summary = ceres_tpu.solve(lm_options(iterations, mixed), problem)
        total_s = time.perf_counter() - t0
    ok = bool(summary.used_fused_execution) and check_descent(summary)
    its = [it for it in summary.iterations if it.iteration > 0]
    emit({
        "phase": "lm_mixed" if mixed else "lm_f32",
        "ok": ok,
        "used_fused_execution": bool(summary.used_fused_execution),
        "termination": summary.termination_type.value,
        "initial_cost": summary.initial_cost,
        "final_cost": summary.final_cost,
        "costs": [it.cost for it in summary.iterations],
        "successful_steps": summary.num_successful_steps,
        "unsuccessful_steps": summary.num_unsuccessful_steps,
        "mean_pcg_iterations": float(
            np.mean([it.linear_solver_iterations for it in its])
        ) if its else 0.0,
        "smoke_iteration_host_s": [
            it.iteration_time_in_seconds for it in its
        ],
        "smoke_total_solve_s": total_s,
        "fused_step_compile_s": rec.compile_s,
        "fused_step_memory_analysis": rec.memory,
        "peak_bytes_in_use": peak_bytes(dev),
    })
    return ok


def solver_matrix():
    """(name, option overrides) of the small-problem solver matrix."""
    from ceres_tpu import (
        LinearSolverType as L,
        PreconditionerType as P,
        TrustRegionStrategyType as T,
    )

    return [
        ("DENSE_QR", dict(linear_solver_type=L.DENSE_QR)),
        ("DENSE_NORMAL_CHOLESKY",
         dict(linear_solver_type=L.DENSE_NORMAL_CHOLESKY)),
        ("DENSE_SCHUR", dict(linear_solver_type=L.DENSE_SCHUR)),
        ("ITERATIVE_SCHUR/JACOBI", dict(
            linear_solver_type=L.ITERATIVE_SCHUR,
            preconditioner_type=P.JACOBI)),
        ("ITERATIVE_SCHUR/SCHUR_JACOBI", dict(
            linear_solver_type=L.ITERATIVE_SCHUR,
            preconditioner_type=P.SCHUR_JACOBI)),
        ("CGNR", dict(linear_solver_type=L.CGNR)),
        ("SPARSE_NORMAL_CHOLESKY",
         dict(linear_solver_type=L.SPARSE_NORMAL_CHOLESKY)),
        ("DOGLEG/DENSE_SCHUR", dict(
            linear_solver_type=L.DENSE_SCHUR,
            trust_region_strategy_type=T.DOGLEG)),
    ]


def solve_matrix(dtype):
    """Final cost and termination of every solver-matrix entry on the small
    problem, in `dtype` on JAX's default device."""
    import ceres_tpu
    from ceres_tpu import SolverOptions

    bal = make_bal(*SMALL_BA)
    out = {}
    for name, overrides in solver_matrix():
        problem, _, _ = make_problem(bal)
        opts = SolverOptions(
            max_num_iterations=100, dtype=dtype,
            function_tolerance=SOLVER_FUNCTION_TOLERANCE,
            max_linear_solver_iterations=200, **overrides,
        )
        s = ceres_tpu.solve(opts, problem)
        out[name] = dict(
            final_cost=float(s.final_cost),
            termination=s.termination_type.value,
            iterations=len(s.iterations) - 1,
        )
    return out


def f64_reference(path):
    """Solver-matrix reference in f64 on the CPU: run in a child process
    with JAX_PLATFORMS=cpu, so it never opens the card."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from ceres_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    with open(path, "w") as f:
        json.dump(solve_matrix(jnp.float64), f)


def start_f64_reference(path):
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
        "chip_smoke.f64_reference(sys.argv[2])"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", code, here, path], env=env
    )


def phase_solver_matrix(child, path):
    import jax.numpy as jnp

    got = solve_matrix(jnp.float32)
    child.wait(timeout=900)
    if child.returncode != 0:
        raise RuntimeError(f"f64 reference child failed: {child.returncode}")
    with open(path) as f:
        ref = json.load(f)
    rows = {}
    ok = True
    for name, r in got.items():
        c64 = ref[name]["final_cost"]
        gap = abs(r["final_cost"] - c64) / abs(c64)
        converged = r["termination"] == "CONVERGENCE"
        row_ok = converged and gap <= SOLVER_RTOL
        ok = ok and row_ok
        rows[name] = dict(
            r, f64_final_cost=c64, f64_termination=ref[name]["termination"],
            relative_gap=gap, ok=row_ok,
        )
    emit({
        "phase": "solver_matrix_f32",
        "ok": ok,
        "problem": dict(zip(("cameras", "points", "observations"), SMALL_BA)),
        "tolerance": SOLVER_RTOL,
        "solvers": rows,
    })
    return ok


def phase_chip_tests():
    import pytest

    class Count:
        def __init__(self):
            self.passed = self.failed = self.skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1
            elif report.skipped:
                self.skipped += 1

    here = os.path.dirname(os.path.abspath(__file__))
    counter = Count()
    rc = pytest.main(
        ["-q", "-m", "chip", "-p", "no:cacheprovider",
         os.path.join(here, "tests_chip")],
        plugins=[counter],
    )
    ok = rc == 0 and counter.failed == 0 and counter.skipped == 0 and (
        counter.passed > 0
    )
    emit({
        "phase": "chip_tests", "ok": ok, "pytest_rc": int(rc),
        "passed": counter.passed, "failed": counter.failed,
        "skipped": counter.skipped,
    })
    return ok


def phase_multichip(bal, devices, iterations=MULTICHIP_ITERATIONS):
    """The main-path solve sharded over a 1-D mesh of `devices`, against
    the same solve on one device."""
    import ceres_tpu
    from jax.sharding import Mesh

    mesh = Mesh(np.array(devices), ("dp",))
    problem, _, _ = make_problem(bal)
    sharded = ceres_tpu.solve(lm_options(iterations, mesh=mesh), problem)
    peaks_sharded = [peak_bytes(d) for d in devices]
    problem, _, _ = make_problem(bal)
    single = ceres_tpu.solve(lm_options(iterations), problem)
    gap = abs(sharded.final_cost - single.final_cost) / abs(single.final_cost)
    ok = (
        bool(sharded.used_fused_execution)
        and bool(single.used_fused_execution)
        and check_descent(sharded)
        and len(sharded.iterations) == len(single.iterations)
        and gap <= MULTICHIP_RTOL
    )
    emit({
        "phase": "multichip",
        "ok": ok,
        "devices": len(devices),
        "iterations": len(sharded.iterations) - 1,
        "sharded_final_cost": sharded.final_cost,
        "single_final_cost": single.final_cost,
        "sharded_costs": [it.cost for it in sharded.iterations],
        "single_costs": [it.cost for it in single.iterations],
        "relative_gap": gap,
        "tolerance": MULTICHIP_RTOL,
        "peak_bytes_in_use_per_device_after_sharded": peaks_sharded,
        "peak_bytes_in_use_per_device": [peak_bytes(d) for d in devices],
    })
    return ok


# ---------------------------------------------------------------------- #
# entry point
# ---------------------------------------------------------------------- #


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--multichip", action="store_true",
        help="run only the 4-card sharded-vs-single comparison",
    )
    args = ap.parse_args(argv)

    import jax

    from ceres_tpu.utils.compile_cache import enable_compile_cache

    dev = gpu_device()
    enable_compile_cache()
    devices = jax.devices()
    emit({
        "phase": "device",
        "devices": [str(d) for d in devices],
        "device_kind": dev.device_kind,
        "jax": jax.__version__,
    })
    print(card_name_and_power_limit(), flush=True)

    bal = make_bal(NUM_CAMERAS, NUM_POINTS, NUM_OBSERVATIONS)
    if args.multichip:
        if len(devices) < 4:
            raise RuntimeError(f"--multichip needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        ok = phase_multichip(bal, devices)
    else:
        devices = devices[:1]
        with tempfile.TemporaryDirectory() as tmp:
            ref_path = os.path.join(tmp, "f64_reference.json")
            child = start_f64_reference(ref_path)
            try:
                ok = phase_evaluation(bal, dev)
                ok = phase_lm(bal, False, F32_ITERATIONS, dev) and ok
                ok = phase_lm(bal, True, MIXED_ITERATIONS, dev) and ok
                ok = phase_solver_matrix(child, ref_path) and ok
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        ok = phase_chip_tests() and ok
    if not ok:
        return 1
    emit({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
