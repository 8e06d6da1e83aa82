"""Micro-benchmark suite: per-layer timings with JSON output, on the GPU.

Role of the reference's Google-Benchmark tier
(internal/ceres/CMakeLists.txt:603-641: spmv_benchmark.cc,
evaluation_benchmark.cc, schur_eliminator_benchmark.cc,
jet_operator_benchmark.cc, block_jacobi_preconditioner_benchmark.cc):
when the end-to-end numbers move, this localizes the change to one layer.
One JSON line per benchmark; the first line names the device.

Usage (on a machine with an NVIDIA GPU; there is no CPU mode):
    python benchmarks/micro.py                      # BAL-1778 scale
    python benchmarks/micro.py --only eval,gather,reduce
    python benchmarks/micro.py --only eval --trace traces/eval

Each timing is a jitted function, one warmup call, then `reps` calls that
each end in block_until_ready.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceres_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def timed(name, fn, *args, reps=10, **meta):
    """Mean wall time of `reps` calls of jit(fn), each waited for, with
    XLA's own count of the bytes the compiled program accesses."""
    f = jax.jit(fn)
    cost = f.lower(*args).compile().cost_analysis() or {}
    if isinstance(cost, list):
        cost = cost[0] if cost else {}
    meta = dict(meta, xla_bytes_accessed=cost.get("bytes accessed"),
                xla_flops=cost.get("flops"))
    jax.block_until_ready(f(*args))  # compile + warmup
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(f(*args))
    ms = (time.perf_counter() - t0) / reps * 1000.0
    line = {"benchmark": name, "ms": ms, "reps": reps}
    line.update(meta)
    print(json.dumps(line), flush=True)
    return out


def _problem(scale):
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal

    bal = synthetic_bal(
        max(2, int(1778 * scale)),
        max(16, int(993_923 * scale)),
        max(64, int(5_000_000 * scale)),
        seed=1,
    )
    problem, _, _ = build_ba_problem(bal)
    program = problem.compile()
    return program, int(bal.num_observations)


def bench_eval(program, n, trace_dir=None):
    """Group evaluation, residual-only and residual + Jacobian + gradient
    (the role of evaluation_benchmark.cc). With `trace_dir`, a profiler
    trace of three calls of each follows the timings."""
    from ceres_tpu.evaluator import evaluate

    arrays = program.arrays(jnp.float32)
    state = program.state_vector(jnp.float32)

    def f_res(a, s):
        c, r, _, _ = evaluate(program, a, s, with_jacobian=False)
        return c, r

    def f_jac(a, s):
        # the gradient is not returned, so XLA drops its reduction
        c, r, j, _ = evaluate(program, a, s, with_jacobian=True)
        return c, r, j.jac_groups

    def f_full(a, s):
        c, r, j, g = evaluate(program, a, s, with_jacobian=True)
        return c, r, g, j.jac_groups

    timed("eval_residual", f_res, arrays, state, n_obs=n)
    timed("eval_jac_residual", f_jac, arrays, state, n_obs=n)
    timed("eval_jac_residual_grad", f_full, arrays, state, n_obs=n)
    if trace_dir:
        fns = [jax.jit(f) for f in (f_res, f_jac, f_full)]
        with jax.profiler.trace(trace_dir):
            for f in fns:
                for _ in range(3):
                    jax.block_until_ready(f(arrays, state))


def bench_reduce(program, n):
    """Deterministic reduction plans: bucket reshape-sum vs one-hot
    matmul vs segment_sum (the reference's atomicAdd-analog tier;
    spmv_benchmark.cc role)."""
    from ceres_tpu.jacobian import reduce_T

    meta = program.groups[0]
    idx = program.group_idx[0]
    k = 6
    contrib = jnp.asarray(np.random.RandomState(0).randn(k, meta.n), jnp.float32)
    for pos in range(len(meta.positions)):
        pm = meta.positions[pos]
        cnt = program.tangent_class_counts[pm.t_cls]
        rows = jnp.asarray(idx["t_rows"][pos])
        plan = (meta.red_plans or {}).get(pos)
        kind = plan[0] if plan else "segsum"
        f = jax.jit(
            lambda c, r, _p=plan: reduce_T(_p, c, r, cnt + 1)
        )
        timed(f"reduce_{kind}_pos{pos}", f, contrib, rows, n_obs=meta.n, out=cnt)
        if kind != "segsum":  # also time the generic fallback for contrast
            f2 = jax.jit(lambda c, r: reduce_T(None, c, r, cnt + 1))
            timed(f"reduce_segsum_pos{pos}", f2, contrib, rows, n_obs=meta.n, out=cnt)


def bench_gather(program, n):
    """Parameter-gather variants [cnt, s] table -> [s, n] lanes: the
    camera-side gather inside every partitioned product (one-hot matmul
    vs row-take+transpose vs lane-axis take)."""
    from ceres_tpu.jacobian import gather_T

    meta = program.groups[0]
    idx = program.group_idx[0]
    # camera position = the non-owner position
    pos = 0 if meta.owner != 0 else 1
    pm = meta.positions[pos]
    cnt = program.tangent_class_counts[pm.t_cls]
    rows = jnp.asarray(idx["t_rows"][pos])
    table = jnp.asarray(
        np.random.RandomState(0).randn(cnt + 1, pm.tangent_size), jnp.float32
    )

    f1 = jax.jit(lambda t, r: gather_T(("onehot",), t, r))
    timed("gather_onehot", f1, table, rows, n_obs=meta.n, cnt=cnt)
    f2 = jax.jit(lambda t, r: jnp.take(t, r, axis=0).T)
    timed("gather_take_T", f2, table, rows, n_obs=meta.n, cnt=cnt)
    f3 = jax.jit(lambda t, r: t.T[:, r])
    timed("gather_lane_axis", f3, table, rows, n_obs=meta.n, cnt=cnt)


def bench_pcg(program, n):
    """One implicit-Schur PCG iteration (4 partitioned products +
    preconditioner), and the SCHUR_JACOBI preconditioner build
    (block_jacobi_preconditioner_benchmark / schur_eliminator_benchmark
    roles)."""
    from ceres_tpu.linalg.preconditioners import BlockDiagSolver
    from ceres_tpu.linalg.schur import (
        make_ete_solver,
        schur_jacobi_blocks,
        schur_views,
    )

    from ceres_tpu.evaluator import Evaluator

    ev = Evaluator(program, dtype=jnp.float32)
    state = program.state_vector(jnp.float32)
    _c, _r, jac, grad = ev.evaluate_groups(state)
    e_np, f_np = program.schur_tangent_masks()
    dsq = jnp.full((program.num_effective_parameters,), 0.1, jnp.float32)
    dsq_e = dsq * jnp.asarray(e_np, jnp.float32)
    dsq_f = dsq * jnp.asarray(f_np, jnp.float32)

    # Everything large rides as traced ARGUMENTS (BlockJacobian is a
    # pytree): a closure would bake the [26 x 5M] Jacobian into the
    # program as constants.
    def build_prec(jac, g):
        jac_e, jac_f = schur_views(program, jac)
        ete = make_ete_solver(program, jac_e, dsq_e)
        return schur_jacobi_blocks(program, jac_e, jac_f, ete, dsq_f), dict(
            ete.inv_tables
        )

    out = timed("schur_jacobi_precond_build", build_prec, jac, grad, n_obs=n)
    blocks, ete_tables = out

    @jax.jit
    def prec_tables_of(blocks):
        return dict(BlockDiagSolver(program, blocks).inv_tables)

    prec_tables = prec_tables_of(list(blocks))

    def s_apply_prec(jac, y, ete_tables, prec_tables):
        jac_e, jac_f = schur_views(program, jac)
        ete = BlockDiagSolver.from_inverse_tables(program, ete_tables)
        prec = BlockDiagSolver.from_inverse_tables(program, prec_tables)
        t1 = jac_f.right_multiply(y)
        t2 = ete(jac_e.left_multiply(t1))
        et2 = jac_e.right_multiply(t2)
        diff = [a - b for a, b in zip(t1, et2)]
        sy = jac_f.left_multiply(diff) + dsq_f * y
        return prec(sy)

    timed(
        "pcg_iteration_implicit_schur",
        s_apply_prec,
        jac,
        grad,
        ete_tables,
        prec_tables,
        n_obs=n,
    )


def bench_chunk(program, n, scale):
    """One fused LM chunk (6 iterations of eval+PCG+acceptance inside a
    single device program) — the end-to-end hot dispatch."""
    import ceres_tpu
    from ceres_tpu import HuberLoss
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal
    from ceres_tpu.types import (
        LinearSolverType,
        PreconditionerType,
        SolverOptions,
    )

    bal = synthetic_bal(
        max(2, int(1778 * scale)),
        max(16, int(993_923 * scale)),
        max(64, int(5_000_000 * scale)),
        seed=3,
        observation_noise=2.0,
        perturb_points=0.5,
    )
    problem, _, _ = build_ba_problem(bal, loss=HuberLoss(1.0))
    options = SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        fused_execution_chunk_iters=6,
        max_num_iterations=12,
        eta=1e-1,
        max_linear_solver_iterations=25,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
    )
    t0 = time.perf_counter()
    s = ceres_tpu.solve(options, problem)
    total = time.perf_counter() - t0
    es = s.execution_summary
    chunks = es.calls("FusedLoop::Chunk")
    print(
        json.dumps(
            {
                "benchmark": "fused_chunk_6it",
                "ms": round(es.seconds("FusedLoop::Chunk") / max(chunks, 1) * 1000, 1),
                "chunks": chunks,
                "iterations": len(s.iterations) - 1,
                "total_s": round(total, 1),
                "note": "first chunk includes jit compile",
            }
        ),
        flush=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", type=str, default="eval,reduce,gather,pcg,chunk")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a profiler trace of the evaluation here")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"micro.py measures the GPU; JAX found {dev.platform}")
    enable_compile_cache()
    which = set(args.only.split(","))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(
        json.dumps({
            "suite": "micro", "platform": dev.platform,
            "device_kind": dev.device_kind, "device_count": len(jax.devices()),
            "card": card, "scale": args.scale,
        }),
        flush=True,
    )
    program, n = _problem(args.scale)
    if "eval" in which:
        bench_eval(program, n, args.trace)
    if "reduce" in which:
        bench_reduce(program, n)
    if "gather" in which:
        bench_gather(program, n)
    if "pcg" in which:
        bench_pcg(program, n)
    if "chunk" in which:
        bench_chunk(program, n, args.scale)


if __name__ == "__main__":
    main()
