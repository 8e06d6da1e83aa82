"""Component-level profile of the implicit-Schur PCG iteration (tvec form).

Every measurement chains the operation x20 inside one lax.fori_loop and
reports ms per application — the same regime as the real fused-loop PCG (a
lax.while_loop). Variants isolate the camera-side (one-hot matmul) and
point-side (bucket slice/reduce) halves of S·y. Runs on the GPU only:

    python benchmarks/schur_profile.py [--scale 1.0]
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceres_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

LOOP = 20


def timed_loop(name, step_fn, init, *args, reps=5, **meta):
    """Time LOOP chained applications of step_fn inside one fori_loop.

    step_fn(v, *args) -> v-like pytree; normalized per iteration so values
    stay finite. Reports ms per single application.
    """

    @jax.jit
    def run(v, *a):
        def body(i, v):
            out = step_fn(v, *a)
            nrm = sum(
                jnp.sum(o.astype(jnp.float32) ** 2)
                for o in jax.tree_util.tree_leaves(out)
            )
            scale = jax.lax.rsqrt(nrm + 1e-30)
            return jax.tree_util.tree_map(
                lambda o: (o.astype(jnp.float32) * scale).astype(o.dtype), out
            )

        out = jax.lax.fori_loop(0, LOOP, body, v)
        s = sum(
            jnp.sum(o.astype(jnp.float32))
            for o in jax.tree_util.tree_leaves(out)
        )
        return s

    float(run(init, *args))  # compile + warmup
    t0 = time.perf_counter()
    for _ in range(reps):
        float(run(init, *args))
    dt = (time.perf_counter() - t0) / reps
    per_iter_ms = dt / LOOP * 1000
    print(
        json.dumps(
            {"benchmark": name, "ms_per_apply": per_iter_ms, **meta}
        ),
        flush=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"schur_profile.py measures the GPU; JAX found {dev.platform}"
        )
    enable_compile_cache()
    print(json.dumps({"suite": "schur_profile", "device_kind": dev.device_kind,
                      "scale": args.scale}), flush=True)

    from ceres_tpu import HuberLoss
    from ceres_tpu.evaluator import Evaluator
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal
    from ceres_tpu.linalg.preconditioners import BlockDiagSolver
    from ceres_tpu.linalg.schur import (
        make_ete_solver,
        schur_jacobi_blocks,
        schur_views,
    )

    n_cam = max(4, int(1778 * args.scale))
    n_pt = max(32, int(993_923 * args.scale))
    n_obs = max(128, int(5_000_000 * args.scale))
    bal = synthetic_bal(n_cam, n_pt, n_obs, seed=3)
    problem, _, _ = build_ba_problem(bal, loss=HuberLoss(1.0))
    program = problem.compile()

    ev = Evaluator(program, dtype=jnp.float32)
    state = program.state_vector(jnp.float32)
    _c, _r, jac0, grad = ev.evaluate_groups(state)
    e_np, f_np = program.schur_tangent_masks()
    dsq = jnp.full((program.num_effective_parameters,), 0.1, jnp.float32)
    dsq_e = dsq * jnp.asarray(e_np, jnp.float32)
    dsq_f = dsq * jnp.asarray(f_np, jnp.float32)

    scale_v = jax.jit(
        lambda j: 1.0 / (1.0 + jnp.sqrt(j.squared_column_norms()))
    )(jac0)
    jac = jax.jit(lambda j, s: j.scale_columns(s).materialize_scale())(
        jac0, scale_v
    )

    @jax.jit
    def setup(jac):
        jac_e, jac_f = schur_views(program, jac)
        ete = make_ete_solver(program, jac_e, dsq_e)
        blocks = schur_jacobi_blocks(program, jac_e, jac_f, ete, dsq_f)
        prec_tables = dict(BlockDiagSolver(program, blocks).inv_tables)
        from ceres_tpu.linalg.schur import _pure_class_split, _shrink_tvec

        f_set = _pure_class_split(program)[0]
        dsq_f_tv = _shrink_tvec(jac.tvec(dsq_f), f_set)
        return dict(ete.inv_tables), prec_tables, dsq_f_tv

    ete_tables, prec_tables, dsq_f_tv = setup(jac)

    y = jnp.asarray(
        np.random.default_rng(0).normal(
            0, 1, program.num_effective_parameters
        ),
        jnp.float32,
    ) * jnp.asarray(f_np, jnp.float32)
    from ceres_tpu.linalg.schur import _pure_class_split as _pcs, _shrink_tvec as _sh
    _fset = _pcs(program)[0]
    y_tv = jax.jit(lambda j, v: _sh(j.tvec(v), _fset))(jac, y)

    def views(jac):
        return schur_views(program, jac)

    # ---- realistic PCG-iteration bodies (dsq_f_tv precomputed) ---------
    # f-only CG vectors (schur._pure_class_split): e-class tables ride as
    # zero-width stand-ins, exactly like the production tvec PCG
    from ceres_tpu.linalg.schur import _pure_class_split, _shrink_tvec

    f_set = _pure_class_split(program)[0]

    def s_apply(v_tv, jac, ete_tables, dsq_f_tv):
        jac_e, jac_f = views(jac)
        ete = BlockDiagSolver.from_inverse_tables(program, ete_tables)
        t1 = jac_f.right_multiply_t(v_tv)
        t2 = ete.apply_t(jac_e.left_multiply_t(t1))
        et2 = jac_e.right_multiply_t(t2)
        diff = [a - b for a, b in zip(t1, et2)]
        out = _shrink_tvec(jac_f.left_multiply_t(diff), f_set)
        return [o + d * v for o, d, v in zip(out, dsq_f_tv, v_tv)]

    def pcg_body(v_tv, jac, ete_tables, prec_tables, dsq_f_tv):
        prec = BlockDiagSolver.from_inverse_tables(program, prec_tables)
        sy = s_apply(v_tv, jac, ete_tables, dsq_f_tv)
        z = prec.apply_t(sy)
        # representative CG vector algebra: 2 dots + 2 axpys
        rho = sum(jnp.sum(a * b) for a, b in zip(sy, z))
        pap = sum(jnp.sum(a * a) for a in z)
        alpha = rho / (pap + 1e-30)
        return [v + alpha * zz for v, zz in zip(v_tv, z)]

    timed_loop(
        "pcg_body", pcg_body, y_tv, jac, ete_tables, prec_tables, dsq_f_tv,
        reps=args.reps,
    )
    timed_loop(
        "s_apply", s_apply, y_tv, jac, ete_tables, dsq_f_tv, reps=args.reps
    )

    # camera half only: F y then F^T (F y)
    def cam_half(v_tv, jac):
        _, jac_f = views(jac)
        t1 = jac_f.right_multiply_t(v_tv)
        return _shrink_tvec(jac_f.left_multiply_t(t1), f_set)

    timed_loop("cam_F_then_Ft", cam_half, y_tv, jac, reps=args.reps)

    # point half only: treat t1 as given residual groups; E^T u, ete, E t2
    def pt_half(u_groups, jac, ete_tables):
        jac_e, _ = views(jac)
        ete = BlockDiagSolver.from_inverse_tables(program, ete_tables)
        t2 = ete.apply_t(jac_e.left_multiply_t(list(u_groups)))
        return tuple(jac_e.right_multiply_t(t2))

    t1_init = tuple(jax.jit(
        lambda j, v: views(j)[1].right_multiply_t(v)
    )(jac, y_tv))
    timed_loop("pt_Et_ete_E", pt_half, t1_init, jac, ete_tables, reps=args.reps)

    # preconditioner apply only
    def prec_only(v_tv, prec_tables):
        prec = BlockDiagSolver.from_inverse_tables(program, prec_tables)
        return prec.apply_t(v_tv)

    timed_loop("prec_apply_t", prec_only, y_tv, prec_tables, reps=args.reps)

    # CG vector algebra only (dots + axpys at tvec shapes)
    def algebra_only(v_tv):
        rho = sum(jnp.sum(a * a) for a in v_tv)
        return [v * (1.0 + 1e-9 * rho) for v in v_tv]

    timed_loop("tvec_algebra", algebra_only, y_tv, reps=args.reps)

    # bf16 variant of the full body
    jac16 = jax.jit(lambda j: j.astype(jnp.bfloat16))(jac)
    timed_loop(
        "pcg_body_bf16", pcg_body, y_tv, jac16, ete_tables, prec_tables,
        dsq_f_tv, reps=args.reps,
    )


if __name__ == "__main__":
    main()
