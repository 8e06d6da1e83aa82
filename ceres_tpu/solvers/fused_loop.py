"""Device-fused trust-region execution: whole LM iterations inside one
compiled while_loop.

The reference's outer loop (trust_region_minimizer.cc:66-124) is host code
orchestrating device work; its per-iteration cost is dominated by D2H
Jacobian transfers (README.md:198-200). Here the equivalent risk is
dispatch latency: the host loop issues 4-6 device calls and fetches several
scalars per iteration. This module compiles CHUNKS of complete LM
iterations — step solve (with its inner PCG while_loop), Plus, candidate
cost, non-monotonic step evaluation, radius update, convergence tests, and
the conditional Jacobian re-evaluation — into ONE device program driven by
`lax.while_loop`. The host sees one dispatch + one small stats fetch per
chunk and replays the recorded per-iteration rows into Summary/logging.

Eligibility (the host loop in trust_region.py remains the general path):
jittable step function, no inner iterations, no user callbacks, no
evaluation callback, no update_state_every_iteration. Bounds run fused:
Plus clamps to the box, the active-set mask zeroes frozen columns, the
projected Armijo search and projected gradient norms are in-graph. Both unsharded and
sharded evaluators are supported — `make_chunk_fn` builds the chunk inside
`shard_map` when given a ShardedEvaluator, so the fused loop also runs the
multi-chip path. Behavioral parity with the host loop is bit-for-bit in the
decision logic (same order of convergence tests, same radius/step-evaluator
arithmetic); only wall-clock bookkeeping differs (per-iteration times are
amortized chunk times).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..types import IterationSummary, TerminationType

# termination codes inside the fused loop
_CONTINUE = 0
_PARAM_TOL = 1
_FUNC_TOL = 2
_GRAD_TOL = 3
_MIN_RADIUS = 4
_INVALID_FAIL = 5
_EVAL_FAIL = 6

_TERM_MAP = {
    _PARAM_TOL: (TerminationType.CONVERGENCE, "Parameter tolerance reached."),
    _FUNC_TOL: (TerminationType.CONVERGENCE, "Function tolerance reached."),
    _GRAD_TOL: (TerminationType.CONVERGENCE, "Gradient tolerance reached."),
    _MIN_RADIUS: (
        TerminationType.CONVERGENCE,
        "Minimum trust region radius reached.",
    ),
    _INVALID_FAIL: (
        TerminationType.FAILURE,
        "Maximum number of consecutive invalid steps.",
    ),
    _EVAL_FAIL: (
        TerminationType.FAILURE,
        "Residual/Jacobian evaluation failed at accepted point.",
    ),
}

# stats row layout (floats)
_N_STATS = 10
(
    _S_COST,
    _S_CHANGE,
    _S_GMAX,
    _S_GNORM,
    _S_RADIUS,
    _S_STEPNORM,
    _S_RELDEC,
    _S_LINITERS,
    _S_FLAGS,  # 1 = valid, +2 = successful
    _S_TERM,
) = range(_N_STATS)

CHUNK_ITERS = 20


def chunk_iters(options) -> int:
    """Chunk length: options.fused_execution_chunk_iters, else the module
    default (kept as a module constant so tests can shrink it globally)."""
    n = getattr(options, "fused_execution_chunk_iters", 0)
    return n if n and n > 0 else CHUNK_ITERS


def eligible(program, options, evaluator, raw_step_fn) -> bool:
    # bounds and the trust-region Armijo polish run fused: the active-set
    # column masking, projected gradient norms, and the projected line
    # search are all in-graph (see make_chunk_fn) — bounded BA keeps the
    # headline fused path.
    from ..types import PreconditionerType

    # sharded + visibility clustering runs the host loop on the GLOBAL
    # view (GSPMD) — the assembly's host-planned gathers cannot run inside
    # the chunk's shard_map (trust_region cluster_gspmd path)
    sharded_cluster = hasattr(evaluator, "wrap_step_fn") and (
        options.preconditioner_type
        in (
            PreconditionerType.CLUSTER_JACOBI,
            PreconditionerType.CLUSTER_TRIDIAGONAL,
        )
    )
    return (
        getattr(options, "fused_execution", True)
        and getattr(raw_step_fn, "jittable", True)
        and not sharded_cluster
        and not options.use_inner_iterations
        and not options.callbacks
        and not options.update_state_every_iteration
        and not options.trust_region_minimizer_iterations_to_dump
        and getattr(program, "evaluation_callback", None) is None
    )


def make_chunk_fn(program, options, step_fn, sharded_evaluator=None):
    """Build the jitted chunk runner.

    With `sharded_evaluator` set (a parallel.sharding.ShardedEvaluator), the
    entire chunk — including every LM iteration's evaluation, PCG solve, and
    reductions — runs inside one shard_map over the evaluator's mesh:
    residual/Jacobian leaves stay lane-sharded across devices, tangent-space
    reductions psum over the axis, and the trust-region scalar state is
    replicated (the BASELINE north-star execution shape)."""
    from ..evaluator import evaluate, plus as plus_fn
    from ..jacobian import BlockJacobian

    axis = sharded_evaluator.axis if sharded_evaluator is not None else None

    ftol = options.function_tolerance
    ptol = options.parameter_tolerance
    gtol = options.gradient_tolerance
    min_rel = options.min_relative_decrease
    max_radius = options.max_trust_region_radius
    min_radius = options.min_trust_region_radius
    max_invalid = options.max_num_consecutive_invalid_steps
    nonmono = (
        options.max_consecutive_nonmonotonic_steps
        if options.use_nonmonotonic_steps
        else 0
    )

    def eval_jac(arrays, state):
        cost, res, jac, grad = evaluate(
            program, arrays, state, with_jacobian=True, axis_name=axis
        )
        return cost, tuple(res), (jac.jac_groups, jac.t_rows, jac.col_scale), grad

    def cost_only(arrays, state):
        return evaluate(
            program, arrays, state, with_jacobian=False, axis_name=axis
        )[0]

    has_bounds = getattr(program, "has_bounds", False)
    # prepare/finish split (strategies.make_lm_step_fn / dogleg): reuse the
    # J-dependent prepare cache across rejected steps. Disabled with bounds
    # (the active-set mask changes the effective scale per iteration, which
    # invalidates the cached grams).
    use_split = hasattr(step_fn, "prepare") and not has_bounds
    use_ls = (
        (has_bounds or options.trust_region_use_line_search)
        and options.max_num_line_search_step_size_iterations > 0
    )
    if has_bounds:
        t_idx_np, a_idx_np = program.bound_coordinate_maps()
        t_idx = jnp.asarray(t_idx_np, jnp.int32)
        a_idx = jnp.asarray(a_idx_np, jnp.int32)

    def bound_mask(arrays, state, grad):
        """Active-set mask over tangent coordinates (0 where the coordinate
        sits at a bound and -g points outward) — the in-graph twin of
        TrustRegionMinimizer._active_bound_mask."""
        x = state[a_idx]
        g = grad[t_idx]
        lo = arrays["lower_bound"][a_idx]
        hi = arrays["upper_bound"][a_idx]
        active = ((x <= lo) & (g > 0)) | ((x >= hi) & (g < 0))
        return jnp.ones(
            program.num_effective_parameters, dtype=state.dtype
        ).at[t_idx].set(jnp.where(active, 0.0, 1.0).astype(state.dtype))

    def grad_norms(arrays, state, grad):
        """(max, norm) of the (projected, when bounded) gradient
        (trust_region_minimizer.cc:270-295)."""
        if not has_bounds:
            return jnp.max(jnp.abs(grad)), jnp.linalg.norm(grad)
        diff = state - plus_fn(program, arrays, state, -grad)
        return jnp.max(jnp.abs(diff)), jnp.linalg.norm(diff)

    c1_ls = options.line_search_sufficient_function_decrease
    max_ls = options.max_num_line_search_step_size_iterations
    min_ls_step = options.min_line_search_step_size
    ls_max_contract = options.max_line_search_step_contraction
    ls_min_contract = options.min_line_search_step_contraction

    def projected_line_search(arrays, state, delta, cost, grad, valid):
        """In-graph Armijo backtracking on cost(Plus(x, a*delta)) — the
        fused twin of TrustRegionMinimizer._projected_line_search (search
        failure keeps the full step, as the host loop does). Returns
        (delta', num_cost_evals)."""
        dtype = delta.dtype
        dphi0 = jnp.vdot(grad, delta)
        run = jnp.logical_and(valid, jnp.isfinite(dphi0) & (dphi0 < 0.0))

        def do_search(_):
            def cond(s):
                it, alpha, _best, done, _ev = s
                return (it < max_ls) & ~done & (alpha >= min_ls_step)

            def body(s):
                it, alpha, best, done, ev = s
                f = cost_only(
                    arrays, plus_fn(program, arrays, state, alpha * delta)
                )
                ok = jnp.isfinite(f) & (f <= cost + c1_ls * alpha * dphi0)
                denom = 2.0 * (f - cost - dphi0 * alpha)
                new_alpha = jnp.where(
                    jnp.isfinite(denom) & (denom > 0),
                    -dphi0 * alpha * alpha / denom,
                    0.5 * alpha,
                )
                new_alpha = jnp.clip(
                    new_alpha, alpha * ls_max_contract, alpha * ls_min_contract
                )
                return (
                    it + 1,
                    jnp.where(ok, alpha, new_alpha),
                    jnp.where(ok, alpha, best),
                    done | ok,
                    ev + 1,
                )

            _, _, best, done, ev = jax.lax.while_loop(
                cond,
                body,
                (
                    jnp.asarray(0, jnp.int32),
                    jnp.asarray(1.0, dtype),
                    jnp.asarray(1.0, dtype),
                    jnp.asarray(False),
                    jnp.asarray(0, jnp.int32),
                ),
            )
            return jnp.where(done, best, 1.0), ev

        def skip(_):
            return jnp.asarray(1.0, dtype), jnp.asarray(0, jnp.int32)

        alpha, ev = jax.lax.cond(run, do_search, skip, None)
        return alpha * delta, ev

    def chunk_fn(arrays, state, cost, res, jac_children, grad, scale, radius,
                 df, ninv, se, limit, pcache):
        dtype = state.dtype

        def cond(c):
            return jnp.logical_and(c["it"] < limit, c["term"] == _CONTINUE)

        def body(c):
            jac = BlockJacobian.tree_unflatten(
                (program, axis, None), c["jac"]
            )
            if has_bounds:
                iter_scale = scale * bound_mask(arrays, c["state"], c["grad"])
            else:
                iter_scale = scale
            if use_split:
                # prepare/finish split: the J-dependent grams in c["pcache"]
                # are valid while steps are rejected; finish applies only
                # the dsq-dependent work
                delta, mcc, lin_iters, valid = step_fn.finish(
                    jac, list(c["res"]), c["grad"], c["radius"], iter_scale,
                    c["pcache"],
                )
            else:
                delta, mcc, lin_iters, valid = step_fn(
                    jac, list(c["res"]), c["grad"], c["radius"], iter_scale
                )
            nls_new = jnp.asarray(0, jnp.int32)
            if use_ls:
                delta, nls_new = projected_line_search(
                    arrays, c["state"], delta, c["cost"], c["grad"], valid
                )

            # ---- invalid-step path (HandleInvalidStep) ----
            ninv1 = jnp.where(valid, 0, c["ninv"] + 1)
            inv_fail = jnp.logical_and(~valid, ninv1 >= max_invalid)
            r_shrunk = c["radius"] / c["df"]
            df_grown = 2.0 * c["df"]
            inv_minrad = jnp.logical_and(~valid, r_shrunk < min_radius)

            # ---- candidate evaluation ----
            candidate = plus_fn(program, arrays, c["state"], delta)
            new_cost = cost_only(arrays, candidate)
            finite_new = jnp.isfinite(new_cost)
            if has_bounds:
                # the projected candidate can move less than |delta|:
                # measure the realized ambient step (host-loop parity)
                step_norm = jnp.linalg.norm(c["state"] - candidate)
            else:
                step_norm = jnp.linalg.norm(delta)
            x_norm = jnp.linalg.norm(c["state"])
            cost_change = c["cost"] - new_cost

            t_param = jnp.logical_and(
                valid, step_norm <= ptol * (x_norm + ptol)
            )
            t_func = jnp.logical_and(
                jnp.logical_and(valid, ~t_param),
                jnp.logical_and(
                    finite_new, jnp.abs(cost_change) <= ftol * c["cost"]
                ),
            )
            proceed = jnp.logical_and(valid, ~t_param & ~t_func)

            # ---- non-monotonic step quality (TrustRegionStepEvaluator) ----
            se_cur, se_min, se_ref, se_cand, se_aref, se_acand, se_n = c["se"]
            safe_mcc = jnp.where(mcc != 0, mcc, 1.0)
            rd_classic = (se_cur - new_cost) / safe_mcc
            rd_hist = (se_ref - new_cost) / jnp.where(
                se_aref + mcc != 0, se_aref + mcc, 1.0
            )
            rel_dec = jnp.maximum(rd_classic, rd_hist)
            successful = jnp.logical_and(
                proceed, jnp.logical_and(finite_new, rel_dec > min_rel)
            )

            # step-evaluator state update (only when successful)
            cur2 = new_cost
            acand2 = se_acand + mcc
            aref2 = se_aref + mcc
            is_new_min = cur2 < se_min
            min2 = jnp.where(is_new_min, cur2, se_min)
            n2 = jnp.where(is_new_min, 0, se_n + 1)
            cand2 = jnp.where(
                is_new_min, cur2, jnp.where(cur2 > se_cand, cur2, se_cand)
            )
            acand2 = jnp.where(
                is_new_min,
                0.0,
                jnp.where(cur2 > se_cand, 0.0, acand2),
            )
            hit = n2 == nonmono
            ref2 = jnp.where(hit, cand2, se_ref)
            aref2 = jnp.where(hit, acand2, aref2)
            se_new = tuple(
                jnp.where(successful, a, b)
                for a, b in zip(
                    (cur2, min2, ref2, cand2, aref2, acand2, n2),
                    c["se"],
                )
            )

            # ---- radius / damping update ----
            r_grow = c["radius"] / jnp.maximum(
                1.0 / 3.0, 1.0 - (2.0 * rel_dec - 1.0) ** 3
            )
            r_grow = jnp.minimum(r_grow, max_radius)
            rejected = jnp.logical_and(proceed, ~successful)
            shrink = jnp.logical_or(~valid, rejected)
            radius2 = jnp.where(
                successful, r_grow, jnp.where(shrink, r_shrunk, c["radius"])
            )
            df2 = jnp.where(successful, 2.0, jnp.where(shrink, df_grown, c["df"]))
            rej_minrad = jnp.logical_and(rejected, r_shrunk < min_radius)

            # ---- state update + conditional re-evaluation ----
            accept_state = jnp.logical_or(
                successful, jnp.logical_and(t_func, new_cost < c["cost"])
            )
            state2 = jnp.where(accept_state, candidate, c["state"])
            cost_acc = jnp.where(accept_state, new_cost, c["cost"])

            def reeval(_):
                cj, res2, jacc2, grad2 = eval_jac(arrays, candidate)
                return cj, res2, jacc2, grad2

            def keep(_):
                return c["cost"], c["res"], c["jac"], c["grad"]

            cost_j, res2, jacc2, grad2 = jax.lax.cond(
                successful, reeval, keep, None
            )
            if use_split:
                jac2 = BlockJacobian.tree_unflatten(
                    (program, axis, None), jacc2
                )
                pcache2 = jax.lax.cond(
                    successful,
                    lambda _: step_fn.prepare(
                        jac2, list(res2), grad2, scale
                    ),
                    lambda _: c["pcache"],
                    None,
                )
            else:
                pcache2 = c["pcache"]
            eval_fail = jnp.logical_and(successful, ~jnp.isfinite(cost_j))
            if grad2.size:
                gmax, gnorm = grad_norms(arrays, state2, grad2)
            else:
                gmax = gnorm = jnp.zeros((), dtype)
            t_grad = jnp.logical_and(successful, gmax <= gtol)

            term = jnp.where(
                inv_fail,
                _INVALID_FAIL,
                jnp.where(
                    inv_minrad,
                    _MIN_RADIUS,
                    jnp.where(
                        t_param,
                        _PARAM_TOL,
                        jnp.where(
                            t_func,
                            _FUNC_TOL,
                            jnp.where(
                                eval_fail,
                                _EVAL_FAIL,
                                jnp.where(
                                    t_grad,
                                    _GRAD_TOL,
                                    jnp.where(
                                        rej_minrad, _MIN_RADIUS, _CONTINUE
                                    ),
                                ),
                            ),
                        ),
                    ),
                ),
            ).astype(jnp.int32)

            row = jnp.stack(
                [
                    cost_acc,
                    jnp.where(valid, cost_change, 0.0),
                    gmax,
                    gnorm,
                    radius2,
                    jnp.where(valid, step_norm, 0.0),
                    jnp.where(proceed, rel_dec, 0.0),
                    lin_iters.astype(dtype),
                    valid.astype(dtype) + 2.0 * successful.astype(dtype),
                    term.astype(dtype),
                ]
            )
            stats2 = jax.lax.dynamic_update_slice(
                c["stats"], row[None, :], (c["it"], jnp.zeros_like(c["it"]))
            )

            return dict(
                it=c["it"] + 1,
                term=term,
                state=state2,
                cost=cost_acc,
                res=res2,
                jac=jacc2,
                grad=grad2,
                radius=radius2,
                df=df2,
                ninv=ninv1,
                se=se_new,
                stats=stats2,
                nsucc=c["nsucc"] + successful.astype(jnp.int32),
                nfail=c["nfail"]
                + (jnp.logical_or(~valid, rejected)).astype(jnp.int32),
                njac=c["njac"] + successful.astype(jnp.int32),
                nls=c["nls"] + nls_new,
                pcache=pcache2,
            )

        init = dict(
            it=jnp.asarray(0, jnp.int32),
            term=jnp.asarray(_CONTINUE, jnp.int32),
            state=state,
            cost=cost,
            res=tuple(res),
            jac=jac_children,
            grad=grad,
            radius=radius,
            df=df,
            ninv=ninv,
            se=se,
            stats=jnp.zeros((chunk_iters(options), _N_STATS), dtype),
            nsucc=jnp.asarray(0, jnp.int32),
            nfail=jnp.asarray(0, jnp.int32),
            njac=jnp.asarray(0, jnp.int32),
            nls=jnp.asarray(0, jnp.int32),
            pcache=pcache,
        )
        final = jax.lax.while_loop(cond, body, init)
        # every host-facing number in ONE flat array: one device-to-host
        # fetch per chunk instead of one per scalar
        final["packed"] = jnp.concatenate(
            [
                jnp.stack(
                    [
                        final["it"].astype(dtype),
                        final["term"].astype(dtype),
                        final["nsucc"].astype(dtype),
                        final["nfail"].astype(dtype),
                        final["njac"].astype(dtype),
                        final["cost"].astype(dtype),
                        final["nls"].astype(dtype),
                    ]
                ),
                final["stats"].reshape(-1),
            ]
        )
        return final

    if sharded_evaluator is None:
        return jax.jit(chunk_fn)

    from jax.sharding import PartitionSpec as P

    from ..parallel.sharding import jac_pspecs, res_groups_pspecs

    rep = P()
    jac_specs = jac_pspecs(program, axis)
    res_specs = tuple(res_groups_pspecs(program, axis))
    se_specs = tuple(rep for _ in range(7))
    in_specs = (
        sharded_evaluator.arrays_specs,
        rep, rep, res_specs, jac_specs, rep, rep, rep, rep, rep,
        se_specs, rep, rep,
    )
    out_specs = dict(
        it=rep, term=rep, state=rep, cost=rep,
        res=res_specs, jac=jac_specs, grad=rep,
        radius=rep, df=rep, ninv=rep, se=se_specs, stats=rep,
        nsucc=rep, nfail=rep, njac=rep, nls=rep, pcache=rep, packed=rep,
    )
    return jax.jit(
        jax.shard_map(
            chunk_fn,
            mesh=sharded_evaluator.mesh,
            check_vma=True,
            in_specs=in_specs,
            out_specs=out_specs,
        )
    )


def run_fused(minimizer, state, summary):
    """Drive the fused loop in chunks; fills summary like the host loop."""
    options = minimizer.options
    program = minimizer.program
    ev = minimizer.evaluator
    summary.used_fused_execution = True
    from .trust_region import _exec

    exec_sum = _exec(summary)
    start = time.time()

    t_jac = time.time()
    cost0, res_groups, jac, grad = ev.evaluate_groups(state)
    cost = float(cost0)
    summary.num_jacobian_evaluations += 1
    summary.jacobian_evaluation_time_in_seconds += time.time() - t_jac
    exec_sum.record("Evaluator::Jacobian", time.time() - t_jac)
    if not np.isfinite(cost):
        from ..evaluator import diagnose_non_finite

        summary.termination_type = TerminationType.FAILURE
        summary.message = (
            "Initial cost evaluation failed (non-finite).\n"
            + diagnose_non_finite(program, state)
        )
        return state
    summary.initial_cost = cost + summary.fixed_cost

    if options.jacobi_scaling:
        # jitted: the one-hot reduction path must fuse (an eager call would
        # materialize the [n, cnt] one-hot)
        scale = jax.jit(lambda j: 1.0 / (1.0 + jnp.sqrt(j.squared_column_norms())))(
            jac
        )
    else:
        scale = jnp.ones(program.num_effective_parameters, dtype=state.dtype)

    if grad.size:
        gmax0, gnorm0 = minimizer._grad_norms(ev, state, grad)
    else:
        gmax0, gnorm0 = 0.0, 0.0
    it0 = IterationSummary(
        iteration=0,
        step_is_valid=True,
        step_is_successful=True,
        cost=cost + summary.fixed_cost,
        gradient_max_norm=gmax0,
        gradient_norm=gnorm0,
        trust_region_radius=float(options.initial_trust_region_radius),
        eta=options.eta,
        iteration_time_in_seconds=time.time() - start,
        cumulative_time_in_seconds=time.time() - start,
    )
    summary.iterations.append(it0)
    minimizer._log(it0)
    if gmax0 <= options.gradient_tolerance:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = (
            f"Gradient tolerance reached. Gradient max norm {gmax0:e}"
            f" <= {options.gradient_tolerance:e}"
        )
        summary.final_cost = cost + summary.fixed_cost
        return state

    chunk_fn = minimizer._fused_chunk_fn
    dtype = state.dtype
    if minimizer._fused_prepare is not None:
        pcache = minimizer._fused_prepare(jac, list(res_groups), grad, scale)
    else:
        pcache = ()
    radius = jnp.asarray(options.initial_trust_region_radius, dtype)
    df = jnp.asarray(2.0, dtype)
    ninv = jnp.asarray(0, jnp.int32)
    c0 = jnp.asarray(cost, dtype)
    zero = jnp.asarray(0.0, dtype)
    se = (c0, c0, c0, c0, zero, zero, jnp.asarray(0, jnp.int32))
    jac_children = (jac.jac_groups, jac.t_rows, jac.col_scale)
    res = tuple(res_groups)
    cost_dev = c0
    cost_host = float(cost)

    iters_done = 0
    term_code = _CONTINUE
    while iters_done < options.max_num_iterations:
        if time.time() - start > options.max_solver_time_in_seconds:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum solver time reached."
            summary.final_cost = cost_host + summary.fixed_cost
            return np.asarray(state)
        limit = min(chunk_iters(options), options.max_num_iterations - iters_done)
        t_chunk = time.time()
        out = chunk_fn(
            ev.arrays, state, cost_dev, res, jac_children, grad, scale,
            radius, df, ninv, se, jnp.asarray(limit, jnp.int32), pcache,
        )
        # ONE device->host fetch for everything the host needs this chunk
        packed = np.asarray(out["packed"], dtype=np.float64)
        n_it = int(packed[0])
        term_chunk = int(packed[1])
        nsucc = int(packed[2])
        nfail = int(packed[3])
        njac = int(packed[4])
        cost_host = float(packed[5])  # current cost without a second fetch
        nls = int(packed[6])
        stats = packed[7:].reshape(-1, _N_STATS)[:n_it]
        chunk_time = time.time() - t_chunk

        state = out["state"]
        cost_dev = out["cost"]
        res = out["res"]
        jac_children = out["jac"]
        grad = out["grad"]
        radius, df, ninv, se = out["radius"], out["df"], out["ninv"], out["se"]
        pcache = out["pcache"]
        summary.num_successful_steps += nsucc
        summary.num_unsuccessful_steps += nfail
        summary.num_jacobian_evaluations += njac
        summary.num_residual_evaluations += n_it + nls
        summary.num_line_search_steps += nls
        summary.num_linear_solves += n_it
        summary.linear_solver_time_in_seconds += chunk_time
        # Per-call stats (execution_summary.h role): counts are exact; the
        # chunk is ONE device program, so its wall time is recorded under
        # FusedLoop::Chunk (exact, cumulative) — run with
        # fused_execution_chunk_iters=1 (or fused_execution=False) for
        # fully separated per-call timings.
        exec_sum.record("FusedLoop::Chunk", chunk_time)
        exec_sum.record("Evaluator::Residual [fused]", 0.0, calls=n_it)
        exec_sum.record("Evaluator::Jacobian [fused]", 0.0, calls=njac)
        exec_sum.record("LinearSolver::Solve [fused]", 0.0, calls=n_it)
        if minimizer._fused_prepare is not None:
            # prepare/finish split: the J-dependent Gram + preconditioner
            # build runs ONLY after accepted steps (inside lax.cond on
            # `successful`); rejected iterations reuse the cache, so the
            # rebuild count equals the Jacobian re-evaluation count
            exec_sum.record(
                "Preconditioner::Update [fused]", 0.0, calls=njac
            )

        for k in range(n_it):
            row = stats[k]
            flags = int(row[_S_FLAGS])
            it_sum = IterationSummary(
                iteration=iters_done + k + 1,
                step_is_valid=bool(flags & 1),
                step_is_successful=bool(flags & 2),
                cost=float(row[_S_COST]) + summary.fixed_cost,
                cost_change=float(row[_S_CHANGE]),
                gradient_max_norm=float(row[_S_GMAX]),
                gradient_norm=float(row[_S_GNORM]),
                step_norm=float(row[_S_STEPNORM]),
                relative_decrease=float(row[_S_RELDEC]),
                trust_region_radius=float(row[_S_RADIUS]),
                eta=options.eta,
                linear_solver_iterations=int(row[_S_LINITERS]),
                iteration_time_in_seconds=chunk_time / max(n_it, 1),
                cumulative_time_in_seconds=time.time() - start,
            )
            summary.iterations.append(it_sum)
            minimizer._log(it_sum)

        iters_done += n_it
        term_code = term_chunk
        if term_code != _CONTINUE:
            break
        if n_it == 0:
            break

    if term_code != _CONTINUE:
        tt, msg = _TERM_MAP[term_code]
        summary.termination_type = tt
        summary.message = msg
        if term_code == _EVAL_FAIL:
            # name the culprit block(s), the role of the reference's
            # residual_block_utils.cc report
            from ..evaluator import diagnose_non_finite

            summary.message += "\n" + diagnose_non_finite(program, out["state"])
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = "Maximum number of iterations reached."
    summary.final_cost = cost_host + summary.fixed_cost
    return np.asarray(state)
