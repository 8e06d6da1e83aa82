"""Inner iterations: block-coordinate refinement of the eliminated blocks.

reference: coordinate_descent_minimizer.cc (273 LoC) — after each accepted
trust-region step, Ceres re-optimizes each parameter block of an
independent set with all other blocks fixed.

Design: the independent set is the Schur e-block partition (no
two e-blocks share a residual), so all per-block subproblems are solved
SIMULTANEOUSLY as batched damped Gauss-Newton sweeps:

    per observation:  r, J_e (Jacobian w.r.t. its e-block only, width t_e)
    per e-block:      JtJ, Jtr by segment-sum (c_idx class tables)
    batched solve:    (JtJ + lambda I)^-1 Jtr     [count, t_e, t_e]
    update:           plus() on the e-entries of the tangent vector

This replaces the reference's threaded per-block LM loops with one
batched device kernel; a host-level cost guard keeps the refinement
monotonic (the reference's per-block solves are monotone by construction).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..autodiff import value_and_jacobians
from ..corrector import correct_batched
from ..evaluator import plus as plus_fn


def _group_e_eval(meta, garr, state_2d, e_pos):
    """Residuals + Jacobian w.r.t. only the e-position for one group."""
    import jax.numpy as _jnp

    params = tuple(
        _jnp.take(state_2d[pm.a_cls], rows, axis=0)
        for pm, rows in zip(meta.positions, garr["a_rows"])
    )
    fn = meta.cost_function.fn
    data = garr["data"]
    mask = garr.get("mask")

    def single(ps, d):
        def f_of_e(pe):
            full = ps[:e_pos] + (pe,) + ps[e_pos + 1 :]
            return fn(full, d)

        res, (jac,) = value_and_jacobians(lambda p2, _d: f_of_e(p2[0]), (ps[e_pos],), d)
        return res, jac

    res, jac = jax.vmap(single)(params, data)
    pm = meta.positions[e_pos]
    if pm.manifold is not None:
        pj = jax.vmap(pm.manifold.plus_jacobian)(params[e_pos])
        jac = jnp.einsum("nrs,nst->nrt", jac, pj)
    if mask is not None:
        res = jnp.where(mask[:, None] > 0, res, 0.0)
        jac = jnp.where(mask[:, None, None] > 0, jac, 0.0)
    if meta.loss is not None:
        s = jnp.sum(res * res, axis=-1)
        rho0, rho1, rho2 = meta.loss.rho(s)
        res, (jac,) = correct_batched(res, [jac], rho0, rho1, rho2)
    return res, jac


def make_inner_iteration_fn(program, options, axis_name=None):
    """Build a jitted refinement: (arrays, state, damping) -> state'.

    One call performs a single batched GN sweep over all e-blocks.
    """
    user_ordering = getattr(options, "inner_iteration_ordering", None)
    if user_ordering is not None:
        # reference: Solver::Options::inner_iteration_ordering — group 0
        # picks the blocks the inner minimizer optimizes
        # (coordinate_descent_minimizer.cc:88-150). Must be independent;
        # validated by compute_schur_partition.
        from ..ordering import eliminated_handles

        _, e_positions, _ = program.compute_schur_partition(
            user_e_override=frozenset(
                int(h) for h in eliminated_handles(user_ordering)
            ),
            cache=False,
        )
    else:
        _, e_positions, _ = program.compute_schur_partition()
    e_classes = sorted(
        {
            program.class_of_tsize[
                program.groups[gi].positions[eps[0]].tangent_size
            ]
            for gi, eps in enumerate(e_positions)
            if eps
        }
    )
    if not e_classes:
        return None

    import numpy as np

    e_mask_np, _ = program.schur_tangent_masks()
    e_mask_np = np.asarray(e_mask_np)

    import numpy as _np

    def sweep(arrays, state, damping):
        from ..evaluator import state_tables
        from ..jacobian import reduce_T
        from ..linalg.preconditioners import _inverse_T, apply_block_T

        dtype = state.dtype
        state_2d = state_tables(program, state)
        # transposed accumulators [s*s, cnt+1] / [s, cnt+1] (jacobian.py layout)
        per_class_jtj = {
            c: jnp.zeros(
                (program.class_tsizes[c] ** 2, program.class_counts[c] + 1), dtype
            )
            for c in e_classes
        }
        per_class_jtr = {
            c: jnp.zeros((program.class_tsizes[c], program.class_counts[c] + 1), dtype)
            for c in e_classes
        }
        for gi, (meta, garr) in enumerate(zip(program.groups, arrays["groups"])):
            eps = e_positions[gi]
            if not eps:
                continue
            e_pos = eps[0]
            res, jac = _group_e_eval(meta, garr, state_2d, e_pos)
            cls = meta.positions[e_pos].t_cls
            tr = garr["t_rows"][e_pos]
            cnt = program.class_counts[cls]
            n_g, r_g, t_g = jac.shape
            plan = (meta.red_plans or {}).get(e_pos)
            if axis_name and plan is not None and plan[0] == "bucket":
                plan = ("segsum",)
            jac_T = jnp.transpose(jac, (1, 2, 0))  # [r, t, n]
            outer = (jac_T[:, :, None, :] * jac_T[:, None, :, :]).sum(axis=0)
            per_class_jtj[cls] = per_class_jtj[cls] + reduce_T(
                plan, outer.reshape(t_g * t_g, n_g), tr, cnt + 1
            )
            per_class_jtr[cls] = per_class_jtr[cls] + reduce_T(
                plan, (jac_T * res.T[:, None, :]).sum(axis=0), tr, cnt + 1
            )

        # assemble the tangent delta class by class (e-classes solve, others 0)
        parts = []
        for c in range(len(program.class_tsizes)):
            cnt = program.class_counts[c]
            s = program.class_tsizes[c]
            if c not in e_classes:
                parts.append(jnp.zeros(cnt * s, dtype))
                continue
            jtj = per_class_jtj[c][:, :-1]
            jtr = per_class_jtr[c][:, :-1]
            if axis_name:
                jtj = jax.lax.psum(jtj, axis_name)
                jtr = jax.lax.psum(jtr, axis_name)
            # damp the diagonal, then batched closed-form/Cholesky inverse
            diag_rows = _np.arange(s) * s + _np.arange(s)
            a = jtj.at[diag_rows, :].add(
                damping * jnp.maximum(jtj[diag_rows, :], 1e-12)
            )
            inv = _inverse_T(a, s, eps_scale=0.0)
            parts.append(-apply_block_T(inv, jtr, s).T.reshape(-1))
        delta = jnp.concatenate(parts)
        return plus_fn(program, arrays, state, delta)

    return sweep


class InnerIterationRefiner:
    """Host-side wrapper: run `sweeps` batched GN sweeps with a monotonic
    cost guard. reference behaviour: CoordinateDescentMinimizer invoked from
    TrustRegionMinimizer::DoInnerIterationsIfNeeded
    (trust_region_minimizer.cc:504-583)."""

    def __init__(self, program, options, evaluator, sweeps: int = 2):
        self.evaluator = evaluator
        self.sweeps = sweeps
        fn = make_inner_iteration_fn(program, options, getattr(evaluator, "axis_name", None))
        self._sweep = jax.jit(fn) if fn is not None else None

    @property
    def available(self) -> bool:
        return self._sweep is not None

    def refine(self, state, cost: float):
        """Returns (state', cost') with cost' <= cost."""
        if self._sweep is None:
            return state, cost
        ev = self.evaluator
        damping = 1e-4
        for _ in range(self.sweeps):
            candidate = self._sweep(ev.arrays, state, jnp.asarray(damping, state.dtype))
            new_cost = float(ev.cost(candidate))
            if new_cost < cost:
                state, cost = candidate, new_cost
                damping = max(damping / 2.0, 1e-8)
            else:
                damping *= 10.0
        return state, cost
