"""Batched residual / Jacobian / gradient / cost evaluation.

Counterpart of the reference evaluation layer:
- ProgramEvaluator's ParallelFor over residual blocks
  (internal/ceres/program_evaluator.h:185-257) and the jwmak CUDA
  thread-per-block EvaluateKernel
  (include/ceres/internal/cuda_evaluator_kernel.h:301-422)
both become: per signature group, one vmapped linearize over stacked
parameters, manifold chain rule as a batched matmul, robust-loss correction
(corrector.py), and a deterministic scatter-add for the gradient — replacing
the reference's atomicAdd (cuda_evaluator_kernel.h:149-160) with
order-independent `.at[].add`.

Parameters stay device-resident for the whole solve; per-iteration
host<->device traffic is scalars only, eliminating the reference's stated
D2H-Jacobian bottleneck (README.md:198-200).

Sharding: when `axis_name` is set the evaluator is being called inside a
shard_map whose leading group axis is partitioned across devices; cost and
gradient are psum-reduced, residuals/Jacobians stay shard-local (they are
only ever consumed by further psum-reduced products — see jacobian.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .autodiff import batched_value_and_jacobians, batched_values
from .corrector import correct_batched
from .jacobian import BlockJacobian
from .utils.dtypes import default_dtype, full_f32_matmuls


# ---------------------------------------------------------------------- #
# pure functions over (program-meta, arrays)
# ---------------------------------------------------------------------- #


def state_tables(program, state):
    """Per-ambient-class [count, size] views of the flat state (reshapes)."""
    tables = []
    for cls in range(len(program.ambient_class_sizes)):
        base, cnt, s = program.ambient_class_slice(cls)
        tables.append(state[base : base + cnt * s].reshape(cnt, s))
    return tables


def tangent_tables(program, v, pad_zero_row: bool = False):
    """Per-tangent-class [count(+1), size] views of a tangent vector."""
    tables = []
    for cls in range(len(program.tangent_class_sizes)):
        base, cnt, s = program.tangent_class_slice(cls)
        t = v[base : base + cnt * s].reshape(cnt, s)
        if pad_zero_row:
            t = jnp.concatenate([t, jnp.zeros((1, s), dtype=v.dtype)])
        tables.append(t)
    return tables


def flatten_tangent(program, tables):
    """Inverse of tangent_tables (without pad rows)."""
    return jnp.concatenate([t.reshape(-1) for t in tables]) if tables else jnp.zeros(0)


def plus(program, arrays, state, delta):
    """state ⊞ delta with bounds clamping — all row operations.

    reference: Program::Plus (program.cc) + ParameterBlock bounds clamping.
    """
    xs = state_tables(program, state)
    ds = tangent_tables(program, delta, pad_zero_row=True)

    out = []
    for cls, x2d in enumerate(xs):
        rec_idx = arrays["plus_euclid"][cls]
        rec = program.plus_euclid[cls]
        if rec is not None:
            d2d = ds[rec["t_cls"]]
            x2d = x2d + jnp.take(d2d, rec_idx["t_row_map"], axis=0)
        out.append(x2d)

    for meta, g, gi in zip(
        program.manifold_group_meta,
        program.manifold_group_idx,
        arrays["manifold_groups"],
    ):
        x_rows = jnp.take(out[g["a_cls"]], gi["a_rows"], axis=0)
        d_rows = jnp.take(ds[g["t_cls"]], gi["t_rows"], axis=0)
        ys = jax.vmap(meta.manifold.plus)(x_rows, d_rows)
        out[g["a_cls"]] = out[g["a_cls"]].at[gi["a_rows"]].set(ys)

    new = jnp.concatenate([t.reshape(-1) for t in out])
    if program.has_bounds:
        new = jnp.clip(new, arrays["lower_bound"], arrays["upper_bound"])
    return new


def _group_eval(
    meta,
    garr,
    state_2d,
    with_jacobian: bool,
    apply_loss: bool,
    axis_name=None,
):
    """Evaluate one signature group. Returns (cost, res [r,n], jacs tuple of
    [r*t, n]) in the transposed SoA layout (see jacobian.py).

    Groups larger than LANE_CHUNK evaluate in lane slices: XLA's fusion
    temporaries for the batched pushforwards scale with the slice size.
    Cost/residual/Jacobian results are concatenated; the math is identical.
    """
    from .jacobian import lane_chunks

    n_total = garr["a_rows"][0].shape[0] if garr["a_rows"] else meta.n

    ranges = lane_chunks(n_total)
    if len(ranges) == 1:
        return _group_eval_range(
            meta, garr, state_2d, with_jacobian, apply_loss, axis_name,
            0, n_total,
        )
    costs, ress, jacss = [], [], []
    for (s, sz) in ranges:
        c, r, j = _group_eval_range(
            meta, garr, state_2d, with_jacobian, apply_loss, axis_name, s, sz
        )
        costs.append(c)
        ress.append(r)
        jacss.append(j)
    cost = sum(costs)
    res = jnp.concatenate(ress, axis=1)
    jacs = tuple(
        jnp.concatenate([j[i] for j in jacss], axis=1)
        for i in range(len(jacss[0]))
    )
    return cost, res, jacs


def _group_eval_range(
    meta, garr, state_2d, with_jacobian, apply_loss, axis_name, start, size
):
    """Evaluate lanes [start, start+size) of one signature group.

    state_2d: per-ambient-class [count, size] tables. Parameter gathers are
    row takes, except the owner position whose interleaved bucket layout
    makes the gather a slice+broadcast (no gather at all; the sharded
    variant slices the shard's own entity window by axis_index).
    """
    from .jacobian import gather_T

    sharded = axis_name is not None

    end = start + size
    params = []
    for pos, (pm, rows) in enumerate(zip(meta.positions, garr["a_rows"])):
        if sharded:
            plan = (meta.shard_red_plans or {}).get(pos)
        else:
            plan = (meta.red_plans or {}).get(pos)
        if (
            pos == meta.owner
            and meta.owner_ambient_aligned
            and plan is not None
            and plan[0] in ("bucket", "bucket_sharded")
        ):
            full = gather_T(plan, state_2d[pm.a_cls], rows, axis_name)
            params.append(full[:, start:end].T)
        else:
            params.append(jnp.take(state_2d[pm.a_cls], rows[start:end], axis=0))
    params = tuple(params)
    fn = meta.cost_function.fn
    data = tuple(
        jax.tree_util.tree_map(lambda d: d[start:end], dd) for dd in garr["data"]
    )
    mask = garr.get("mask")  # [n] 0/1 validity (padding for sharding), or None
    if mask is not None:
        mask = mask[start:end]

    if with_jacobian:
        res, jacs = batched_value_and_jacobians(fn, params, data)
        jacs = list(jacs)
        for pos, pm in enumerate(meta.positions):
            if pm.manifold is not None:
                pj = jax.vmap(pm.manifold.plus_jacobian)(params[pos])
                jacs[pos] = jnp.einsum(
                    "nrs,nst->nrt", jacs[pos], pj, precision="highest"
                )
    else:
        res = batched_values(fn, params, data)
        jacs = []

    if mask is not None:
        res = jnp.where(mask[:, None] > 0, res, 0.0)
        jacs = [jnp.where(mask[:, None, None] > 0, j, 0.0) for j in jacs]

    if apply_loss and meta.loss is not None:
        s = jnp.sum(res * res, axis=-1)
        rho0, rho1, rho2 = meta.loss.rho(s)
        if mask is not None:
            rho0 = jnp.where(mask > 0, rho0, 0.0)
        cost = 0.5 * jnp.sum(rho0)
        res, jacs = correct_batched(res, jacs, rho0, rho1, rho2)
    else:
        cost = 0.5 * jnp.sum(res * res)

    # outputs in transposed SoA layout (jacobian.py): the [n, r(, t)]
    # intermediates stay fusion-resident; only compact [r, n] / [r*t, n]
    # tensors are materialized, with the observation axis minor.
    n, r = res.shape
    res_T = res.T
    jacs_T = tuple(
        jnp.transpose(j, (1, 2, 0)).reshape(r * j.shape[2], n) for j in jacs
    )
    return cost, res_T, jacs_T


def evaluate(
    program,
    arrays,
    state,
    with_jacobian: bool = True,
    apply_loss: bool = True,
    axis_name: Optional[str] = None,
):
    """Full evaluation.

    Returns (cost, residuals list-of-[n,r], BlockJacobian|None, gradient).
    Parity: Evaluator::Evaluate (evaluator.h:110-136,
    program_evaluator.h:134-292, registered_cuda_evaluators.cc:46-103).
    """
    total_cost = jnp.zeros((), dtype=state.dtype)
    state_2d = state_tables(program, state)
    res_groups = []
    jac_groups = []

    for meta, garr in zip(program.groups, arrays["groups"]):
        cost_g, res, jacs = _group_eval(
            meta, garr, state_2d, with_jacobian, apply_loss, axis_name
        )
        total_cost = total_cost + cost_g
        res_groups.append(res)
        if with_jacobian:
            jac_groups.append(jacs)

    if axis_name is not None:
        from .jacobian import psum_hierarchical

        total_cost = psum_hierarchical(total_cost, axis_name)

    jac = None
    grad = None
    if with_jacobian:
        jac = BlockJacobian.build(program, arrays, jac_groups, axis_name=axis_name)
        # gradient = J^T r via the chunked streamed product (psummed inside)
        grad = jac.left_multiply(res_groups)
    return total_cost, res_groups, jac, grad


def flatten_residuals(program, res_groups):
    """Concatenate per-group [r, n] residuals into the global residual
    vector (internal ordering: groups in order, blocks within group,
    residual components within block), trimming any sharding-padding
    lanes."""
    if not res_groups:
        return jnp.zeros(0)
    return jnp.concatenate(
        [r[:, : meta.n].T.reshape(-1) for meta, r in zip(program.groups, res_groups)]
    )


# ---------------------------------------------------------------------- #
# Evaluator: jitted entry points bound to one Program
# ---------------------------------------------------------------------- #


class Evaluator:
    """Jitted evaluation functions for one Program.

    The Program's static structure (functors, sizes, manifolds) is closed
    over; all large arrays (index tables, stacked data, state) are traced
    arguments so XLA receives them as runtime buffers.
    """

    def __init__(self, program, dtype=None, axis_name: Optional[str] = None):
        self.program = program
        self.dtype = dtype or default_dtype()
        self.axis_name = axis_name
        self.arrays = program.arrays(self.dtype)

        self._cost = jax.jit(
            lambda arrays, state: evaluate(
                program, arrays, state, with_jacobian=False, axis_name=axis_name
            )[0]
        )
        self._residuals = jax.jit(
            lambda arrays, state: self._res_impl(arrays, state)
        )
        self._evaluate_jac = jax.jit(
            lambda arrays, state, apply_loss: evaluate(
                program,
                arrays,
                state,
                with_jacobian=True,
                apply_loss=apply_loss,
                axis_name=axis_name,
            ),
            static_argnums=(2,),
        )
        self._plus = jax.jit(lambda arrays, state, delta: plus(program, arrays, state, delta))

    def _res_impl(self, arrays, state):
        cost, res_groups, _, _ = evaluate(
            self.program, arrays, state, with_jacobian=False, axis_name=self.axis_name
        )
        return cost, flatten_residuals(self.program, res_groups)

    def _notify(self, evaluate_jacobians: bool):
        cb = getattr(self.program, "evaluation_callback", None)
        if cb is not None:
            cb(True, evaluate_jacobians)

    # -- public API ---------------------------------------------------- #

    @full_f32_matmuls
    def cost(self, state):
        self._notify(False)
        return self._cost(self.arrays, state)

    @full_f32_matmuls
    def residuals(self, state):
        """(cost, flat corrected residuals)."""
        self._notify(False)
        return self._residuals(self.arrays, state)

    @full_f32_matmuls
    def evaluate(self, state, apply_loss: bool = True):
        """(cost, flat residuals, BlockJacobian, gradient)."""
        self._notify(True)
        cost, res_groups, jac, grad = self._evaluate_jac(self.arrays, state, apply_loss)
        return cost, flatten_residuals(self.program, res_groups), jac, grad

    @full_f32_matmuls
    def evaluate_groups(self, state, apply_loss: bool = True):
        """(cost, per-group residual batches, BlockJacobian, gradient) — the
        minimizer-facing form that keeps residuals group-structured."""
        self._notify(True)
        return self._evaluate_jac(self.arrays, state, apply_loss)

    @full_f32_matmuls
    def plus(self, state, delta):
        return self._plus(self.arrays, state, delta)


def diagnose_non_finite(program, state, max_blocks: int = 3) -> str:
    """Name the residual block(s) whose evaluation produced Inf/NaN.

    The role of the reference's per-block culprit report
    (residual_block_utils.cc EvaluationToString/IsEvaluationValid, called
    from residual_block.cc:110-116): when a solve fails on a non-finite
    cost, re-evaluate group by group WITHOUT robust-loss correction and
    pretty-print each offending block's parameters, raw residuals, and
    Jacobian — at most `max_blocks` blocks per group.

    Host-side and eager by design: this runs once, after a failure.
    """
    import numpy as np

    arrays = program.arrays(state.dtype)
    state_2d = state_tables(program, state)
    lines = []
    for gi, (meta, garr, idx) in enumerate(
        zip(program.groups, arrays["groups"], program.group_idx)
    ):
        try:
            _, res, jacs = _group_eval(
                meta, garr, state_2d, True, False, None
            )
        except FloatingPointError:  # pragma: no cover - debug-mode nan traps
            res, jacs = None, None
        if res is None:
            lines.append(
                f"group {gi} ('{meta.cost_function.name}'): evaluation raised"
            )
            continue
        res = np.asarray(res)[:, : meta.n]  # [r, n]
        bad = ~np.isfinite(res).all(axis=0)
        if jacs is not None:
            for jpos in jacs:
                bad |= ~np.isfinite(np.asarray(jpos)[:, : meta.n]).all(axis=0)
        if not bad.any():
            continue
        bad_rows = np.flatnonzero(bad)
        lines.append(
            f"group {gi} ('{meta.cost_function.name}'): "
            f"{bad_rows.size}/{meta.n} residual blocks non-finite"
        )
        state_np = np.asarray(state)
        for row in bad_rows[:max_blocks]:
            lines.append(f"  block {int(row)}:")
            lines.append(
                "    residuals: "
                + np.array2string(res[:, row], precision=6, max_line_width=100)
            )
            for pos, (pm, ids) in enumerate(zip(meta.positions, idx["block_ids"])):
                bid = int(ids[row])
                off = int(program.x_offsets[bid])
                vals = state_np[off : off + pm.size]
                lines.append(
                    f"    parameter block {pos} (id {bid}, size {pm.size}): "
                    + np.array2string(vals, precision=6, max_line_width=100)
                )
                if jacs is not None:
                    # group layout is [r*t, n], r-major (jacobian.py)
                    jcol = np.asarray(jacs[pos])[:, row].reshape(
                        meta.num_residuals, -1
                    )  # [r, t]
                    lines.append(
                        "      jacobian: "
                        + np.array2string(
                            jcol, precision=6, max_line_width=100
                        ).replace("\n", "\n                ")
                    )
        if bad_rows.size > max_blocks:
            lines.append(f"  ... and {bad_rows.size - max_blocks} more")
    if not lines:
        return (
            "No non-finite residual/Jacobian entries found on re-evaluation "
            "(failure may come from the robust loss or the linear solver)."
        )
    return "\n".join(lines)
