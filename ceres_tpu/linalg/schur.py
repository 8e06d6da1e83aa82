"""Schur-complement linear solvers (the bundle-adjustment workhorse).

reference: ImplicitSchurComplement (implicit_schur_complement.cc),
IterativeSchurComplementSolver (iterative_schur_complement_solver.cc),
SchurComplementSolver (schur_complement_solver.cc), PartitionedMatrixView
(partitioned_matrix_view_impl.h).

Design (SURVEY.md §7): J is partitioned as [E F] by *signature-group
position* (e.g. for BA: E = d r/d point, F = d r/d camera), so all four
partitioned products E x, E^T u, F x, F^T u are the same einsum +
gather/scatter kernels as the full Jacobian, restricted to a position
subset (BlockJacobian.position_view). (E^T E + D_e^2)^{-1} is one batched
small Cholesky per e-class (vmapped). The PCG loop on the
reduced camera system runs entirely on device via lax.while_loop; nothing
is ever materialized.

The matrix-free S y product (implicit_schur_complement.cc:118-165):
    t1 = F y
    t2 = (E^T E + D_e^2)^{-1} E^T t1
    S y = F^T t1 - F^T E t2 + D_f^2 y
Back-substitution (implicit_schur_complement.h:135):
    dx_e = -(E^T E + D_e^2)^{-1} (g_e + E^T F dx_f)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..jacobian import BlockJacobian
from ..types import LinearSolverType, PreconditionerType
from .cg import conjugate_gradients
from .preconditioners import BlockDiagSolver


def _sum_groups(a_groups, b_groups):
    return [a + b for a, b in zip(a_groups, b_groups)]


def schur_views(program, jac):
    """Split the (scaled) Jacobian into E and F position views."""
    _, e_positions, f_positions = program.compute_schur_partition()
    jac_e = jac.position_view(e_positions)
    jac_f = jac.position_view(f_positions)
    return jac_e, jac_f


def _e_classes(program):
    e_blocks, _, _ = program.compute_schur_partition()
    return {
        int(program.block_class[i])
        for i in range(len(e_blocks))
        if e_blocks[i] and program.block_class[i] >= 0
    }


def _pure_class_split(program):
    """(f_classes, e_classes) when every tangent class is entirely on one
    side of the Schur partition (the BA case), else None.

    Enables the f-only CG vector optimization: the PCG on the reduced
    camera system carries zero-width stand-ins for the e-class tables, so
    the per-iteration vector algebra, dots, and preconditioner apply never
    touch the (always-zero) [s_e, num_points] tables.
    """
    import numpy as np

    e_mask, f_mask = program.schur_tangent_masks()
    f_set, e_set = set(), set()
    for cls in range(len(program.tangent_class_sizes)):
        base, cnt, s = program.tangent_class_slice(cls)
        seg = np.asarray(f_mask[base : base + cnt * s], dtype=bool)
        if seg.size == 0 or seg.all():
            f_set.add(cls)
        elif not seg.any():
            e_set.add(cls)
        else:
            return None
    return f_set, e_set


def _shrink_tvec(tv, f_set):
    """Replace e-class tables with zero-width stand-ins [s, 0]."""
    return [
        t if cls in f_set else t[:, :0] for cls, t in enumerate(tv)
    ]


def _expand_tvec(tv, f_set, widths):
    """Inverse of _shrink_tvec (zero-filled e tables)."""
    return [
        t if cls in f_set else jnp.zeros((t.shape[0], widths[cls]), t.dtype)
        for cls, t in enumerate(tv)
    ]


def _wrap_flat_preconditioner(program, prec, f_set):
    """Adapt a flat-vector preconditioner (visibility clustering,
    power-series) to the f-only tvec protocol.

    With the CG state reduced to the camera-class tables (e-classes ride
    zero-width stand-ins), the flat <-> tvec conversion is a [tf, n_cams]
    transpose — microseconds — so the exotic preconditioners no longer
    force the whole PCG onto the flat path (reference:
    conjugate_gradients_solver.h:108-311 is vector-type-generic for every
    preconditioner)."""
    num_eff = program.num_effective_parameters

    def apply_t(tv):
        dtype = tv[next(iter(f_set))].dtype if f_set else jnp.float32
        flat = jnp.zeros((num_eff,), dtype)
        for cls in f_set:
            base, cnt, s = program.tangent_class_slice(cls)
            flat = flat.at[base : base + cnt * s].set(
                tv[cls][:, :cnt].T.reshape(-1)
            )
        out_flat = prec(flat)
        out = []
        for cls, t in enumerate(tv):
            if cls in f_set:
                base, cnt, s = program.tangent_class_slice(cls)
                tbl = out_flat[base : base + cnt * s].reshape(cnt, s).T
                pad = t.shape[1] - cnt
                if pad:
                    tbl = jnp.concatenate(
                        [tbl, jnp.zeros((s, pad), tbl.dtype)], axis=1
                    )
                out.append(tbl)
            else:
                out.append(t)
        return out

    return apply_t


def add_dsq_T(program, tables, dsq):
    """tables[cls] [s*s, cnt] += diag(dsq) per block (the cheap
    dsq-dependent half of a Gram build)."""
    import numpy as np

    from ..evaluator import tangent_tables

    dt = tangent_tables(program, dsq)
    out = []
    for cls, acc in enumerate(tables):
        if acc is None:
            out.append(None)
            continue
        s = program.tangent_class_sizes[cls]
        diag_rows = np.arange(s) * s + np.arange(s)
        out.append(acc.at[diag_rows, :].add(dt[cls].T))
    return out


def make_ete_solver(program, jac_e, dsq_e):
    """Factorized (E^T E + D_e^2)^{-1} as batched per-class Cholesky."""
    e_classes = _e_classes(program)
    blocks = jac_e.block_diag_jtj(dsq=dsq_e, class_ids=e_classes)
    return BlockDiagSolver(program, blocks, only_classes=e_classes)


def ete_gram_tables(program, jac_e):
    """The J-dependent half of make_ete_solver: per-class E^T E tables
    WITHOUT the LM diagonal (reusable across rejected steps, where J is
    unchanged and only the radius moved — reference: Preconditioner::Update
    separated from creation, iterative_schur_complement_solver.cc:95-153)."""
    e_classes = _e_classes(program)
    tables = jac_e.block_diag_jtj(dsq=None, class_ids=e_classes)
    return [
        t if cls in e_classes else None for cls, t in enumerate(tables)
    ]


def ete_solver_from_gram(program, gram_tables, dsq_e):
    """(E^T E + D_e^2)^{-1} from cached grams + the current LM diagonal —
    exact (the Schur operator itself must always see the true dsq), and
    cheap: a diagonal add plus the small batched inverses."""
    e_classes = _e_classes(program)
    blocks = add_dsq_T(program, list(gram_tables), dsq_e)
    return BlockDiagSolver(program, blocks, only_classes=e_classes)


def schur_jacobi_blocks(program, jac_e, jac_f, ete_solver, dsq_f):
    """Block diagonal of S for the SCHUR_JACOBI preconditioner.

    For each f-block c: S_cc = sum_o F_o^T F_o + D_f^2
                              - sum_o F_o^T E_o M_{p(o)}^{-1} E_o^T F_o
    (valid when each residual block touches at most one e-block and one
    (c, e) pair appears in at most one residual block — the BA structure;
    extra cross terms are dropped, which only affects preconditioner
    quality, like the reference's clustered approximations).
    reference: schur_jacobi_preconditioner.cc via schur_eliminator's
    chunk-diagonal assembly.

    Returns per-class transposed tables [s*s, count] (jacobian.py layout).
    """
    from ..evaluator import tangent_tables
    from ..jacobian import gather_T, reduce_T

    program = jac_f.program
    ftf = jac_f.block_diag_jtj(dsq=dsq_f)  # per class [s*s, count]
    # Lazy column scaling (jacobian.py col_scale): the e-side scale is
    # applied per lane (a free bucket slice for the owner position); the
    # f-side scale is applied AFTER the reduction — every lane of an
    # f-block shares its scale, so it factors out of the segment sum.
    cs = jac_f.col_scale
    scale_tables = (
        tangent_tables(program, cs, pad_zero_row=True) if cs is not None else None
    )
    # correction per group: F^T E M^{-1} E^T F for each residual block, then
    # a plan-reduce into the f-block diagonal.
    corrections = [jnp.zeros_like(b) for b in ftf]
    for gi in range(len(jac_f.jac_groups)):
        if not jac_e.jac_groups[gi]:
            continue
        meta = program.groups[gi]
        n = jac_f._group_n(gi)
        r = meta.num_residuals
        e_pm = meta.positions[jac_e.positions[gi][0]]
        te = e_pm.tangent_size
        # per-observation M^{-1}: gather inverse blocks by e-class row
        # ([te*te, n]; a slice+broadcast under the owner bucket plan).
        # Cast to the leaf dtype so a bf16 assembly stays bf16 end-to-end
        # (the f32-accumulating reduce restores determinism; see
        # schur_prepare).
        minv = gather_T(
            jac_e.plan(gi, 0),
            ete_solver.inv_tables[e_pm.t_cls].T.astype(jac_e._dtype()),
            jac_e.t_rows[gi][0],
            jac_e.axis_name,
        ).reshape(te, te, n)
        ej = jac_e.jac_groups[gi][0].reshape(r, te, n)
        if scale_tables is not None:
            se_lane = gather_T(
                jac_e.plan(gi, 0),
                scale_tables[e_pm.t_cls].astype(jac_e._dtype()),
                jac_e.t_rows[gi][0],
                jac_e.axis_name,
            )  # [te, n], leaf dtype (keeps a bf16 assembly bf16)
            ej = ej * se_lane[None]
        for vpos, (f_jac, f_tr) in enumerate(
            zip(jac_f.jac_groups[gi], jac_f.t_rows[gi])
        ):
            pm = meta.positions[jac_f.positions[gi][vpos]]
            if pm.t_cls < 0:
                continue
            cnt = program.tangent_class_counts[pm.t_cls]
            tf = pm.tangent_size
            fj = f_jac.reshape(r, tf, n)
            # etf[e, f] = sum_r E[r, e] F[r, f]
            etf = (ej[:, :, None, :] * fj[:, None, :, :]).sum(axis=0)
            # minvetf[a, f] = sum_b M^{-1}[a, b] etf[b, f]
            minvetf = (minv[:, :, None, :] * etf[None, :, :, :]).sum(axis=1)
            # corr[p, q] = sum_a etf[a, p] minvetf[a, q]
            corr = (etf[:, :, None, :] * minvetf[:, None, :, :]).sum(axis=0)
            table = reduce_T(
                jac_f.plan(gi, vpos),
                corr.reshape(tf * tf, n),
                f_tr,
                cnt + 1 + jac_f._col_pad(),
                jac_f.axis_name,
            )
            tbl = table[:, :cnt]
            if scale_tables is not None:
                stf = scale_tables[pm.t_cls][:cnt].T  # [tf, cnt]
                tbl = tbl * (stf[:, None, :] * stf[None, :, :]).reshape(
                    tf * tf, cnt
                )
            corrections[pm.t_cls] = corrections[pm.t_cls] + tbl
    out = []
    for cls in range(len(ftf)):
        # corrections are shard-local partial sums; ftf was already psummed
        # inside block_diag_jtj.
        out.append(ftf[cls] - jac_f._psum(corrections[cls]))
    return out


def schur_prepare(program, options, jac_s):
    """J-dependent (radius-independent) half of an ITERATIVE_SCHUR step.

    Everything expensive that depends only on the (scaled) Jacobian —
    column norms, the per-point E^T E grams, and the preconditioner's
    Gram-minus-correction tables — is built here once per Jacobian and
    reused verbatim while steps are being rejected (J unchanged, only the
    trust-region radius moved). The correction term uses (E^T E)^{-1}
    without the LM diagonal; since E^T E + D^2 >= E^T E, the cached
    correction is an upper bound and P = FtF + dsq_f - corr0 stays SPD for
    every later radius (Schur complement of a PSD matrix is PSD).
    reference: Preconditioner::Update split from creation
    (iterative_schur_complement_solver.cc:95-153); the rejected-step reuse
    goes beyond the reference, which re-runs Update every solve.
    """
    unsharded = jac_s.axis_name is None and not jac_s.shard_view
    mixed = getattr(options, "use_mixed_precision_solves", False)

    jac_e, jac_f = schur_views(program, jac_s)
    colnorm2 = jac_s.squared_column_norms()
    e_gram0 = ete_gram_tables(program, jac_e)

    precond = options.preconditioner_type
    p0 = None

    def _ridge_ete():
        # The cached correction's (E^T E)^{-1} carries no LM diagonal, so
        # weakly observed points would make it explode (catastrophically in
        # f32). Floor the diagonal at a dtype-relative ridge: corr(ridge)
        # <= corr(0) <= FtF keeps P SPD and the 1e2*eps inflation is far
        # below preconditioner-quality resolution.
        e_mask = jnp.asarray(
            program.schur_tangent_masks()[0], dtype=colnorm2.dtype
        )
        ridge = 100.0 * float(jnp.finfo(colnorm2.dtype).eps)
        return ete_solver_from_gram(
            program, e_gram0, ridge * colnorm2 * e_mask
        )

    if precond == PreconditionerType.SCHUR_JACOBI:
        zero = jnp.zeros_like(colnorm2)
        p0 = schur_jacobi_blocks(program, jac_e, jac_f, _ridge_ete(), zero)
    elif precond == PreconditionerType.JACOBI:
        p0 = jac_f.block_diag_jtj(dsq=None)
    # The PCG matvec's scale-materialized (and, under mixed precision,
    # bf16-cast) Jacobian leaves are radius-independent too — cache them so
    # rejected-step retries skip the materialize pass.
    cache = {
        "colnorm2": colnorm2,
        "e_gram0": list(e_gram0),
        "p0": None if p0 is None else list(p0),
    }
    if unsharded:
        jac_mv = jac_s.materialize_scale()
        if mixed:
            jac_mv = jac_mv.astype(jnp.bfloat16)
        cache["jac_mv_groups"] = jac_mv.jac_groups
    # sharded: no leaf cache — the prepare cache crosses the shard_map
    # boundary with replicated specs, and lane-sharded leaves are NOT
    # replicated (check_vma correctly rejects it; caching them under a
    # replicated spec was silently wrong). finish re-materializes.
    return cache


def schur_finish_rhs(program, options, jac_s, grad_s, dsq, cache):
    """First half of the radius-dependent work: exact (E^T E + D_e^2)^{-1}
    from the cached grams, preconditioner assembly, and the reduced-system
    rhs. Returns a pytree `inter` for schur_finish_solve. Split out so the
    host loop can issue the two halves as SEPARATE dispatches
    (SolverOptions.split_step_dispatch): at BAL-13682 scale the combined
    finish executable's workspace can exceed a small device's memory even
    though each half fits."""
    dtype = grad_s.dtype
    e_mask_np, f_mask_np = program.schur_tangent_masks()
    e_mask = jnp.asarray(e_mask_np, dtype=dtype)
    f_mask = jnp.asarray(f_mask_np, dtype=dtype)

    jac_e, jac_f = schur_views(program, jac_s)
    dsq_e = dsq * e_mask
    dsq_f = dsq * f_mask
    g_e = grad_s * e_mask

    ete = ete_solver_from_gram(program, cache["e_gram0"], dsq_e)

    split0 = _pure_class_split(program)
    prec_inv = None
    if cache["p0"] is not None:
        blocks = add_dsq_T(program, list(cache["p0"]), dsq_f)
        prec_inv = dict(
            BlockDiagSolver(
                program,
                blocks,
                only_classes=split0[0] if split0 is not None else None,
            ).inv_tables
        )

    # rhs = -g_f + F^T E M^{-1} g_e
    t2 = ete(g_e)
    et2 = jac_e.right_multiply(t2)
    rhs = -(grad_s * f_mask) + jac_f.left_multiply(et2)
    return {
        "ete_inv": dict(ete.inv_tables),
        "prec_inv": prec_inv,
        "rhs": rhs,
    }


def schur_finish(program, options, jac_s, res_groups, grad_s, dsq, cache):
    """Radius-dependent half: rhs/preconditioner stage + tvec PCG +
    back-substitution (see schur_finish_rhs / schur_finish_solve).
    Returns (step, lin_iters)."""
    inter = schur_finish_rhs(program, options, jac_s, grad_s, dsq, cache)
    return schur_finish_solve(
        program, options, jac_s, grad_s, dsq, cache, inter
    )


def schur_finish_solve(program, options, jac_s, grad_s, dsq, cache, inter):
    """Second half: the tvec PCG on the reduced camera system and the
    e-block back-substitution, from schur_finish_rhs's intermediates."""
    dtype = grad_s.dtype
    e_mask_np, f_mask_np = program.schur_tangent_masks()
    e_mask = jnp.asarray(e_mask_np, dtype=dtype)
    f_mask = jnp.asarray(f_mask_np, dtype=dtype)

    jac_e, jac_f = schur_views(program, jac_s)
    dsq_f = dsq * f_mask
    g_e = grad_s * e_mask
    rhs = inter["rhs"]

    ete = BlockDiagSolver.from_inverse_tables(program, inter["ete_inv"])
    prec = (
        BlockDiagSolver.from_inverse_tables(program, inter["prec_inv"])
        if inter["prec_inv"] is not None
        else None
    )

    dsq_f_tv = jac_s.tvec(dsq_f)
    b_tv = jac_s.tvec(rhs)
    widths = [t.shape[1] for t in b_tv]
    split = _pure_class_split(program)
    f_set = split[0] if split is not None else None
    if f_set is not None:
        dsq_f_tv = _shrink_tvec(dsq_f_tv, f_set)
        b_tv = _shrink_tvec(b_tv, f_set)

    mv_groups = cache.get("jac_mv_groups")
    if mv_groups is not None:
        jac_m = BlockJacobian(
            program,
            mv_groups,
            jac_s.t_rows,
            jac_s.axis_name,
            jac_s.positions,
            jac_s.shard_view,
        )
    else:
        jac_m = jac_s.materialize_scale()
        if getattr(options, "use_mixed_precision_solves", False):
            jac_m = jac_m.astype(jnp.bfloat16)
    jac_e_mv, jac_f_mv = schur_views(program, jac_m)

    def s_apply_t(y_tv):
        t1 = jac_f_mv.right_multiply_t(y_tv)
        t2 = ete.apply_t(jac_e_mv.left_multiply_t(t1))
        et2 = jac_e_mv.right_multiply_t(t2)
        diff = [a - b for a, b in zip(t1, et2)]
        out = jac_f_mv.left_multiply_t(diff)
        if f_set is not None:
            out = _shrink_tvec(out, f_set)
        return [o + d * y for o, d, y in zip(out, dsq_f_tv, y_tv)]

    result = conjugate_gradients(
        matvec=s_apply_t,
        b=b_tv,
        preconditioner=prec.apply_t if prec is not None else None,
        max_iterations=options.max_linear_solver_iterations,
        min_iterations=options.min_linear_solver_iterations,
        tolerance=0.0,
        q_tolerance=options.eta,
    )
    x_tv = result.x
    if f_set is not None:
        x_tv = _expand_tvec(x_tv, f_set, widths)
    dx_f = jac_s.tvec_flat(x_tv) * f_mask

    # back-substitute e-part: dx_e = -M^{-1} (g_e + E^T F dx_f)
    fdx = jac_f.right_multiply(dx_f)
    etfdx = jac_e.left_multiply(fdx)
    dx_e = -ete(g_e + etfdx) * e_mask
    return dx_f + dx_e, result.iterations


def make_power_series_applier(
    program, jac_e, jac_f, ete, dsq_f, spse_tolerance, max_iterations
):
    """y ~ S^{-1} x via the truncated Neumann series around blockdiag(F'F).

    reference: PowerSeriesExpansionPreconditioner::RightMultiplyAndAccumulate
    (power_series_expansion_preconditioner.cc:51-72) with the inverse
    power-series operator
    ImplicitSchurComplement::InversePowerSeriesOperatorRightMultiplyAccumulate
    (implicit_schur_complement.cc:146-172):

        y_0    = P^{-1} x,                 P = blockdiag(F'F + D_f^2)
        term_i = P^{-1} F'E (E'E+D_e^2)^{-1} E'F term_{i-1}
        y      = y_0 + term_1 + ... until i >= max_iterations or
                 |term_i| < spse_tolerance * |y_0|

    Serves both roles the reference gives it: the
    SCHUR_POWER_SERIES_EXPANSION preconditioner and the
    use_spse_initialization PCG warm start
    (iterative_schur_complement_solver.cc:95-107). Runs as a
    lax.while_loop, entirely on device.
    """
    ftf_inv = BlockDiagSolver(program, jac_f.block_diag_jtj(dsq=dsq_f))
    max_iterations = max(0, int(max_iterations))

    def series_term(prev):
        t1 = jac_f.right_multiply(prev)  # F p (residual-space groups)
        t2 = ete(jac_e.left_multiply(t1))  # (E'E)^{-1} E'F p
        t3 = jac_e.right_multiply(t2)  # E (...)
        return ftf_inv(jac_f.left_multiply(t3))  # P^{-1} F'E (...)

    def apply(x):
        y0 = ftf_inv(x)
        if max_iterations < 1:
            return y0
        threshold = spse_tolerance * jnp.linalg.norm(y0)

        def cond(c):
            _i, _y, _prev, go = c
            return go

        def body(c):
            i, y, prev, _ = c
            term = series_term(prev)
            y = y + term
            # reference loop: term i is added, then `break` if
            # i >= max_num_spse_iterations or |term| < threshold — so terms
            # run i = 1..max inclusive
            go = jnp.logical_and(
                i < max_iterations, jnp.linalg.norm(term) >= threshold
            )
            return (i + 1, y, term, go)

        _, y, _, _ = jax.lax.while_loop(
            cond, body, (jnp.asarray(1, jnp.int32), y0, y0, jnp.asarray(True))
        )
        return y

    return apply


def schur_solve(program, options, jac_s, res_groups, grad_s, dsq):
    """Solve (J^T J + diag(dsq)) step = -grad via the Schur complement.

    Implicit S (ITERATIVE_SCHUR) with PCG, or dense S (DENSE_SCHUR /
    SPARSE_SCHUR fallback) materialized through the implicit operator.
    Returns (step [num_eff], linear iterations).
    """
    dtype = grad_s.dtype
    e_mask_np, f_mask_np = program.schur_tangent_masks()
    e_mask = jnp.asarray(e_mask_np, dtype=dtype)
    f_mask = jnp.asarray(f_mask_np, dtype=dtype)

    jac_e, jac_f = schur_views(program, jac_s)
    dsq_e = dsq * e_mask
    dsq_f = dsq * f_mask
    g_e = grad_s * e_mask
    g_f = grad_s * f_mask

    ete = make_ete_solver(program, jac_e, dsq_e)

    # Mixed precision (options doc in types.py): the PCG matvec reads bf16
    # Jacobian copies; reductions accumulate f32; preconditioner, RHS, and
    # back-substitution stay f32.
    if getattr(options, "use_mixed_precision_solves", False):
        jac_e_mv = jac_e.astype(jnp.bfloat16)
        jac_f_mv = jac_f.astype(jnp.bfloat16)
    else:
        jac_e_mv, jac_f_mv = jac_e, jac_f

    def _s_apply_with(jac_e_op, jac_f_op, y):
        t1 = jac_f_op.right_multiply(y)  # F y, group residual batches
        ett1 = jac_e_op.left_multiply(t1)  # E^T F y
        t2 = ete(ett1)
        et2 = jac_e_op.right_multiply(t2)  # E t2, residual space
        diff = [a - b for a, b in zip(t1, et2)]
        return jac_f_op.left_multiply(diff) + dsq_f * y

    def s_apply(y):
        # PCG matvec: bf16 Jacobian reads when mixed precision is on
        return _s_apply_with(jac_e_mv, jac_f_mv, y)

    def s_apply_exact(y):
        # working-precision operator — used to materialize the dense S
        # (bf16 reads would make S asymmetric/indefinite at ~1e-3 relative)
        return _s_apply_with(jac_e, jac_f, y)

    # rhs = -g_f + F^T E M^{-1} g_e
    t2 = ete(g_e)
    et2 = jac_e.right_multiply(t2)
    rhs = -g_f + jac_f.left_multiply(et2)

    if options.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR:
        if getattr(options, "use_explicit_schur_complement", False):
            # materialize S restricted to the f-coordinates once; each PCG
            # iteration is then a single dense matmul instead of four
            # partitioned products (reference:
            # Options::use_explicit_schur_complement,
            # schur_complement_solver.cc explicit path + PCG)
            f_positions = jnp.asarray(_np_nonzero(f_mask_np), dtype=jnp.int32)
            nf = f_positions.shape[0]
            basis = jnp.zeros((nf, grad_s.shape[0]), dtype=dtype)
            basis = basis.at[jnp.arange(nf), f_positions].set(1.0)
            s_cols = jax.vmap(s_apply_exact)(basis)  # [nf, num_eff]
            s_dense = s_cols[:, f_positions]
            s_dense = 0.5 * (s_dense + s_dense.T)

            def s_apply(y, _sd=s_dense, _fp=f_positions):
                return jnp.zeros_like(y).at[_fp].set(_sd @ y[_fp])

        if options.preconditioner_type == PreconditionerType.SCHUR_JACOBI:
            blocks = schur_jacobi_blocks(program, jac_e, jac_f, ete, dsq_f)
            prec = BlockDiagSolver(program, blocks)
        elif options.preconditioner_type == PreconditionerType.JACOBI:
            blocks = jac_f.block_diag_jtj(dsq=dsq_f)
            prec = BlockDiagSolver(program, blocks)
        elif options.preconditioner_type in (
            PreconditionerType.CLUSTER_JACOBI,
            PreconditionerType.CLUSTER_TRIDIAGONAL,
        ):
            from .visibility import VisibilityPreconditioner

            prec = VisibilityPreconditioner(
                program,
                jac_e,
                jac_f,
                ete,
                dsq_f,
                options.preconditioner_type,
                options.visibility_clustering_type,
            )
        elif (
            options.preconditioner_type
            == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION
        ):
            prec = make_power_series_applier(
                program, jac_e, jac_f, ete, dsq_f,
                options.spse_tolerance, max(1, options.max_num_spse_iterations),
            )
        else:
            prec = None
        # PCG warm start from a truncated power-series solve of S x = rhs
        # (reference: iterative_schur_complement_solver.cc:95-107).
        x0 = None
        if getattr(options, "use_spse_initialization", False):
            x0 = make_power_series_applier(
                program, jac_e, jac_f, ete, dsq_f,
                options.spse_tolerance, options.max_num_spse_iterations,
            )(rhs) * f_mask

        # Table-vector ("tvec") PCG: the loop runs on per-class transposed
        # tables so no [cnt, s] <-> [s, cnt] relayout materializes per
        # iteration inside the while_loop. Every
        # preconditioner rides it: block-diagonal ones natively
        # (BlockDiagSolver.apply_t), the exotic ones (visibility
        # clustering, power-series) through the f-only flat adapter
        # (_wrap_flat_preconditioner — the CG state is just the camera
        # tables, so the conversion is tiny).
        exotic_prec = options.preconditioner_type in (
            PreconditionerType.CLUSTER_JACOBI,
            PreconditionerType.CLUSTER_TRIDIAGONAL,
            PreconditionerType.SCHUR_POWER_SERIES_EXPANSION,
        )
        use_tvec = not getattr(
            options, "use_explicit_schur_complement", False
        ) and (not exotic_prec or _pure_class_split(program) is not None)
        if use_tvec:
            jac_m = jac_s.materialize_scale()
            jac_e_m, jac_f_m = schur_views(program, jac_m)
            if getattr(options, "use_mixed_precision_solves", False):
                jac_e_mv_m = jac_e_m.astype(jnp.bfloat16)
                jac_f_mv_m = jac_f_m.astype(jnp.bfloat16)
            else:
                jac_e_mv_m, jac_f_mv_m = jac_e_m, jac_f_m
            dsq_f_tv = jac_s.tvec(dsq_f)
            b_tv = jac_s.tvec(rhs)
            widths = [t.shape[1] for t in b_tv]
            split = _pure_class_split(program)
            f_set = split[0] if split is not None else None
            x0_tv = None if x0 is None else jac_s.tvec(x0)
            if f_set is not None:
                dsq_f_tv = _shrink_tvec(dsq_f_tv, f_set)
                b_tv = _shrink_tvec(b_tv, f_set)
                if x0_tv is not None:
                    x0_tv = _shrink_tvec(x0_tv, f_set)

            def s_apply_t(y_tv):
                t1 = jac_f_mv_m.right_multiply_t(y_tv)
                t2 = ete.apply_t(jac_e_mv_m.left_multiply_t(t1))
                et2 = jac_e_mv_m.right_multiply_t(t2)
                diff = [a - b for a, b in zip(t1, et2)]
                out = jac_f_mv_m.left_multiply_t(diff)
                if f_set is not None:
                    out = _shrink_tvec(out, f_set)
                return [o + d * y for o, d, y in zip(out, dsq_f_tv, y_tv)]

            if prec is None:
                prec_t = None
            elif hasattr(prec, "apply_t"):
                prec_t = prec.apply_t
            else:
                prec_t = _wrap_flat_preconditioner(program, prec, f_set)
            result = conjugate_gradients(
                matvec=s_apply_t,
                b=b_tv,
                x0=x0_tv,
                preconditioner=prec_t,
                max_iterations=options.max_linear_solver_iterations,
                min_iterations=options.min_linear_solver_iterations,
                tolerance=0.0,
                q_tolerance=options.eta,
            )
            x_tv = result.x
            if f_set is not None:
                x_tv = _expand_tvec(x_tv, f_set, widths)
            dx_f = jac_s.tvec_flat(x_tv) * f_mask
            lin_iters = result.iterations
        else:
            result = conjugate_gradients(
                matvec=s_apply,
                b=rhs,
                x0=x0,
                preconditioner=prec,
                max_iterations=options.max_linear_solver_iterations,
                min_iterations=options.min_linear_solver_iterations,
                # LM maps eta to the Q-based (truncated-Newton) criterion,
                # residual test disabled
                # (levenberg_marquardt_strategy.cc:98-103)
                tolerance=0.0,
                q_tolerance=options.eta,
            )
            dx_f = result.x * f_mask
            lin_iters = result.iterations
    else:
        # DENSE_SCHUR (and SPARSE_SCHUR capability fallback): materialize S
        # restricted to f-coordinates through the implicit operator — a
        # batched matvec (= one big matmul) — then Cholesky.
        # reference: schur_complement_solver.cc dense path.
        nf = int(f_mask_np.sum())
        f_positions = jnp.asarray(_np_nonzero(f_mask_np), dtype=jnp.int32)
        basis = jnp.zeros((nf, grad_s.shape[0]), dtype=dtype)
        basis = basis.at[jnp.arange(nf), f_positions].set(1.0)
        s_cols = jax.vmap(s_apply_exact)(basis)  # [nf, num_eff]
        s_dense = s_cols[:, f_positions]  # [nf, nf]
        s_dense = 0.5 * (s_dense + s_dense.T)  # kill reduction-order noise
        rhs_f = rhs[f_positions]
        if options.use_mixed_precision_solves:
            # f32 factorization + working-dtype refinement on the reduced
            # camera system (dense_cholesky.h:246, iterative_refiner.cc)
            from .dense import cholesky_solve_mixed

            y = cholesky_solve_mixed(
                s_dense, rhs_f,
                refine_iterations=max(1, options.max_num_refinement_iterations or 3),
            )
        else:
            chol, low = jax.scipy.linalg.cho_factor(s_dense, lower=True)
            y = jax.scipy.linalg.cho_solve((chol, low), rhs_f)
        dx_f = jnp.zeros_like(grad_s).at[f_positions].set(y)
        lin_iters = jnp.asarray(1, jnp.int32)

    # back-substitute e-part: dx_e = -M^{-1} (g_e + E^T F dx_f)
    fdx = jac_f.right_multiply(dx_f)
    etfdx = jac_e.left_multiply(fdx)
    dx_e = -ete(g_e + etfdx) * e_mask
    return dx_f + dx_e, lin_iters


def _np_nonzero(mask):
    import numpy as np

    return np.nonzero(mask)[0]
