"""Preconditioners and batched block-diagonal solvers.

reference: IDENTITY / JACOBI (block_jacobi_preconditioner.cc), SCHUR_JACOBI
(schur_jacobi_preconditioner.cc), SCHUR_POWER_SERIES_EXPANSION
(power_series_expansion_preconditioner.cc). Shape: block-diagonal
operators live as TRANSPOSED per-class tables [s*s, count] (see
jacobian.py's layout rationale); applying M^{-1} is a python-unrolled set of
multiply-adds over [count]-wide rows — elementwise over the lane axis, no
[count, s, s] tile padding (a row-major [1M, 3, 3] batch would cost 42x its
logical size). Blocks of size <= 3 invert in closed form; larger classes
(e.g. 9x9 camera blocks, of which there are few) go through one batched
Cholesky inverse at build time.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np


def identity_preconditioner():
    return lambda r: r


def _inverse_T(table, s, eps_scale=1e-14):
    """Invert SPD blocks stored transposed: [s*s, cnt] -> [s*s, cnt].

    A tiny ridge keeps all-zero blocks (e.g. f-blocks sharing an e-class)
    finite; 0 -> 0 under the solve.
    """
    cnt = table.shape[1]
    eps = eps_scale * jnp.maximum(1.0, jnp.max(jnp.abs(table), axis=0)) + 1e-300
    diag_rows = np.arange(s) * s + np.arange(s)
    a = table.at[diag_rows, :].add(eps[None, :])

    def e(i, j):
        return a[i * s + j]

    def _repair_small(inv):
        """SPD repair for the closed-form classes (mirrors the general
        branch): a block pushed indefinite/ill-conditioned (e.g. by bf16
        preconditioner assembly) can yield non-finite cofactor inverses —
        degrade those blocks to the clamped-diagonal inverse instead of
        poisoning the PCG."""
        diag = jnp.stack([e(i, i) for i in range(s)])  # [s, cnt]
        dmax = jnp.max(jnp.abs(diag), axis=0, keepdims=True)
        dclamp = jnp.maximum(diag, 1e-6 * jnp.maximum(dmax, 1e-30))
        rows = []
        for i in range(s):
            for j in range(s):
                rows.append(
                    1.0 / dclamp[i] if i == j else jnp.zeros_like(dclamp[0])
                )
        diag_inv = jnp.stack(rows)
        ok = jnp.all(jnp.isfinite(inv), axis=0, keepdims=True)
        return jnp.where(ok, jnp.where(jnp.isfinite(inv), inv, 0.0), diag_inv)

    if s == 1:
        return _repair_small(1.0 / a)
    if s == 2:
        det = e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)
        det = jnp.where(det != 0, det, 1.0)
        inv = jnp.stack([e(1, 1), -e(0, 1), -e(1, 0), e(0, 0)]) / det
        return _repair_small(inv)
    if s == 3:
        c00 = e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)
        c01 = e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2)
        c02 = e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)
        c10 = e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)
        c11 = e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0)
        c12 = e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)
        c20 = e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)
        c21 = e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1)
        c22 = e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)
        det = e(0, 0) * c00 + e(0, 1) * c10 + e(0, 2) * c20
        det = jnp.where(det != 0, det, 1.0)
        inv = jnp.stack(
            [c00, c01, c02, c10, c11, c12, c20, c21, c22]
        ) / det
        return _repair_small(inv)
    # general case: batched Cholesky inverse (classes this large are small
    # in count — e.g. 1778 9x9 camera blocks)
    rows = table.T.reshape(cnt, s, s)
    rows = rows + eps[:, None, None] * jnp.eye(s, dtype=table.dtype)
    chol = jnp.linalg.cholesky(rows)
    inv = jax.vmap(
        lambda c: jax.scipy.linalg.cho_solve(
            (c, True), jnp.eye(s, dtype=table.dtype)
        )
    )(chol)
    # SPD repair: a block pushed indefinite (e.g. by the bf16
    # preconditioner assembly, schur.schur_prepare) NaNs its Cholesky —
    # degrade it to the clamped-diagonal inverse, which stays SPD, instead
    # of poisoning the PCG.
    diag = jnp.diagonal(rows, axis1=1, axis2=2)  # [cnt, s]
    dmax = jnp.max(jnp.abs(diag), axis=1, keepdims=True)
    dclamp = jnp.maximum(diag, 1e-6 * jnp.maximum(dmax, 1e-30))
    diag_inv = jax.vmap(jnp.diag)(1.0 / dclamp)  # [cnt, s, s]
    ok = jnp.all(jnp.isfinite(inv), axis=(1, 2), keepdims=True)
    inv = jnp.where(ok, jnp.where(jnp.isfinite(inv), inv, 0.0), diag_inv)
    return inv.reshape(cnt, s * s).T


def apply_block_T(inv_table, vt, s):
    """Apply per-block [s, s] matrices (transposed table [s*s, cnt]) to
    per-block vectors vt [s, cnt] -> [s, cnt]."""
    return jnp.stack(
        [
            sum(inv_table[i * s + j] * vt[j] for j in range(s))
            for i in range(s)
        ]
    )


class BlockDiagSolver:
    """Inverted block-diagonal operator over tangent-size classes.

    Input: per-class TRANSPOSED SPD block tables [s*s, count] (as produced
    by BlockJacobian.block_diag_jtj). Applies M^{-1} to the matching
    segments of a full tangent vector. Shared by the Jacobi preconditioner
    and the (E'E)^{-1} inner solve of implicit Schur
    (implicit_schur_complement.cc block_diagonal_EtE_inverse_).
    """

    def __init__(self, program, tables_per_class, only_classes=None):
        self.program = program
        self.inv_tables = {}
        for cls, table in enumerate(tables_per_class):
            if table is None:
                continue
            if only_classes is not None and cls not in only_classes:
                continue
            s = program.tangent_class_sizes[cls]
            self.inv_tables[cls] = _inverse_T(table, s)

    @classmethod
    def from_inverse_tables(cls, program, inv_tables: dict):
        """Wrap pre-inverted tables (e.g. passed as traced jit arguments so
        a compiled caller doesn't capture them as giant constants)."""
        self = cls.__new__(cls)
        self.program = program
        self.inv_tables = dict(inv_tables)
        return self

    @property
    def classes(self):
        return sorted(self.inv_tables.keys())

    def apply_t(self, tv):
        """Apply M^{-1} to a tvec (per-class [s, cnt+1+pad] transposed
        tables, jacobian.py): pure lane ops, no transposes — the form the
        PCG loop uses (no class-table transpose inside the
        lax.while_loop)."""
        out = []
        for cls, t in enumerate(tv):
            inv = self.inv_tables.get(cls)
            if inv is None or t.shape[1] == 0:
                # zero-width stand-ins: the f-only CG vector form
                # (schur._shrink_tvec) passes through untouched
                out.append(t)
                continue
            s = t.shape[0]
            w = inv.shape[1]
            y = apply_block_T(inv, t[:, :w], s)
            if t.shape[1] > w:
                y = jnp.concatenate(
                    [y, jnp.zeros((s, t.shape[1] - w), t.dtype)], axis=1
                )
            out.append(y)
        return out

    def __call__(self, r):
        """Apply M^{-1}: per-class transpose -> unrolled block matvec ->
        reassemble (the class-contiguous layout makes this scatter-free)."""
        from ..evaluator import tangent_tables

        tables = tangent_tables(self.program, r)
        out = []
        for cls, seg in enumerate(tables):
            inv = self.inv_tables.get(cls)
            if inv is None:
                out.append(seg.reshape(-1))
            else:
                s = self.program.tangent_class_sizes[cls]
                out.append(apply_block_T(inv, seg.T, s).T.reshape(-1))
        return jnp.concatenate(out)


class BlockJacobiPreconditioner:
    """M = block-diag(J^T J + diag(dsq)) per free parameter block.

    reference: block_jacobi_preconditioner.cc (BSM and CRS variants).
    """

    def __init__(self, program, jac, dsq=None):
        tables = jac.block_diag_jtj(dsq=dsq)
        self._solver = BlockDiagSolver(program, tables)

    def __call__(self, r):
        return self._solver(r)


def make_preconditioner(kind, program, jac, dsq=None):
    from ..types import PreconditionerType

    if kind == PreconditionerType.IDENTITY:
        return identity_preconditioner()
    if kind == PreconditionerType.JACOBI:
        return BlockJacobiPreconditioner(program, jac, dsq=dsq)
    raise NotImplementedError(f"preconditioner {kind} not implemented for this solver")
