"""Covariance estimation of the solution.

reference: covariance.h (470), covariance_impl.cc (889). Capability parity:
covariance of selected parameter-block pairs from the inverse of J^T J at
the solution, in tangent space (optionally lifted to ambient space through
the plus Jacobian), with rank-deficiency handling via eigenvalue
thresholding (the reference's DENSE_SVD algorithm), computed as one dense
host eigendecomposition (np.linalg.eigh) — covariance runs once after the
solve at sizes where a host eigh is cheap, so device residency buys
nothing here. The sparse path plays the reference SPARSE_QR role via a
column-subset solve against the host sparse factorization.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from .types import CovarianceAlgorithmType
from .utils.dtypes import full_f32_matmuls


@dataclasses.dataclass
class CovarianceOptions:
    """reference: Covariance::Options (covariance.h:360-460)."""

    algorithm_type: CovarianceAlgorithmType = CovarianceAlgorithmType.DENSE_SVD
    min_reciprocal_condition_number: float = 1e-14
    null_space_rank: int = 0  # -1: drop all small eigenvalues
    apply_loss_function: bool = True
    # ITERATIVE_PCG controls: per-column relative residual tolerance and
    # PCG iteration cap (0 -> num_effective_parameters).
    iterative_tolerance: float = 1e-10
    iterative_max_iterations: int = 0


class _ColumnSubsetMatrix:
    """Dense view of selected columns of the (symmetric) covariance, sliced
    like the full matrix. Backs the SPARSE_QR path, which only solves for
    the requested blocks' columns."""

    def __init__(self, n: int, cols: np.ndarray, values: np.ndarray):
        self._n = n
        self._col_map = {int(c): k for k, c in enumerate(cols)}
        self._values = values  # [n, len(cols)]

    def __getitem__(self, key):
        rows, cols = key
        try:
            col_idx = [self._col_map[c] for c in range(cols.start, cols.stop)]
        except KeyError as e:
            raise ValueError(
                "covariance block was not requested in compute()"
            ) from e
        return self._values[rows, :][:, col_idx]


class Covariance:
    """reference: Covariance (covariance.h)."""

    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._cov = None  # dense tangent-space covariance
        self._program = None

    @full_f32_matmuls
    def compute(self, covariance_blocks: Sequence[tuple], problem) -> bool:
        """Compute covariance for the given (block_i, block_j) pairs.

        reference: Covariance::Compute. Returns False when J is rank
        deficient beyond the allowed null space.
        """
        program = problem.compile()
        ev = program.evaluator()
        state = program.state_vector()
        _, _, jac, _ = ev.evaluate(state, apply_loss=self.options.apply_loss_function)

        if self.options.algorithm_type == CovarianceAlgorithmType.SPARSE_QR:
            ok = self._compute_sparse(jac, program, covariance_blocks)
            if not ok:
                return False
        elif (
            self.options.algorithm_type
            == CovarianceAlgorithmType.ITERATIVE_PCG
        ):
            ok = self._compute_iterative(jac, program, covariance_blocks)
            if not ok:
                return False
        else:
            dense_j = np.asarray(jac.to_dense())
            jtj = dense_j.T @ dense_j

            # DENSE_SVD with eigenvalue thresholding
            # (covariance_impl.cc ComputeCovarianceValuesUsingDenseSVD)
            w, v = np.linalg.eigh(jtj)
            max_w = float(np.max(w)) if w.size else 0.0
            tol = self.options.min_reciprocal_condition_number * max_w
            rank_deficiency = int(np.sum(w <= tol))
            if self.options.null_space_rank >= 0 and rank_deficiency > self.options.null_space_rank:
                return False
            inv_w = np.where(w > tol, 1.0 / np.maximum(w, 1e-300), 0.0)
            self._cov = (v * inv_w) @ v.T
        self._program = program
        self._problem = problem
        return True

    def _compute_sparse(self, jac, program, covariance_blocks) -> bool:
        """SPARSE_QR algorithm: factor J^T J on the host and solve only for
        the tangent columns the requested block pairs touch.

        Same role as the reference's SUITE_SPARSE_QR / EIGEN_SPARSE_QR paths
        (covariance_impl.cc ComputeCovarianceValuesUsingSparseQR) — a host
        sparse factorization that avoids densifying J; here SuperLU of
        R^T R = J^T J with per-column solves instead of a QR, with rank
        deficiency detected from the factor's diagonal.
        """
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        vals, cols, row_ptr = jac.to_crs()
        n = jac.num_cols
        j = sp.csr_matrix(
            (np.asarray(vals, dtype=np.float64), cols, row_ptr),
            shape=(jac.num_rows, n),
        )
        jtj = (j.T @ j).tocsc()

        cols_wanted = self._wanted_cols(program, covariance_blocks)

        try:
            lu = spla.splu(jtj)
        except RuntimeError:
            return False  # singular factorization
        du = np.abs(lu.U.diagonal())
        max_d = float(du.max()) if du.size else 0.0
        rank_deficiency = int(
            np.sum(du <= self.options.min_reciprocal_condition_number * max_d)
        )
        if (
            self.options.null_space_rank >= 0
            and rank_deficiency > self.options.null_space_rank
        ):
            return False

        rhs = np.zeros((n, len(cols_wanted)))
        rhs[cols_wanted, np.arange(len(cols_wanted))] = 1.0
        x = lu.solve(rhs)
        self._cov = _ColumnSubsetMatrix(n, cols_wanted, x)
        return True

    def _wanted_cols(self, program, covariance_blocks) -> np.ndarray:
        """Union of tangent columns the requested block pairs touch."""
        wanted = set()
        for bi, bj in covariance_blocks:
            for b in (bi, bj):
                off = int(program.t_offsets[b])
                if off < 0:
                    raise ValueError(
                        f"parameter block {b} is constant or removed"
                    )
                wanted.update(range(off, off + int(program.tangent_sizes[b])))
        return np.array(sorted(wanted), dtype=np.int64)

    def _compute_iterative(self, jac, program, covariance_blocks) -> bool:
        """ITERATIVE_PCG: device-resident batched column-subset solves.

        Covariance at BA scale (the reference's threaded SUITE_SPARSE_QR
        territory, covariance_impl.cc:700-889 — threaded per-column solves):
        solve (J^T J) X = E for all requested tangent columns at once by
        vmapping one PCG over the RHS columns — J is never materialized,
        nothing leaves the device until the single result fetch, and the
        whole column batch is one device program (in place of the
        reference's ThreadPool over columns).

        Failure semantics: the tolerance is floored at a multiple of the
        Jacobian dtype's eps (an f32 Jacobian cannot reach 1e-10), and rank
        deficiency is reported only on PCG *breakdown* (p'Ap <= 0) — merely
        exhausting the iteration cap on a well-conditioned-but-slow system
        does not masquerade as singularity.
        """
        import jax

        from .linalg.cg import conjugate_gradients
        from .linalg.preconditioners import BlockDiagSolver

        cols_wanted = self._wanted_cols(program, covariance_blocks)
        n = program.num_effective_parameters
        dtype = jac._dtype()
        dsq = jnp.zeros((n,), dtype=dtype)
        prec = BlockDiagSolver(program, jac.block_diag_jtj())
        max_iters = self.options.iterative_max_iterations or n
        # Floor the requested tolerance at what the Jacobian dtype can
        # actually deliver (~50 eps relative residual).
        tol = max(
            self.options.iterative_tolerance,
            50.0 * float(jnp.finfo(dtype).eps),
        )

        def solve_col(e):
            r = conjugate_gradients(
                matvec=lambda v: jac.jtj_multiply(v, dsq),
                b=e,
                preconditioner=prec,
                max_iterations=max_iters,
                tolerance=tol,
            )
            return r.x, r.converged, r.breakdown

        es = jnp.zeros((len(cols_wanted), n), dtype=dtype)
        es = es.at[np.arange(len(cols_wanted)), cols_wanted].set(1.0)
        xs, converged, breakdown = jax.jit(jax.vmap(solve_col))(es)
        if bool(jnp.any(breakdown)):
            return False  # J^T J (numerically) rank deficient
        if not bool(jnp.all(converged)):
            import logging

            logging.getLogger(__name__).warning(
                "Covariance ITERATIVE_PCG: %d/%d columns hit the iteration "
                "cap (%d) before reaching tolerance %.2e; raise "
                "iterative_max_iterations or loosen iterative_tolerance.",
                int(jnp.sum(~converged)),
                len(cols_wanted),
                max_iters,
                tol,
            )
            return False  # not converged (distinct from breakdown, see log)
        self._cov = _ColumnSubsetMatrix(
            n, cols_wanted, np.asarray(xs, dtype=np.float64).T
        )
        return True

    def _tangent_slice(self, block: int):
        program = self._program
        off = int(program.t_offsets[block])
        if off < 0:
            raise ValueError(f"parameter block {block} is constant or removed")
        return off, int(program.tangent_sizes[block])

    def get_covariance_block(self, block_i: int, block_j: int, tangent: bool = True):
        """Covariance block (in tangent space by default; lifted to ambient
        via the plus Jacobian otherwise — reference
        GetCovarianceBlockInTangentSpace / GetCovarianceBlock)."""
        if self._cov is None:
            raise RuntimeError("call compute() first")
        oi, si = self._tangent_slice(block_i)
        oj, sj = self._tangent_slice(block_j)
        cov_t = self._cov[oi : oi + si, oj : oj + sj]
        if tangent:
            return cov_t
        pj_i = self._plus_jacobian(block_i)
        pj_j = self._plus_jacobian(block_j)
        return pj_i @ cov_t @ pj_j.T

    def _plus_jacobian(self, block: int) -> np.ndarray:
        b = self._problem._blocks[block]
        if b.manifold is None:
            return np.eye(b.size)
        return np.asarray(b.manifold.plus_jacobian(jnp.asarray(b.values)))
