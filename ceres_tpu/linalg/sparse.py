"""Sparse direct solvers on the host (scipy), with iterative refinement.

reference: SparseNormalCholeskySolver (sparse_normal_cholesky_solver.cc) over
SuiteSparse/Eigen/Accelerate backends (suitesparse.cc, eigensparse.cc,
sparse_cholesky.cc) + mixed-precision refinement (iterative_refiner.cc).
Those backends are *CPU* libraries in the reference too — the analog here is
scipy.sparse's SuperLU on the host, consuming the CRS export of the
device-resident BlockJacobian. Used when the problem has general sparsity
that neither the dense path (too big) nor Schur (no elimination structure)
fits; the device-side CGNR path remains the device-resident option.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - import guard
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    HAVE_SCIPY = True
except Exception:  # pragma: no cover
    HAVE_SCIPY = False


def solve_sparse_normal_cholesky(
    jac, res_groups, grad, dsq, refinement_iterations: int = 2
):
    """Solve (J^T J + diag(dsq)) step = -grad with a host sparse
    factorization + iterative refinement. All inputs are device arrays; the
    Jacobian crosses to host once per outer iteration (the reference's
    sparse backends do the same H2D/D2H round trip in reverse).
    """
    if not HAVE_SCIPY:
        raise RuntimeError("scipy unavailable for SPARSE_NORMAL_CHOLESKY")
    vals, cols, row_ptr = jac.to_crs()
    n = jac.num_cols
    j = sp.csr_matrix(
        (np.asarray(vals, dtype=np.float64), cols, row_ptr),
        shape=(jac.num_rows, n),
    )
    a = (j.T @ j).tocsc() + sp.diags(np.asarray(dsq, dtype=np.float64))
    rhs = -np.asarray(grad, dtype=np.float64)
    solver = spla.splu(a.tocsc())
    x = solver.solve(rhs)
    # iterative refinement (iterative_refiner.cc SolveRefine)
    for _ in range(refinement_iterations):
        r = rhs - a @ x
        x = x + solver.solve(r)
    return x


class SubsetPreconditioner:
    """M = Q'Q + diag(dsq), Q = user-selected residual rows of J.

    reference: subset_preconditioner.cc:68-115 — the reference also routes
    this through a *host* sparse Cholesky (SuiteSparse/Eigen); here the CRS
    export of the device Jacobian is factored with SuperLU once per outer
    iteration, and each PCG application crosses to the host through
    jax.pure_callback (same per-apply host boundary as the reference's
    RightMultiplyAndAccumulate -> sparse_cholesky_->Solve).
    """

    def __init__(self, jac, subset_rows, dsq):
        if not HAVE_SCIPY:
            raise RuntimeError("scipy unavailable for SUBSET preconditioner")
        vals, cols, row_ptr = jac.to_crs()
        n = jac.num_cols
        j = sp.csr_matrix(
            (np.asarray(vals, dtype=np.float64), cols, row_ptr),
            shape=(jac.num_rows, n),
        )
        q = j[np.asarray(subset_rows)]
        a = (q.T @ q).tocsc() + sp.diags(np.asarray(dsq, dtype=np.float64))
        self._solver = spla.splu(a)
        self._n = n
        self._dtype = np.asarray(dsq).dtype

    def __call__(self, r):
        import jax

        def host_solve(x):
            return self._solver.solve(np.asarray(x, dtype=np.float64)).astype(
                self._dtype
            )

        return jax.pure_callback(
            host_solve,
            jax.ShapeDtypeStruct(r.shape, r.dtype),
            r,
            vmap_method="sequential",
        )
