"""Dense linear solvers for the trust-region step.

reference: DenseQRSolver (dense_qr_solver.cc, dense_qr.cc) and
DenseNormalCholeskySolver (dense_normal_cholesky_solver.cc,
dense_cholesky.cc). Design: materialize the (small) dense Jacobian from
the block groups and solve on-device with jnp QR / Cholesky; the reference's
CUDA cuSolver backends map to XLA's linalg (cuSOLVER on the GPU).

All solvers answer: minimize ||J step + r||^2 + ||D step||^2, i.e.
(J^T J + D^T D) step = -J^T r, returning the step in tangent space.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve_dense_qr(dense_j, res_flat, dsq):
    """QR on the D-augmented system [J; D] step = [-r; 0].

    reference: dense_qr_solver.cc:40-120 (augmented-row formulation).
    """
    num_eff = dense_j.shape[1]
    d = jnp.sqrt(dsq)
    a = jnp.concatenate([dense_j, jnp.diag(d)], axis=0)
    b = jnp.concatenate([-res_flat, jnp.zeros(num_eff, dtype=res_flat.dtype)])
    q, r = jnp.linalg.qr(a)
    step = jax.scipy.linalg.solve_triangular(r, q.T @ b, lower=False)
    return step


def solve_dense_normal_cholesky(dense_j, res_flat, dsq):
    """Cholesky on J^T J + diag(dsq).

    reference: dense_normal_cholesky_solver.cc.
    """
    jtj = dense_j.T @ dense_j + jnp.diag(dsq)
    rhs = -(dense_j.T @ res_flat)
    chol, low = jax.scipy.linalg.cho_factor(jtj, lower=True)
    return jax.scipy.linalg.cho_solve((chol, low), rhs)


def cholesky_solve_mixed(lhs, rhs, refine_iterations: int = 3,
                         factor_dtype=jnp.float32):
    """Low-precision Cholesky factorization + iterative refinement in the
    working dtype.

    reference: CUDADenseCholeskyMixedPrecision (dense_cholesky.h:246,
    dense_cholesky.cc — fp32 cusolverDnSpotrf + fp64 refinement via
    DenseIterativeRefiner, iterative_refiner.cc:74-101). Shape: the
    factorization and triangular solves run in f32; only the
    cheap residual matvec r = b - A x runs in the working dtype. Each
    refinement sweep is `x += chol^-1 (b - A x)`.
    """
    work_dtype = lhs.dtype
    chol, low = jax.scipy.linalg.cho_factor(lhs.astype(factor_dtype), lower=True)

    def low_solve(v):
        return jax.scipy.linalg.cho_solve(
            (chol, low), v.astype(factor_dtype)
        ).astype(work_dtype)

    x = low_solve(rhs)
    for _ in range(refine_iterations):
        r = rhs - lhs @ x  # working-precision residual
        x = x + low_solve(r)
    return x


def solve_dense_normal_cholesky_mixed(dense_j, res_flat, dsq,
                                      refine_iterations: int = 3):
    """Mixed-precision variant of solve_dense_normal_cholesky: the normal
    equations are formed in the working dtype, factored in f32, and the
    solution refined back to working precision.

    reference: DenseNormalCholeskySolver with
    Options::use_mixed_precision_solves
    (dense_cholesky.h:246, iterative_refiner.cc).
    """
    jtj = dense_j.T @ dense_j + jnp.diag(dsq)
    rhs = -(dense_j.T @ res_flat)
    return cholesky_solve_mixed(jtj, rhs, refine_iterations)
