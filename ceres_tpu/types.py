"""Enums and option structs for the nonlinear least-squares solver.

Mirrors the *capability surface* of the reference enums/options
(reference: include/ceres/types.h:52-402, include/ceres/solver.h:65-841),
re-designed as Python enums + dataclasses. Only behaviourally meaningful
options are kept; CUDA/thread plumbing has no counterpart here (XLA handles
fusion/parallelism; multi-chip scaling is configured via `mesh`/sharding).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Sequence


class LinearSolverType(enum.Enum):
    # reference: include/ceres/types.h:58-103
    DENSE_NORMAL_CHOLESKY = "DENSE_NORMAL_CHOLESKY"
    DENSE_QR = "DENSE_QR"
    SPARSE_NORMAL_CHOLESKY = "SPARSE_NORMAL_CHOLESKY"
    DENSE_SCHUR = "DENSE_SCHUR"
    SPARSE_SCHUR = "SPARSE_SCHUR"
    ITERATIVE_SCHUR = "ITERATIVE_SCHUR"
    CGNR = "CGNR"


class PreconditionerType(enum.Enum):
    # reference: include/ceres/types.h:105-161
    IDENTITY = "IDENTITY"
    JACOBI = "JACOBI"
    SCHUR_JACOBI = "SCHUR_JACOBI"
    SCHUR_POWER_SERIES_EXPANSION = "SCHUR_POWER_SERIES_EXPANSION"
    CLUSTER_JACOBI = "CLUSTER_JACOBI"
    CLUSTER_TRIDIAGONAL = "CLUSTER_TRIDIAGONAL"
    SUBSET = "SUBSET"


class VisibilityClusteringType(enum.Enum):
    # reference: include/ceres/types.h VisibilityClusteringType
    CANONICAL_VIEWS = "CANONICAL_VIEWS"
    SINGLE_LINKAGE = "SINGLE_LINKAGE"


class TrustRegionStrategyType(enum.Enum):
    # reference: include/ceres/types.h:163-175
    LEVENBERG_MARQUARDT = "LEVENBERG_MARQUARDT"
    DOGLEG = "DOGLEG"


class DoglegType(enum.Enum):
    # reference: include/ceres/types.h:177-189
    TRADITIONAL_DOGLEG = "TRADITIONAL_DOGLEG"
    SUBSPACE_DOGLEG = "SUBSPACE_DOGLEG"


class MinimizerType(enum.Enum):
    TRUST_REGION = "TRUST_REGION"
    LINE_SEARCH = "LINE_SEARCH"


class LineSearchDirectionType(enum.Enum):
    # reference: include/ceres/types.h:200-246
    STEEPEST_DESCENT = "STEEPEST_DESCENT"
    NONLINEAR_CONJUGATE_GRADIENT = "NONLINEAR_CONJUGATE_GRADIENT"
    LBFGS = "LBFGS"
    BFGS = "BFGS"


class NonlinearConjugateGradientType(enum.Enum):
    FLETCHER_REEVES = "FLETCHER_REEVES"
    POLAK_RIBIERE = "POLAK_RIBIERE"
    HESTENES_STIEFEL = "HESTENES_STIEFEL"


class LineSearchType(enum.Enum):
    ARMIJO = "ARMIJO"
    WOLFE = "WOLFE"


class LineSearchInterpolationType(enum.Enum):
    BISECTION = "BISECTION"
    QUADRATIC = "QUADRATIC"
    CUBIC = "CUBIC"


class TerminationType(enum.Enum):
    # reference: include/ceres/types.h:284-350
    CONVERGENCE = "CONVERGENCE"
    NO_CONVERGENCE = "NO_CONVERGENCE"
    FAILURE = "FAILURE"
    USER_SUCCESS = "USER_SUCCESS"
    USER_FAILURE = "USER_FAILURE"


class CallbackReturnType(enum.Enum):
    # reference: include/ceres/iteration_callback.h
    SOLVER_CONTINUE = "SOLVER_CONTINUE"
    SOLVER_ABORT = "SOLVER_ABORT"
    SOLVER_TERMINATE_SUCCESSFULLY = "SOLVER_TERMINATE_SUCCESSFULLY"


class LoggingType(enum.Enum):
    SILENT = "SILENT"
    PER_MINIMIZER_ITERATION = "PER_MINIMIZER_ITERATION"


class CovarianceAlgorithmType(enum.Enum):
    # reference: include/ceres/covariance.h (DENSE_SVD, SPARSE_QR).
    # ITERATIVE_PCG is the large-scale extension: device-resident batched
    # PCG column solves against the matrix-free J^T J operator — the path
    # that stays usable at BA scale where densifying J^T J (DENSE_SVD) or
    # host-factoring it (SPARSE_QR) is not (covariance.py).
    DENSE_SVD = "DENSE_SVD"
    SPARSE_QR = "SPARSE_QR"
    ITERATIVE_PCG = "ITERATIVE_PCG"


class NumericDiffMethodType(enum.Enum):
    # reference: include/ceres/types.h:252-282
    CENTRAL = "CENTRAL"
    FORWARD = "FORWARD"
    RIDDERS = "RIDDERS"


@dataclasses.dataclass
class SolverOptions:
    """Options controlling the solve.

    Field names/defaults track the reference `Solver::Options`
    (include/ceres/solver.h:65-841) where the concept carries over.
    """

    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION

    # --- trust region ---
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG
    max_num_iterations: int = 50
    max_solver_time_in_seconds: float = 1e9
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5
    max_num_consecutive_invalid_steps: int = 5
    jacobi_scaling: bool = True
    # Fuse whole trust-region iterations into one compiled device loop when
    # eligible (no bounds/callbacks/inner iterations; jittable linear
    # solver). Decision logic is identical to the host loop; only
    # per-iteration wall-clock bookkeeping is amortized. The
    # counterpart of keeping the reference's outer loop off the
    # host<->device boundary (SURVEY.md §7 "host-side control loop latency").
    fused_execution: bool = True
    # Number of LM iterations compiled into one fused device program
    # (solvers/fused_loop.py). Smaller chunks bound single-dispatch runtime
    # (long device programs can trip runtime watchdogs) and give more
    # frequent host-side progress/timing rows; larger chunks amortize
    # dispatch latency. 0 -> module default.
    fused_execution_chunk_iters: int = 0

    # --- convergence tolerances (solver.h:430-470) ---
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8

    # --- linear solver ---
    linear_solver_type: LinearSolverType = LinearSolverType.DENSE_QR
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    eta: float = 1e-1  # forcing-sequence tolerance for iterative solvers
    # ITERATIVE_SCHUR: materialize S once per step and run PCG against the
    # dense reduced matrix (one dense matmul per CG iteration) instead of the
    # 4-product implicit operator — wins when cameras are few and points
    # many (reference: Solver::Options::use_explicit_schur_complement)
    use_explicit_schur_complement: bool = False
    # Parameter-block handles to eliminate in Schur-type solvers (the role
    # of Solver::Options::linear_solver_ordering group 0,
    # reorder_program.cc). None = automatic independent-set partition. The
    # given blocks must form an independent set (validated at solve time).
    linear_solver_ordering: Optional[Sequence[int]] = None
    use_spse_initialization: bool = False
    max_num_spse_iterations: int = 5
    spse_tolerance: float = 0.1
    # clustering algorithm for CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL
    # (reference: solver.h visibility_clustering_type)
    visibility_clustering_type: VisibilityClusteringType = (
        VisibilityClusteringType.CANONICAL_VIEWS
    )
    # residual-block handles whose rows form the SUBSET preconditioner
    # (reference: solver.h residual_blocks_for_subset_preconditioner)
    residual_blocks_for_subset_preconditioner: list = dataclasses.field(
        default_factory=list
    )

    # --- line search (first-order) ---
    line_search_direction_type: LineSearchDirectionType = LineSearchDirectionType.LBFGS
    line_search_type: LineSearchType = LineSearchType.WOLFE
    nonlinear_conjugate_gradient_type: NonlinearConjugateGradientType = (
        NonlinearConjugateGradientType.FLETCHER_REEVES
    )
    max_lbfgs_rank: int = 20
    use_approximate_eigenvalue_bfgs_scaling: bool = False
    line_search_interpolation_type: LineSearchInterpolationType = (
        LineSearchInterpolationType.CUBIC
    )
    min_line_search_step_size: float = 1e-9
    line_search_sufficient_function_decrease: float = 1e-4
    max_line_search_step_contraction: float = 1e-3
    min_line_search_step_contraction: float = 0.6
    max_num_line_search_step_size_iterations: int = 20
    max_num_line_search_direction_restarts: int = 5
    line_search_sufficient_curvature_decrease: float = 0.9
    max_line_search_step_expansion: float = 10.0
    # Run the Armijo line-search polish on every valid trust-region step
    # even without bounds (upstream runs DoLineSearch only when
    # is_constrained, trust_region_minimizer.cc:101-106; bounded problems
    # here always use the projected search). Helps curved-valley problems
    # (e.g. Rosenbrock) at the price of >= 1 extra residual evaluation per
    # iteration; forces the host loop.
    trust_region_use_line_search: bool = False

    # --- inner iterations ---
    use_inner_iterations: bool = False
    # Disable inner iterations for later TR iterations once a pass's
    # relative cost progress drops below this (reference solver.h
    # inner_iteration_tolerance, trust_region_minimizer.cc:564-570).
    inner_iteration_tolerance: float = 1e-3
    # Blocks the inner minimizer refines: group 0 of a
    # ParameterBlockOrdering (or a flat handle sequence). None = the
    # automatic independent-set partition (reference solver.h
    # inner_iteration_ordering, coordinate_descent_minimizer.cc:88-150).
    inner_iteration_ordering: Any = None

    # --- logging / callbacks ---
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    callbacks: list = dataclasses.field(default_factory=list)
    update_state_every_iteration: bool = False

    # Mixed-precision linear solves (reference: solver.h
    # use_mixed_precision_solves + max_num_refinement_iterations, realized
    # there as fp32 GPU factorization + fp64 refinement,
    # dense_cholesky.h:246). Here the PCG matvec reads a
    # bfloat16 copy of the Jacobian (half the memory traffic) while every reduction accumulates in float32 and the
    # preconditioner/RHS/back-substitution stay float32; the trust region's
    # own accept/reject loop absorbs the inexactness of the step.
    use_mixed_precision_solves: bool = False
    # Issue the LM step's rhs/preconditioner stage and PCG/back-substitution
    # stage as SEPARATE device dispatches (host loop only; implies
    # fused_execution=False is recommended). Needed when one combined step
    # executable's workspace exceeds one device's memory (the full
    # BAL-13682 solve on a 16 GB device). No reference analog.
    split_step_dispatch: bool = False
    max_num_refinement_iterations: int = 0

    # --- numerics (replaces the reference's fp64-everywhere) ---
    # dtype of the compiled evaluation / linear-algebra path. float64 requires
    # jax_enable_x64; float32 is the fast device path.
    dtype: Any = None  # None -> ceres_tpu.utils.dtypes.default_dtype()

    # --- multi-chip ---
    # Optional jax.sharding.Mesh; residual blocks are sharded over axis
    # `mesh_axis` and all reductions psum over it.
    mesh: Any = None
    mesh_axis: str = "dp"

    # --- gradient checking ---
    # Dump the LM subproblem (J CRS, residuals, gradient, D) at these
    # iterations as .npz files (reference: solver.h:742-749,
    # DumpLinearLeastSquaresProblem via levenberg_marquardt_strategy.cc).
    # Forces the host loop (the fused device loop cannot export).
    trust_region_minimizer_iterations_to_dump: tuple = ()
    trust_region_problem_dump_directory: str = "/tmp"

    check_gradients: bool = False
    gradient_check_relative_precision: float = 1e-8
    gradient_check_numeric_derivative_relative_step_size: float = 1e-6

    def is_valid(self) -> tuple[bool, str]:
        """Validate option combinations (reference: solver.cc:692-716)."""
        if self.max_num_iterations < 0:
            return False, "max_num_iterations must be >= 0"
        for name in (
            "function_tolerance",
            "gradient_tolerance",
            "parameter_tolerance",
        ):
            if getattr(self, name) < 0:
                return False, f"{name} must be >= 0"
        if self.initial_trust_region_radius <= 0:
            return False, "initial_trust_region_radius must be > 0"
        if self.min_trust_region_radius > self.max_trust_region_radius:
            return False, "min_trust_region_radius > max_trust_region_radius"
        if not (0 < self.min_relative_decrease < 1):
            return False, "min_relative_decrease must be in (0, 1)"
        if self.max_linear_solver_iterations < 1:
            return False, "max_linear_solver_iterations must be >= 1"
        return True, ""


@dataclasses.dataclass
class IterationSummary:
    """Per-iteration record (reference: include/ceres/iteration_callback.h)."""

    iteration: int = 0
    step_is_valid: bool = False
    step_is_nonmonotonic: bool = False
    step_is_successful: bool = False
    cost: float = 0.0
    cost_change: float = 0.0
    gradient_max_norm: float = 0.0
    gradient_norm: float = 0.0
    step_norm: float = 0.0
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    eta: float = 0.0
    step_size: float = 0.0
    line_search_function_evaluations: int = 0
    line_search_gradient_evaluations: int = 0
    line_search_iterations: int = 0
    linear_solver_iterations: int = 0
    iteration_time_in_seconds: float = 0.0
    step_solver_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0


@dataclasses.dataclass
class Summary:
    """Solve summary (reference: Solver::Summary, solver.h:845-1155)."""

    termination_type: TerminationType = TerminationType.FAILURE
    message: str = ""
    initial_cost: float = 0.0
    final_cost: float = 0.0
    fixed_cost: float = 0.0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_inner_iteration_steps: int = 0
    num_line_search_steps: int = 0
    iterations: list = dataclasses.field(default_factory=list)

    num_parameter_blocks: int = 0
    num_parameters: int = 0
    num_effective_parameters: int = 0
    num_residual_blocks: int = 0
    num_residuals: int = 0
    num_parameter_blocks_reduced: int = 0
    num_parameters_reduced: int = 0
    num_effective_parameters_reduced: int = 0
    num_residual_blocks_reduced: int = 0
    num_residuals_reduced: int = 0

    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    linear_solver_type_used: Optional[LinearSolverType] = None
    preconditioner_type_used: Optional[PreconditionerType] = None
    line_search_direction_type: Optional[LineSearchDirectionType] = None
    # True when the minimizer ran the device-fused lax.while_loop path
    # (solvers/fused_loop.py) rather than the host trust-region loop.
    used_fused_execution: bool = False

    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    num_residual_evaluations: int = 0
    num_jacobian_evaluations: int = 0
    num_linear_solves: int = 0
    # Per-call cumulative statistics (reference: ExecutionSummary,
    # execution_summary.h:89, surfaced via Evaluator::Statistics()).
    execution_summary: Any = None

    def brief_report(self) -> str:
        return (
            f"Solver Summary: iterations {len(self.iterations)}, "
            f"initial cost {self.initial_cost:.6e}, "
            f"final cost {self.final_cost:.6e}, "
            f"termination {self.termination_type.value} ({self.message})"
        )

    def full_report(self) -> str:
        """Human-readable rollup (reference: Summary::FullReport)."""
        lines = [
            "Solver report",
            "-------------",
            f"Parameter blocks    {self.num_parameter_blocks:>12d}",
            f"Parameters          {self.num_parameters:>12d}",
            f"Effective params    {self.num_effective_parameters:>12d}",
            f"Residual blocks     {self.num_residual_blocks:>12d}",
            f"Residuals           {self.num_residuals:>12d}",
            "",
            f"Minimizer           {self.minimizer_type.value}",
            f"Trust region        {self.trust_region_strategy_type.value}",
            f"Linear solver       "
            f"{self.linear_solver_type_used.value if self.linear_solver_type_used else 'n/a'}",
            f"Preconditioner      "
            f"{self.preconditioner_type_used.value if self.preconditioner_type_used else 'n/a'}",
            "",
            f"Initial cost        {self.initial_cost:.12e}",
            f"Final cost          {self.final_cost:.12e}",
            f"Termination         {self.termination_type.value} ({self.message})",
            "",
            f"Successful steps    {self.num_successful_steps:>12d}",
            f"Unsuccessful steps  {self.num_unsuccessful_steps:>12d}",
            f"Residual evals      {self.num_residual_evaluations:>12d}",
            f"Jacobian evals      {self.num_jacobian_evaluations:>12d}",
            f"Linear solves       {self.num_linear_solves:>12d}",
            "",
            f"Preprocessor time   {self.preprocessor_time_in_seconds:>12.6f} s",
            f"Minimizer time      {self.minimizer_time_in_seconds:>12.6f} s",
            f"  Residual eval     {self.residual_evaluation_time_in_seconds:>12.6f} s",
            f"  Jacobian eval     {self.jacobian_evaluation_time_in_seconds:>12.6f} s",
            f"  Linear solver     {self.linear_solver_time_in_seconds:>12.6f} s",
            f"Total time          {self.total_time_in_seconds:>12.6f} s",
        ]
        if self.execution_summary is not None:
            per_call = self.execution_summary.report_lines()
            if per_call:
                lines.append("")
                lines.extend(per_call)
        return "\n".join(lines)
