"""ceres_tpu — a JAX nonlinear least-squares framework.

Built from scratch in JAX/XLA with the capability surface of the
reference system (Ceres Solver + jwmak's GPU-parallel cost-function
evaluation layer; see SURVEY.md). Not a port: residual blocks batch by
signature into vmapped XLA evaluations, Jacobians stay matrix-free on
device, and multi-chip scaling uses jax.sharding meshes + collectives.
"""

from .autodiff import AnalyticCostFunction, CostFunction, NumericDiffCostFunction
from .cost_functions import (
    conditioned_cost_function,
    cost_function_to_functor,
    normal_prior,
    scaled_cost_function,
)
from .loss import (
    ArctanLoss,
    CauchyLoss,
    ComposedLoss,
    HuberLoss,
    LossFunction,
    ScaledLoss,
    SoftLOneLoss,
    TolerantLoss,
    TrivialLoss,
    TukeyLoss,
)
from .manifolds import (
    AutoDiffManifold,
    EigenQuaternionManifold,
    EuclideanManifold,
    LineManifold,
    Manifold,
    ProductManifold,
    QuaternionManifold,
    SphereManifold,
    SubsetManifold,
)
from .covariance import Covariance, CovarianceOptions
from .ordering import ParameterBlockOrdering
from .gradient_checker import check_gradients
from .gradient_problem import GradientProblem, solve_gradient_problem
from .problem import Problem
from .tiny_solver import TinySolverOptions, tiny_solve, tiny_solve_batched
from .types import (
    CallbackReturnType,
    DoglegType,
    IterationSummary,
    LinearSolverType,
    LineSearchDirectionType,
    LineSearchType,
    LoggingType,
    MinimizerType,
    PreconditionerType,
    SolverOptions,
    Summary,
    TerminationType,
    TrustRegionStrategyType,
    VisibilityClusteringType,
)

__version__ = "0.1.0"

__all__ = [
    "AnalyticCostFunction",
    "CostFunction",
    "ParameterBlockOrdering",
    "NumericDiffCostFunction",
    "Problem",
    "SolverOptions",
    "Summary",
    "IterationSummary",
    "LinearSolverType",
    "PreconditionerType",
    "TrustRegionStrategyType",
    "VisibilityClusteringType",
    "DoglegType",
    "MinimizerType",
    "TerminationType",
    "CallbackReturnType",
    "LineSearchDirectionType",
    "LineSearchType",
    "LoggingType",
    "normal_prior",
    "conditioned_cost_function",
    "cost_function_to_functor",
    "scaled_cost_function",
    "LossFunction",
    "TrivialLoss",
    "HuberLoss",
    "SoftLOneLoss",
    "CauchyLoss",
    "ArctanLoss",
    "TolerantLoss",
    "TukeyLoss",
    "ScaledLoss",
    "ComposedLoss",
    "Manifold",
    "EuclideanManifold",
    "SubsetManifold",
    "QuaternionManifold",
    "EigenQuaternionManifold",
    "SphereManifold",
    "LineManifold",
    "ProductManifold",
    "AutoDiffManifold",
    "Covariance",
    "CovarianceOptions",
    "GradientProblem",
    "solve_gradient_problem",
    "check_gradients",
    "tiny_solve",
    "tiny_solve_batched",
    "TinySolverOptions",
    "solve",
]


def solve(options, problem):
    """Solve the problem; returns a Summary. reference: ceres::Solve
    (solver.cc:720-846)."""
    from .solvers.solver import solve as _solve

    return _solve(options, problem)
