"""Python support layer for the C API (native/ceres_tpu_c_api.cc).

reference: include/ceres/c_api.h + internal/ceres/c_api.cc (185 LoC): a
minimal C surface — init, stock loss functions, problem create/free,
add_residual_block with a user C callback that fills residuals and
(optionally) analytic jacobians, and solve with default options.

Shape: the C callback is a host function, so it enters the JAX
graph through `jax.pure_callback` (one host call per residual block per
evaluation — the reference's C path likewise runs user callbacks on the
CPU); its analytic jacobians feed a custom_jvp so the rest of the pipeline
(robust loss correction, trust region, linear solvers) is exactly the
normal device path. User parameter memory is adopted in place via
numpy.ctypeslib and written back after the solve, matching the reference's
user-owned-storage contract (c_api.cc ceres_solve).
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np

from .autodiff import CostFunction
from .loss import (
    ArctanLoss,
    CauchyLoss,
    HuberLoss,
    LossFunction,
    SoftLOneLoss,
    TolerantLoss,
)
from .problem import Problem
from .solvers.solver import solve
from .types import SolverOptions

# int (*ceres_cost_function_t)(void* user_data, double** parameters,
#                              double* residuals, double** jacobians)
COST_FUNC_T = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_void_p,
    ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
)


class _CCallbackCost:
    """Calls the user's C cost function (value + analytic jacobians)."""

    def __init__(self, fn_addr: int, user_data: int, num_residuals: int, sizes):
        self.fn = COST_FUNC_T(fn_addr)
        self.user_data = ctypes.c_void_p(user_data)
        self.num_residuals = int(num_residuals)
        self.sizes = tuple(int(s) for s in sizes)

    def _call(self, params, want_jac: bool):
        k = len(self.sizes)
        bufs = [np.ascontiguousarray(p, dtype=np.float64) for p in params]
        param_ptrs = (ctypes.POINTER(ctypes.c_double) * k)(
            *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for b in bufs]
        )
        res = np.zeros(self.num_residuals, dtype=np.float64)
        if want_jac:
            jacs = [
                np.zeros((self.num_residuals, s), dtype=np.float64)
                for s in self.sizes
            ]
            jac_ptrs = (ctypes.POINTER(ctypes.c_double) * k)(
                *[j.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for j in jacs]
            )
            ok = self.fn(
                self.user_data,
                param_ptrs,
                res.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                jac_ptrs,
            )
        else:
            jacs = []
            ok = self.fn(
                self.user_data,
                param_ptrs,
                res.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                None,
            )
        if not ok:
            res[:] = np.nan  # cooperative abort -> non-finite -> FAILURE
            for j in jacs:
                j[:] = np.nan
        return res, jacs

    def value(self, *params):
        return self._call(params, False)[0]

    def value_and_jacs(self, *params):
        res, jacs = self._call(params, True)
        return (res, *jacs)


_COST_CACHE: dict = {}
_LOSS_CACHE: dict = {}


def make_callback_cost_function(fn_addr, user_data, num_residuals, sizes):
    """CostFunction whose value and JVP route through the C callback.

    Cached per (address, user_data, signature) so that residual blocks
    sharing one C callback batch into a single evaluation group — the same
    role type-bucketing plays in the reference (problem_cuda.h:462-468).
    """
    key = (int(fn_addr), int(user_data), int(num_residuals), tuple(sizes))
    if key in _COST_CACHE:
        return _COST_CACHE[key]
    from .utils.dtypes import default_dtype

    cb = _CCallbackCost(fn_addr, user_data, num_residuals, sizes)
    r = cb.num_residuals
    sizes = cb.sizes

    @jax.custom_jvp
    def fn(params, data):
        dt = default_dtype()
        out = jax.pure_callback(
            lambda *ps: cb.value(*ps).astype(dt),
            jax.ShapeDtypeStruct((r,), dt),
            *params,
            vmap_method="sequential",
        )
        return out.astype(params[0].dtype)

    @fn.defjvp
    def fn_jvp(primals, tangents):
        params, _ = primals
        dparams, _ = tangents
        dt = default_dtype()
        shapes = (jax.ShapeDtypeStruct((r,), dt),) + tuple(
            jax.ShapeDtypeStruct((r, s), dt) for s in sizes
        )
        out = jax.pure_callback(
            lambda *ps: tuple(a.astype(dt) for a in cb.value_and_jacs(*ps)),
            shapes,
            *params,
            vmap_method="sequential",
        )
        res, jacs = out[0], out[1:]
        dtype = params[0].dtype
        tangent = sum(
            jnp.einsum("rs,s->r", j.astype(dtype), dp)
            for j, dp in zip(jacs, dparams)
        )
        return res.astype(dtype), tangent

    out = CostFunction(fn, num_residuals, name=f"c_callback_{fn_addr:#x}")
    _COST_CACHE[key] = out
    return out


_LOSS_KINDS = {
    0: lambda a, b: HuberLoss(a),
    1: lambda a, b: SoftLOneLoss(a),
    2: lambda a, b: CauchyLoss(a),
    3: lambda a, b: ArctanLoss(a),
    4: lambda a, b: TolerantLoss(a, b),
}


def make_stock_loss(kind: int, a: float, b: float) -> LossFunction:
    return _LOSS_KINDS[int(kind)](float(a), float(b))


def stock_loss_rho(kind: int, a: float, b: float, squared_norm: float):
    """rho, rho', rho'' of a stock loss at squared_norm (the C
    ceres_stock_loss_function entry; parity: c_api.cc)."""
    loss = make_stock_loss(kind, a, b)
    r0, r1, r2 = loss.rho(jnp.asarray(squared_norm, jnp.float64))
    return (float(r0), float(r1), float(r2))


# void (*ceres_loss_function_t)(void* user_data, double squared_norm,
#                               double out[3])
LOSS_FUNC_T = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_double)
)


class CCallbackLoss(LossFunction):
    """LossFunction backed by a user C loss callback (host round trip per
    batch through pure_callback, like the cost callback)."""

    def __init__(self, fn_addr: int, user_data: int):
        self.fn = LOSS_FUNC_T(fn_addr)
        self.user_data = ctypes.c_void_p(user_data)

    def _rho_host(self, s):
        s = np.atleast_1d(np.asarray(s, dtype=np.float64))
        out = np.zeros((3,) + s.shape, dtype=np.float64)
        buf = (ctypes.c_double * 3)()
        for i, si in enumerate(s.reshape(-1)):
            self.fn(self.user_data, float(si), buf)
            out[0].reshape(-1)[i] = buf[0]
            out[1].reshape(-1)[i] = buf[1]
            out[2].reshape(-1)[i] = buf[2]
        return out[0], out[1], out[2]

    def rho(self, s):
        shape = jnp.shape(s)
        dt = jnp.asarray(s).dtype
        shapes = tuple(jax.ShapeDtypeStruct(shape, dt) for _ in range(3))
        r0, r1, r2 = jax.pure_callback(
            lambda x: tuple(
                np.asarray(a, dtype=dt).reshape(shape)
                for a in self._rho_host(x)
            ),
            shapes,
            s,
            vmap_method="sequential",
        )
        return r0, r1, r2


class CProblem:
    """Problem wrapper owning adopted user parameter memory."""

    def __init__(self):
        self.problem = Problem()
        self._param_arrays: dict[int, np.ndarray] = {}  # addr -> adopted array
        self._param_handles: dict[int, object] = {}

    def _adopt(self, addr: int, size: int):
        if addr not in self._param_arrays:
            buf = np.ctypeslib.as_array(
                ctypes.cast(addr, ctypes.POINTER(ctypes.c_double)), shape=(size,)
            )
            self._param_arrays[addr] = buf
            self._param_handles[addr] = self.problem.add_parameter_block(
                np.array(buf, dtype=np.float64)
            )
        return self._param_handles[addr]

    def add_residual_block_c(
        self,
        cost_fn_addr: int,
        cost_user_data: int,
        loss_kind: int,  # -1: none / custom; >=0: stock loss index
        loss_a: float,
        loss_b: float,
        num_residuals: int,
        param_addrs,
        param_sizes,
        custom_loss_fn: int = 0,
        custom_loss_data: int = 0,
    ) -> int:
        cost = make_callback_cost_function(
            cost_fn_addr, cost_user_data, num_residuals, param_sizes
        )
        if loss_kind >= 0:
            loss = make_stock_loss(loss_kind, loss_a, loss_b)
        elif custom_loss_fn:
            lkey = (int(custom_loss_fn), int(custom_loss_data))
            if lkey not in _LOSS_CACHE:
                _LOSS_CACHE[lkey] = CCallbackLoss(custom_loss_fn, custom_loss_data)
            loss = _LOSS_CACHE[lkey]
        else:
            loss = None
        handles = [
            self._adopt(int(a), int(s)) for a, s in zip(param_addrs, param_sizes)
        ]
        rb = self.problem.add_residual_block(cost, loss, handles)
        return int(rb)

    def solve(self) -> str:
        opts = SolverOptions(minimizer_progress_to_stdout=True)
        summary = solve(opts, self.problem)
        # write solved values back into the adopted user memory
        for addr, handle in self._param_handles.items():
            self._param_arrays[addr][:] = self.problem.parameter_block_value(handle)
        return summary.brief_report()
