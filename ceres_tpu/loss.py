"""Robust loss functions rho(s) with first and second derivatives.

Parity with the reference loss family (include/ceres/loss_function.h:87-392,
internal/ceres/loss_function.cc:44-175), re-designed as frozen dataclasses
whose `rho(s)` is vectorized over a batch of squared norms `s` (one per
residual block) — the analog of per-block `LossFunction::Evaluate` calls.

Contract (identical to the reference): rho(s) -> (rho0, rho1, rho2) with
  cost       = 0.5 * rho0
  rho1       = d rho / d s   (must be positive; clamped to tiny)
  rho2       = d^2 rho / d s^2
All branches are expressed with `jnp.where` on *safe* operands so that no NaN
leaks through the untaken branch under jit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


def _tiny(dtype):
    return jnp.asarray(np.finfo(np.dtype(dtype)).tiny, dtype=dtype)


class LossFunction:
    """Base class. Instances are hashable value objects; residual blocks with
    equal losses batch into one evaluation group."""

    def rho(self, s):
        """s: array of squared residual norms -> (rho0, rho1, rho2)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class TrivialLoss(LossFunction):
    """rho(s) = s (reference: loss_function.cc:44-48)."""

    def rho(self, s):
        one = jnp.ones_like(s)
        return s, one, jnp.zeros_like(s)


@dataclasses.dataclass(frozen=True)
class HuberLoss(LossFunction):
    """reference: loss_function.cc:50-64; a_=a, b_=a^2."""

    a: float

    def rho(self, s):
        a2 = self.a * self.a
        out = s > a2
        r = jnp.sqrt(jnp.maximum(s, a2))  # safe: only used when s > a2
        rho0 = jnp.where(out, 2.0 * self.a * r - a2, s)
        rho1 = jnp.where(out, jnp.maximum(_tiny(s.dtype), self.a / r), 1.0)
        rho2 = jnp.where(out, -rho1 / (2.0 * jnp.maximum(s, a2)), 0.0)
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class SoftLOneLoss(LossFunction):
    """rho(s) = 2 b (sqrt(1 + s/b) - 1); reference: loss_function.cc:66-73."""

    a: float

    def rho(self, s):
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        tmp = jnp.sqrt(total)
        rho0 = 2.0 * b * (tmp - 1.0)
        rho1 = jnp.maximum(_tiny(s.dtype), 1.0 / tmp)
        rho2 = -(c * rho1) / (2.0 * total)
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class CauchyLoss(LossFunction):
    """rho(s) = b log(1 + s/b); reference: loss_function.cc:75-82."""

    a: float

    def rho(self, s):
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        inv = 1.0 / total
        rho0 = b * jnp.log(total)
        rho1 = jnp.maximum(_tiny(s.dtype), inv)
        rho2 = -c * inv * inv
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class ArctanLoss(LossFunction):
    """rho(s) = a atan2(s, a); reference: loss_function.cc:84-91."""

    a: float

    def rho(self, s):
        b = 1.0 / (self.a * self.a)
        inv = 1.0 / (1.0 + s * s * b)
        rho0 = self.a * jnp.arctan2(s, jnp.full_like(s, self.a))
        rho1 = jnp.maximum(_tiny(s.dtype), inv)
        rho2 = -2.0 * s * b * inv * inv
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class TolerantLoss(LossFunction):
    """reference: loss_function.cc:93-118; a = tolerance, b = transition width."""

    a: float
    b: float

    def rho(self, s):
        c = self.b * jnp.log1p(jnp.exp(-self.a / self.b))
        x = (s - self.a) / self.b
        # Large-x linearization to avoid overflow (loss_function.cc:101-112).
        big = x > 36.0
        x_safe = jnp.where(big, 0.0, x)
        e_x = jnp.exp(x_safe)
        rho0 = jnp.where(big, s - self.a - c, self.b * jnp.log1p(e_x) - c)
        rho1 = jnp.where(
            big, 1.0, jnp.maximum(_tiny(s.dtype), e_x / (1.0 + e_x))
        )
        rho2 = jnp.where(big, 0.0, 0.5 / (self.b * (1.0 + jnp.cosh(x_safe))))
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class TukeyLoss(LossFunction):
    """Tukey biweight; reference: loss_function.cc:120-133."""

    a: float

    def rho(self, s):
        a2 = self.a * self.a
        inlier = s <= a2
        value = jnp.where(inlier, 1.0 - s / a2, 0.0)
        value_sq = value * value
        rho0 = jnp.where(inlier, a2 / 3.0 * (1.0 - value_sq * value), a2 / 3.0)
        rho1 = jnp.where(inlier, value_sq, 0.0)
        rho2 = jnp.where(inlier, -2.0 / a2 * value, 0.0)
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class ScaledLoss(LossFunction):
    """a * rho_wrapped(s); reference: loss_function.cc:165-175. A None inner
    loss scales the trivial loss, matching the reference's nullptr case."""

    loss: LossFunction | None
    a: float

    def rho(self, s):
        if self.loss is None:
            one = jnp.ones_like(s)
            return self.a * s, self.a * one, jnp.zeros_like(s)
        r0, r1, r2 = self.loss.rho(s)
        return self.a * r0, self.a * r1, self.a * r2


class LossFunctionWrapper(LossFunction):
    """Mutable wrapper whose inner loss can be swapped between solves
    (reference: loss_function.h LossFunctionWrapper). Swapping the inner
    loss marks the owning Problem dirty via recompile on next solve; within
    one compiled solve the loss is fixed (XLA static graph)."""

    def __init__(self, loss: LossFunction | None):
        self._loss = loss

    def reset(self, loss: LossFunction | None):
        self._loss = loss

    def rho(self, s):
        if self._loss is None:
            one = jnp.ones_like(s)
            return s, one, jnp.zeros_like(s)
        return self._loss.rho(s)

    # value-equality keyed on the wrapped loss so signature grouping
    # distinguishes wrapper states
    def __hash__(self):
        return hash(("LossFunctionWrapper", self._loss))

    def __eq__(self, other):
        return (
            isinstance(other, LossFunctionWrapper) and self._loss == other._loss
        )


@dataclasses.dataclass(frozen=True)
class ComposedLoss(LossFunction):
    """f(g(s)); reference: loss_function.cc:136-163."""

    f: LossFunction
    g: LossFunction

    def rho(self, s):
        g0, g1, g2 = self.g.rho(s)
        f0, f1, f2 = self.f.rho(g0)
        return f0, f1 * g1, f2 * g1 * g1 + f1 * g2
