"""Manifolds: smooth (over-)parameterizations with Plus/Minus operations.

Capability parity with the reference manifold family
(include/ceres/manifold.h, internal/ceres/manifold.cc, sphere_manifold.h,
line_manifold.h, product_manifold.h), re-designed for JAX:

- every operation is a pure function on a single block, written with
  branch-free `jnp.where` select logic so it vmaps/jits cleanly over batches
  of blocks (the evaluator batches plus/plus_jacobian per manifold group);
- `plus_jacobian` is analytic (not autodiff) because several Plus operators
  involve `|delta|` which is not differentiable at delta=0.

Conventions match the reference exactly so differential tests can compare:
- Quaternion Plus: x_plus_delta = exp(delta) (x) quaternion product, with
  angle |delta| (manifold.cc:27-67); Ceres order [w,x,y,z], Eigen order
  [x,y,z,w].
- Sphere Plus via Householder reflection (sphere_manifold_functions.h,
  householder_vector.h).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np


class Manifold:
    """Base manifold. Subclasses are hashable value objects: two manifold
    instances that compare equal may share one compiled evaluation batch."""

    @property
    def ambient_size(self) -> int:
        raise NotImplementedError

    @property
    def tangent_size(self) -> int:
        raise NotImplementedError

    def plus(self, x, delta):
        """x ⊞ delta -> ambient point."""
        raise NotImplementedError

    def plus_jacobian(self, x):
        """d Plus(x, delta) / d delta at delta = 0: [ambient, tangent]."""
        raise NotImplementedError

    def minus(self, y, x):
        """Local coordinates of y in the tangent space at x: [tangent]."""
        raise NotImplementedError

    def minus_jacobian(self, x):
        """d Minus(y, x) / d y at y = x: [tangent, ambient]."""
        raise NotImplementedError

    # Default: right-multiply by plus_jacobian. Subclasses may fuse.
    def apply_plus_jacobian(self, jac_ambient, x):
        """jac_ambient [..., ambient] @ plus_jacobian(x) -> [..., tangent]."""
        return jac_ambient @ self.plus_jacobian(x)


@dataclasses.dataclass(frozen=True)
class EuclideanManifold(Manifold):
    """R^n with Plus = +. reference: manifold.h EuclideanManifold."""

    size: int

    @property
    def ambient_size(self) -> int:
        return self.size

    @property
    def tangent_size(self) -> int:
        return self.size

    def plus(self, x, delta):
        return x + delta

    def plus_jacobian(self, x):
        return jnp.eye(self.size, dtype=x.dtype)

    def minus(self, y, x):
        return y - x

    def minus_jacobian(self, x):
        return jnp.eye(self.size, dtype=x.dtype)

    def apply_plus_jacobian(self, jac_ambient, x):
        return jac_ambient


@dataclasses.dataclass(frozen=True, eq=True)
class SubsetManifold(Manifold):
    """Euclidean with a subset of coordinates held constant.

    reference: manifold.h SubsetManifold; constant coords produce zero columns
    in the plus Jacobian and are skipped in the tangent space.
    """

    size: int
    constant_indices: tuple

    def __post_init__(self):
        ci = tuple(sorted(set(int(i) for i in self.constant_indices)))
        object.__setattr__(self, "constant_indices", ci)
        for i in ci:
            if not 0 <= i < self.size:
                raise ValueError(f"constant index {i} out of range [0,{self.size})")

    @property
    def ambient_size(self) -> int:
        return self.size

    @property
    def tangent_size(self) -> int:
        return self.size - len(self.constant_indices)

    def _free_indices(self) -> np.ndarray:
        mask = np.ones(self.size, dtype=bool)
        mask[list(self.constant_indices)] = False
        return np.nonzero(mask)[0]

    def plus(self, x, delta):
        free = self._free_indices()
        return x.at[free].add(delta)

    def plus_jacobian(self, x):
        free = self._free_indices()
        jac = jnp.zeros((self.size, self.tangent_size), dtype=x.dtype)
        return jac.at[free, jnp.arange(self.tangent_size)].set(1.0)

    def minus(self, y, x):
        free = self._free_indices()
        return (y - x)[free]

    def minus_jacobian(self, x):
        return self.plus_jacobian(x).T

    def apply_plus_jacobian(self, jac_ambient, x):
        return jac_ambient[..., self._free_indices()]


def _quat_prod(a, b, order):
    """Hamilton product a ⊗ b with index order (w, x, y, z positions).

    Built with jnp.stack (not scatter) so the whole product is a handful of
    fused elementwise ops.
    """
    w, x, y, z = order
    out = [None] * 4
    out[w] = a[w] * b[w] - a[x] * b[x] - a[y] * b[y] - a[z] * b[z]
    out[x] = a[w] * b[x] + a[x] * b[w] + a[y] * b[z] - a[z] * b[y]
    out[y] = a[w] * b[y] - a[x] * b[z] + a[y] * b[w] + a[z] * b[x]
    out[z] = a[w] * b[z] + a[x] * b[y] - a[y] * b[x] + a[z] * b[w]
    return jnp.stack(out)


class _QuaternionBase(Manifold):
    """Unit quaternion manifold; subclass fixes component ordering.

    Plus(x, delta) = exp(delta) ⊗ x with rotation angle |delta|
    (reference: manifold.cc:27-67 QuaternionPlusImpl).
    """

    _order: tuple  # (w, x, y, z) index positions

    @property
    def ambient_size(self) -> int:
        return 4

    @property
    def tangent_size(self) -> int:
        return 3

    def _exp(self, delta):
        w, x, y, z = self._order
        norm2 = jnp.sum(delta * delta)
        norm = jnp.sqrt(norm2)
        # sin(t)/t, exact at 0 via select on safe operands.
        sinc = jnp.where(norm2 > 0, jnp.sin(norm) / jnp.where(norm2 > 0, norm, 1.0), 1.0)
        q = [None] * 4
        q[w] = jnp.cos(norm)
        q[x] = sinc * delta[0]
        q[y] = sinc * delta[1]
        q[z] = sinc * delta[2]
        return jnp.stack(q)

    def plus(self, x, delta):
        return _quat_prod(self._exp(delta), x, self._order)

    def plus_jacobian(self, x):
        # d/d delta_i at 0 of exp(delta) ⊗ x = e_i ⊗ x for imaginary units e_i
        # (matches manifold.cc QuaternionPlusJacobianImpl).
        w, xi, y, z = self._order
        cols = []
        for unit_pos in (xi, y, z):
            e_np = np.zeros(4)
            e_np[unit_pos] = 1.0
            e = jnp.asarray(e_np, dtype=x.dtype)
            cols.append(_quat_prod(e, x, self._order))
        return jnp.stack(cols, axis=1)

    def _conj(self, q):
        w, x, y, z = self._order
        sign = np.full(4, -1.0)
        sign[w] = 1.0
        return q * jnp.asarray(sign, dtype=q.dtype)

    def minus(self, y_, x):
        # ambient_y_minus_x = y ⊗ x^{-1}; delta = atan2(|im|, re)/|im| * im
        w, xi, yi, z = self._order
        d = _quat_prod(y_, self._conj(x), self._order)
        im = jnp.stack([d[xi], d[yi], d[z]])
        im_norm2 = jnp.sum(im * im)
        im_norm = jnp.sqrt(im_norm2)
        scale = jnp.where(
            im_norm2 > 0,
            jnp.arctan2(im_norm, d[w]) / jnp.where(im_norm2 > 0, im_norm, 1.0),
            1.0,
        )
        return scale * im

    def minus_jacobian(self, x):
        # d Minus(y, x)/dy at y=x: rows are imaginary parts of e_j-co-factor of
        # y ⊗ x^{-1}; equals plus_jacobian(x).T for unit quaternions.
        return self.plus_jacobian(x).T


@dataclasses.dataclass(frozen=True)
class QuaternionManifold(_QuaternionBase):
    """[w, x, y, z] ordering (reference: manifold.h QuaternionManifold)."""

    _order = (0, 1, 2, 3)


@dataclasses.dataclass(frozen=True)
class EigenQuaternionManifold(_QuaternionBase):
    """[x, y, z, w] ordering (reference: manifold.h EigenQuaternionManifold)."""

    _order = (3, 0, 1, 2)


def _householder(x):
    """Householder vector (v, beta) with H = I - beta v v' zeroing the head of
    x (reference: householder_vector.h:48-82); branch-free JAX version."""
    n = x.shape[0]
    sigma = jnp.sum(x[:-1] * x[:-1])
    x_pivot = x[-1]
    mu = jnp.sqrt(x_pivot * x_pivot + sigma)
    v_pivot_neg = x_pivot - mu
    v_pivot_pos = -sigma / jnp.where(x_pivot + mu != 0, x_pivot + mu, 1.0)
    v_pivot = jnp.where(x_pivot <= 0, v_pivot_neg, v_pivot_pos)
    beta_main = 2.0 * v_pivot * v_pivot / (sigma + v_pivot * v_pivot)
    degenerate = sigma <= jnp.finfo(x.dtype).eps
    beta = jnp.where(degenerate, jnp.where(x_pivot < 0, 2.0, 0.0), beta_main)
    safe_v_pivot = jnp.where(degenerate, 1.0, v_pivot)
    v = jnp.concatenate(
        [jnp.where(degenerate, x[:-1], x[:-1] / safe_v_pivot), jnp.ones((1,), x.dtype)]
    )
    return v, beta


def _apply_householder(y, v, beta):
    return y - v * (beta * jnp.dot(v, y))


@dataclasses.dataclass(frozen=True)
class SphereManifold(Manifold):
    """Sphere of radius |x| in R^n; tangent dim n-1.

    reference: sphere_manifold.h + internal/sphere_manifold_functions.h.
    """

    size: int

    def __post_init__(self):
        if self.size < 2:
            raise ValueError("SphereManifold needs ambient size >= 2")

    @property
    def ambient_size(self) -> int:
        return self.size

    @property
    def tangent_size(self) -> int:
        return self.size - 1

    def plus(self, x, delta):
        v, beta = _householder(x)
        norm2 = jnp.sum(delta * delta)
        norm = jnp.sqrt(norm2)
        sinc = jnp.where(norm2 > 0, jnp.sin(norm) / jnp.where(norm2 > 0, norm, 1.0), 1.0)
        y = jnp.concatenate([sinc * delta, jnp.cos(norm)[None]])
        return jnp.linalg.norm(x) * _apply_householder(y, v, beta)

    def plus_jacobian(self, x):
        v, beta = _householder(x)
        h = jnp.eye(self.size, dtype=x.dtype) - beta * jnp.outer(v, v)
        return jnp.linalg.norm(x) * h[:, : self.tangent_size]

    def minus(self, y, x):
        v, beta = _householder(x)
        hy = _apply_householder(y, v, beta) / jnp.linalg.norm(x)
        head, last = hy[:-1], hy[-1]
        hn2 = jnp.sum(head * head)
        hn = jnp.sqrt(hn2)
        scale = jnp.where(
            hn2 > 0, jnp.arctan2(hn, last) / jnp.where(hn2 > 0, hn, 1.0), 0.0
        )
        deg = jnp.zeros((self.tangent_size,), x.dtype).at[-1].set(
            jnp.where(last >= 0, 0.0, jnp.pi)
        )
        return jnp.where(hn2 > 0, scale * head, deg)

    def minus_jacobian(self, x):
        v, beta = _householder(x)
        h = jnp.eye(self.size, dtype=x.dtype) - beta * jnp.outer(v, v)
        return h[: self.tangent_size, :] / jnp.linalg.norm(x)


@dataclasses.dataclass(frozen=True)
class LineManifold(Manifold):
    """Line in R^n parameterized as (origin, direction) in R^{2n}; tangent
    dim 2(n-1). reference: line_manifold.h.

    Plus moves the origin within the hyperplane orthogonal to the direction
    and rotates the direction on the sphere (same Householder construction as
    SphereManifold).
    """

    size: int  # dimension of the space the line lives in

    def __post_init__(self):
        if self.size < 2:
            raise ValueError("LineManifold needs space dimension >= 2")

    @property
    def ambient_size(self) -> int:
        return 2 * self.size

    @property
    def tangent_size(self) -> int:
        return 2 * (self.size - 1)

    def plus(self, x, delta):
        n = self.size
        origin, direction = x[:n], x[n:]
        do, dd = delta[: n - 1], delta[n - 1 :]
        v, beta = _householder(direction)
        # origin moves in the hyperplane spanned by the first n-1 Householder
        # basis vectors (line_manifold.h Plus).
        y_o = jnp.concatenate([do, jnp.zeros((1,), x.dtype)])
        origin_new = origin + _apply_householder(y_o, v, beta)
        norm2 = jnp.sum(dd * dd)
        norm = jnp.sqrt(norm2)
        sinc = jnp.where(norm2 > 0, jnp.sin(norm) / jnp.where(norm2 > 0, norm, 1.0), 1.0)
        y_d = jnp.concatenate([sinc * dd, jnp.cos(norm)[None]])
        direction_new = jnp.linalg.norm(direction) * _apply_householder(y_d, v, beta)
        return jnp.concatenate([origin_new, direction_new])

    def plus_jacobian(self, x):
        n = self.size
        direction = x[n:]
        v, beta = _householder(direction)
        h = jnp.eye(n, dtype=x.dtype) - beta * jnp.outer(v, v)
        jac = jnp.zeros((2 * n, self.tangent_size), dtype=x.dtype)
        jac = jac.at[:n, : n - 1].set(h[:, : n - 1])
        jac = jac.at[n:, n - 1 :].set(jnp.linalg.norm(direction) * h[:, : n - 1])
        return jac

    def minus(self, y, x):
        n = self.size
        xo, xd = x[:n], x[n:]
        yo, yd = y[:n], y[n:]
        v, beta = _householder(xd)
        ho = _apply_householder(yo - xo, v, beta)
        hd = _apply_householder(yd, v, beta) / jnp.linalg.norm(xd)
        head, last = hd[:-1], hd[-1]
        hn2 = jnp.sum(head * head)
        hn = jnp.sqrt(hn2)
        scale = jnp.where(
            hn2 > 0, jnp.arctan2(hn, last) / jnp.where(hn2 > 0, hn, 1.0), 0.0
        )
        return jnp.concatenate([ho[: n - 1], scale * head])

    def minus_jacobian(self, x):
        n = self.size
        xd = x[n:]
        v, beta = _householder(xd)
        h = jnp.eye(n, dtype=x.dtype) - beta * jnp.outer(v, v)
        jac = jnp.zeros((self.tangent_size, 2 * n), dtype=x.dtype)
        jac = jac.at[: n - 1, :n].set(h[: n - 1, :])
        jac = jac.at[n - 1 :, n:].set(h[: n - 1, :] / jnp.linalg.norm(xd))
        return jac


@dataclasses.dataclass(frozen=True, init=False)
class ProductManifold(Manifold):
    """Cartesian product of manifolds (reference: product_manifold.h)."""

    manifolds: tuple

    def __init__(self, *manifolds: Manifold):
        object.__setattr__(self, "manifolds", tuple(manifolds))
        if not manifolds:
            raise ValueError("ProductManifold needs at least one factor")

    @property
    def ambient_size(self) -> int:
        return sum(m.ambient_size for m in self.manifolds)

    @property
    def tangent_size(self) -> int:
        return sum(m.tangent_size for m in self.manifolds)

    def _split(self, x, sizes):
        out, off = [], 0
        for s in sizes:
            out.append(x[off : off + s])
            off += s
        return out

    def plus(self, x, delta):
        xs = self._split(x, [m.ambient_size for m in self.manifolds])
        ds = self._split(delta, [m.tangent_size for m in self.manifolds])
        return jnp.concatenate([m.plus(xi, di) for m, xi, di in zip(self.manifolds, xs, ds)])

    def plus_jacobian(self, x):
        xs = self._split(x, [m.ambient_size for m in self.manifolds])
        blocks = [m.plus_jacobian(xi) for m, xi in zip(self.manifolds, xs)]
        return jax.scipy.linalg.block_diag(*blocks)

    def minus(self, y, x):
        ys = self._split(y, [m.ambient_size for m in self.manifolds])
        xs = self._split(x, [m.ambient_size for m in self.manifolds])
        return jnp.concatenate([m.minus(yi, xi) for m, yi, xi in zip(self.manifolds, ys, xs)])

    def minus_jacobian(self, x):
        xs = self._split(x, [m.ambient_size for m in self.manifolds])
        blocks = [m.minus_jacobian(xi) for m, xi in zip(self.manifolds, xs)]
        return jax.scipy.linalg.block_diag(*blocks)


class AutoDiffManifold(Manifold):
    """Manifold defined by user plus/minus functors with autodiff Jacobians
    (reference: autodiff_manifold.h). The user functions must be JAX-traceable
    and differentiable at delta=0 / y=x.
    """

    def __init__(self, plus_fn, minus_fn, ambient_size: int, tangent_size: int):
        self._plus_fn = plus_fn
        self._minus_fn = minus_fn
        self._ambient = int(ambient_size)
        self._tangent = int(tangent_size)

    @property
    def ambient_size(self) -> int:
        return self._ambient

    @property
    def tangent_size(self) -> int:
        return self._tangent

    def plus(self, x, delta):
        return self._plus_fn(x, delta)

    def plus_jacobian(self, x):
        zero = jnp.zeros((self._tangent,), dtype=x.dtype)
        return jax.jacfwd(lambda d: self._plus_fn(x, d))(zero)

    def minus(self, y, x):
        return self._minus_fn(y, x)

    def minus_jacobian(self, x):
        return jax.jacfwd(lambda y: self._minus_fn(y, x))(x)

    def __hash__(self):
        return hash((id(self._plus_fn), id(self._minus_fn), self._ambient, self._tangent))

    def __eq__(self, other):
        return (
            isinstance(other, AutoDiffManifold)
            and self._plus_fn is other._plus_fn
            and self._minus_fn is other._minus_fn
            and self._ambient == other._ambient
            and self._tangent == other._tangent
        )


def check_manifold_invariants(manifold: Manifold, x, delta, tol: float = 1e-8):
    """Verify the manifold axioms at (x, delta).

    Parity: include/ceres/manifold_test_utils.h — the reference's
    EXPECT_THAT(manifold, XPlusZeroIsXAt(x)) etc. matcher suite, as one
    callable usable from tests and from user code validating a custom
    AutoDiffManifold. Checks (names per the reference matchers):

      - XPlusZeroIsX:          Plus(x, 0) == x
      - XMinusXIsZero:         Minus(x, x) == 0
      - MinusPlusIsIdentity:   Minus(Plus(x, delta), x) == delta
      - PlusMinusIsIdentity:   Plus(x, Minus(y, x)) == y for y = Plus(x, delta)
      - HasCorrectPlusJacobian:  plus_jacobian == autodiff d Plus/d delta at 0
      - HasCorrectMinusJacobian: minus_jacobian == autodiff d Minus/d y at x

    Raises AssertionError naming the failed axiom. `delta` should be small
    enough to stay inside the injectivity radius (the reference uses
    norm <= 0.5).

    Tolerances and the finite-difference step scale with the active
    precision: under jax_enable_x64 the checks run in float64 with the
    given `tol` (default 1e-8, the reference's kTolerance); without x64
    the jnp.float64 cast silently degrades to float32, where h=1e-6
    central differences are pure cancellation noise — so h and the
    Jacobian tolerance are derived from the actual dtype's eps instead of
    hardcoded f64 constants.
    """
    x = jnp.asarray(x, dtype=jnp.float64)
    delta = jnp.asarray(delta, dtype=jnp.float64)
    eps = float(jnp.finfo(x.dtype).eps)
    if x.dtype != jnp.float64:  # x64 disabled: f32 tolerances
        tol = max(tol, 200.0 * eps)
    zero = jnp.zeros(manifold.tangent_size, dtype=x.dtype)

    def _close(a, b, name):
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        if not np.all(np.isfinite(a)) or err > tol:
            raise AssertionError(
                f"manifold axiom {name} failed: max abs error {err:.3e} > {tol:.1e}"
            )

    _close(manifold.plus(x, zero), x, "XPlusZeroIsX")
    _close(manifold.minus(x, x), zero, "XMinusXIsZero")
    y = manifold.plus(x, delta)
    _close(manifold.minus(y, x), delta, "MinusPlusIsIdentity")
    _close(manifold.plus(x, manifold.minus(y, x)), y, "PlusMinusIsIdentity")

    # Jacobian axioms are checked by central differences, not jax.jacfwd:
    # Plus/Minus are written branch-free with jnp.where selects whose
    # autodiff at the singular point (delta = 0 / y = x) is undefined —
    # the values are exact there but jacfwd through the dead branch is
    # not (the reference's matchers likewise difference numerically).
    # h ~ eps^(1/3) balances truncation vs roundoff for central
    # differences (1e-5.3 in f64, 1e-2.4 in f32).
    h = float(eps ** (1.0 / 3.0))

    def _fd_jac(f, z0, out_size):
        cols = []
        for i in range(z0.shape[0]):
            e = jnp.zeros_like(z0).at[i].set(h)
            cols.append((f(z0 + e) - f(z0 - e)) / (2.0 * h))
        return jnp.stack(cols, axis=1)

    # FD Jacobian error floor: h^2 truncation + eps/h roundoff
    _close_tol = max(tol, 1e-7, 10.0 * (h * h + eps / h))
    a = manifold.plus_jacobian(x)
    b = _fd_jac(lambda d: manifold.plus(x, d), zero, manifold.ambient_size)
    if float(jnp.max(jnp.abs(a - b))) > _close_tol:
        raise AssertionError(
            "manifold axiom HasCorrectPlusJacobian failed: max abs error "
            f"{float(jnp.max(jnp.abs(a - b))):.3e} > {_close_tol:.1e}"
        )
    a = manifold.minus_jacobian(x)
    b = _fd_jac(lambda yy: manifold.minus(yy, x), x, manifold.tangent_size)
    if float(jnp.max(jnp.abs(a - b))) > _close_tol:
        raise AssertionError(
            "manifold axiom HasCorrectMinusJacobian failed: max abs error "
            f"{float(jnp.max(jnp.abs(a - b))):.3e} > {_close_tol:.1e}"
        )
