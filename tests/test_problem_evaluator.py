"""Differential tests of the Problem/Program/Evaluator stack.

Strategy mirrors the reference's CPU-vs-GPU differential tests
(evaluator_cuda_test.cu.cc): the batched, signature-grouped device evaluation
is compared against slow, trusted per-block NumPy math and finite
differences — covering autodiff, manifold chain rule, robust-loss
correction, constant blocks, and gradient scatter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceres_tpu import (
    CauchyLoss,
    CostFunction,
    HuberLoss,
    Problem,
    QuaternionManifold,
    SubsetManifold,
)

RNG = np.random.default_rng(11)


def lin2(params, data):
    (x,) = params
    (a,) = data
    return jnp.stack([x[0] * a[0] + x[1], x[0] - x[1] * a[1]])


def quad3(params, data):
    x, y = params
    return jnp.stack(
        [
            jnp.sum(x * x) - y[0],
            x[0] * y[1] + x[2],
            jnp.sin(y[2]) + x[1],
        ]
    )


def rot_residual(params, data):
    (q,) = params
    (v,) = data
    # rotate v by quaternion q = [w,x,y,z] and compare to fixed target
    w, x, y, z = q[0], q[1], q[2], q[3]
    r = jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    return r @ v - jnp.asarray([0.3, -0.2, 0.9])


def build_mixed_problem():
    p = Problem()
    b1 = p.add_parameter_block(RNG.standard_normal(2))
    b2 = p.add_parameter_block(RNG.standard_normal(3))
    b3 = p.add_parameter_block(RNG.standard_normal(3))
    q = RNG.standard_normal(4)
    q /= np.linalg.norm(q)
    b4 = p.add_parameter_block(q, manifold=QuaternionManifold())

    cf_lin = CostFunction(lin2, 2)
    cf_quad = CostFunction(quad3, 3)
    cf_rot = CostFunction(rot_residual, 3)

    p.add_residual_block(cf_lin, None, [b1], data=(np.array([1.5, -0.5]),))
    p.add_residual_block(cf_lin, HuberLoss(0.8), [b1], data=(np.array([0.2, 2.0]),))
    p.add_residual_block(cf_quad, CauchyLoss(1.2), [b2, b3])
    p.add_residual_block(cf_rot, None, [b4], data=(np.array([0.1, 0.7, -0.3]),))
    return p, (b1, b2, b3, b4)


def test_signature_grouping():
    p, _ = build_mixed_problem()
    program = p.compile()
    # lin2 appears twice: once with no loss and once with Huber -> 2 groups;
    # quad3 and rot each 1 group.
    assert len(program.groups) == 4
    cf = CostFunction(lin2, 2)
    b = p.add_parameter_block([1.0, 2.0])
    h1 = p.add_residual_blocks(cf, None, np.array([[b], [b]]), (RNG.standard_normal((2, 2)),))
    program = p.compile()
    # the two new blocks join the existing no-loss lin2 group
    assert len(program.groups) == 4
    sizes = sorted(g.n for g in program.groups)
    assert sizes == [1, 1, 1, 3]


def test_cost_matches_numpy():
    p, (b1, b2, b3, b4) = build_mixed_problem()
    cost, res, grad, crs = p.evaluate()

    # independent numpy recomputation
    def block_cost(fn, loss, params, data):
        r = np.asarray(fn(tuple(map(jnp.asarray, params)), tuple(map(jnp.asarray, data))))
        s = float(r @ r)
        if loss is None:
            return 0.5 * s, r
        rho0 = float(np.asarray(loss.rho(jnp.asarray([s]))[0])[0])
        return 0.5 * rho0, r

    x1 = p.parameter_block_value(b1)
    x2 = p.parameter_block_value(b2)
    x3 = p.parameter_block_value(b3)
    x4 = p.parameter_block_value(b4)
    c1, _ = block_cost(lin2, None, [x1], [np.array([1.5, -0.5])])
    c2, _ = block_cost(lin2, HuberLoss(0.8), [x1], [np.array([0.2, 2.0])])
    c3, _ = block_cost(quad3, CauchyLoss(1.2), [x2, x3], [])
    c4, _ = block_cost(rot_residual, None, [x4], [np.array([0.1, 0.7, -0.3])])
    np.testing.assert_allclose(cost, c1 + c2 + c3 + c4, rtol=1e-12)
    assert res.shape == (10,)


def test_gradient_matches_finite_difference_of_cost():
    p, _ = build_mixed_problem()
    program = p.compile()
    ev = program.evaluator()
    state = program.state_vector()
    cost, _, jac, grad = ev.evaluate_groups(state)
    grad = np.asarray(grad)

    eps = 1e-7
    num_eff = program.num_effective_parameters
    fd = np.zeros(num_eff)
    for i in range(num_eff):
        d = jnp.zeros(num_eff).at[i].set(eps)
        cp = float(ev.cost(ev.plus(state, d)))
        cm = float(ev.cost(ev.plus(state, -d)))
        fd[i] = (cp - cm) / (2 * eps)
    np.testing.assert_allclose(grad, fd, rtol=1e-5, atol=1e-7)


def test_jacobian_matches_fd_trivial_loss():
    # trivial-loss problem: corrected == raw residuals, so J == d res/d delta
    p = Problem()
    b1 = p.add_parameter_block(RNG.standard_normal(2))
    b2 = p.add_parameter_block(RNG.standard_normal(3))
    b3 = p.add_parameter_block(RNG.standard_normal(3))
    cf = CostFunction(quad3, 3)
    p.add_residual_block(cf, None, [b2, b3])
    p.add_residual_block(CostFunction(lin2, 2), None, [b1], data=(np.array([1.0, 2.0]),))
    program = p.compile()
    ev = program.evaluator()
    state = program.state_vector()
    _, res0, jac, _ = ev.evaluate(state)
    dense = np.asarray(jac.to_dense())
    num_eff = program.num_effective_parameters
    eps = 1e-7
    for i in range(num_eff):
        d = jnp.zeros(num_eff).at[i].set(eps)
        _, rp = ev.residuals(ev.plus(state, d))
        _, rm = ev.residuals(ev.plus(state, -d))
        fd = (np.asarray(rp) - np.asarray(rm)) / (2 * eps)
        np.testing.assert_allclose(dense[:, i], fd, rtol=1e-5, atol=1e-7)


def test_crs_matches_dense():
    p, _ = build_mixed_problem()
    program = p.compile()
    ev = program.evaluator()
    _, _, jac, _ = ev.evaluate(program.state_vector())
    dense = np.asarray(jac.to_dense())
    vals, cols, row_ptr = jac.to_crs()
    rebuilt = np.zeros_like(dense)
    for r in range(len(row_ptr) - 1):
        for k in range(row_ptr[r], row_ptr[r + 1]):
            rebuilt[r, cols[k]] += vals[k]
    np.testing.assert_allclose(rebuilt, dense, atol=1e-14)


def test_constant_block_zero_jacobian_and_gradient():
    p = Problem()
    b2 = p.add_parameter_block(RNG.standard_normal(3))
    b3 = p.add_parameter_block(RNG.standard_normal(3))
    p.add_residual_block(CostFunction(quad3, 3), None, [b2, b3])
    p.set_parameter_block_constant(b2)
    program = p.compile()
    assert program.num_effective_parameters == 3
    ev = program.evaluator()
    _, _, jac, grad = ev.evaluate(program.state_vector())
    assert np.asarray(grad).shape == (3,)
    dense = np.asarray(jac.to_dense())
    assert dense.shape == (3, 3)


def test_subset_manifold_in_problem():
    p = Problem()
    b = p.add_parameter_block([1.0, 2.0, 3.0], manifold=SubsetManifold(3, (1,)))

    def f(params, data):
        (x,) = params
        return jnp.stack([x[0] * x[1], x[2] - x[0]])

    p.add_residual_block(CostFunction(f, 2), None, [b])
    program = p.compile()
    assert program.num_effective_parameters == 2
    ev = program.evaluator()
    state = program.state_vector()
    _, _, jac, grad = ev.evaluate(state)
    dense = np.asarray(jac.to_dense())
    # columns correspond to free coords x0, x2
    np.testing.assert_allclose(dense, [[2.0, 0.0], [-1.0, 1.0]], atol=1e-12)


def test_remove_residual_block():
    p = Problem()
    b = p.add_parameter_block([1.0, 2.0])
    cf = CostFunction(lin2, 2)
    h1 = p.add_residual_block(cf, None, [b], data=(np.array([1.0, 1.0]),))
    h2 = p.add_residual_block(cf, None, [b], data=(np.array([2.0, 2.0]),))
    assert p.num_residual_blocks() == 2
    p.remove_residual_block(h1)
    assert p.num_residual_blocks() == 1
    program = p.compile()
    assert program.num_residuals == 2


def test_bounds_clamp_in_plus():
    p = Problem()
    b = p.add_parameter_block([0.5, 0.5])
    p.set_parameter_upper_bound(b, 0, 1.0)
    p.set_parameter_lower_bound(b, 1, 0.0)
    p.add_residual_block(
        CostFunction(lin2, 2), None, [b], data=(np.array([1.0, 1.0]),)
    )
    program = p.compile()
    ev = program.evaluator()
    state = program.state_vector()
    out = np.asarray(ev.plus(state, jnp.asarray([10.0, -10.0])))
    np.testing.assert_allclose(out, [1.0, 0.0])


def test_evaluate_without_loss():
    p = Problem()
    b = p.add_parameter_block(RNG.standard_normal(2))
    p.add_residual_block(
        CostFunction(lin2, 2), CauchyLoss(0.1), [b], data=(np.array([1.0, 1.0]),)
    )
    program = p.compile()
    ev = program.evaluator()
    state = program.state_vector()
    cost_with, res_with, _, _ = ev.evaluate(state, apply_loss=True)
    cost_without, res_without, _, _ = ev.evaluate(state, apply_loss=False)
    raw = np.asarray(res_without)
    np.testing.assert_allclose(float(cost_without), 0.5 * raw @ raw, rtol=1e-12)
    assert float(cost_with) < float(cost_without)  # Cauchy shrinks large residuals
