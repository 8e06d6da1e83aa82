"""The XLA evaluation path against an independent NumPy f64 functor.

Residuals, robust-loss corrections and the gradient are recomputed in NumPy
(chip_smoke.py's Snavely reference and a Triggs corrector written here);
Jacobians are checked against f64 central differences of that functor, in
tangent space where a manifold is set. The reference's CPU-vs-CUDA
evaluator tests (evaluator_cuda_test.cu.cc) play the same role.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ceres_tpu import jacobian  # noqa: E402
from ceres_tpu.evaluator import _group_eval, evaluate, state_tables  # noqa: E402
from ceres_tpu.io.bal import build_ba_problem, synthetic_bal  # noqa: E402
from ceres_tpu.loss import CauchyLoss, HuberLoss  # noqa: E402

N_CAMS, N_PTS, N_OBS = 6, 40, 150


def _bal(seed=3):
    return synthetic_bal(
        N_CAMS, N_PTS, N_OBS, seed=seed, observation_noise=2.0,
        perturb_points=0.5, perturb_rotation=0.02,
    )


def _huber_np(s, a):
    r = np.sqrt(np.maximum(s, a * a))
    out = s > a * a
    return (
        np.where(out, 2 * a * r - a * a, s),
        np.where(out, a / r, 1.0),
        np.where(out, -(a / r) / (2 * np.maximum(s, a * a)), 0.0),
    )


def _cauchy_np(s, a):
    b = a * a
    t = 1.0 + s / b
    return b * np.log(t), 1.0 / t, -(1.0 / b) / (t * t)


def _loss_np(loss, s):
    if loss is None:
        return s, np.ones_like(s), np.zeros_like(s)
    if isinstance(loss, HuberLoss):
        return _huber_np(s, loss.a)
    return _cauchy_np(s, loss.a)


def _correct_np(res, jac, rho1, rho2):
    """Triggs correction (corrector.h) of res [n, 2] and jac [n, 2, k]."""
    s = np.sum(res * res, axis=1)
    inlier = (s > 0) & (rho2 > 0)
    alpha = np.where(
        inlier, 1 - np.sqrt(np.maximum(1 + 2 * s * rho2 / rho1, 0)), 0.0
    )
    sr = np.sqrt(rho1)
    res_c = np.where(inlier, sr / (1 - alpha), sr)[:, None] * res
    a_s = np.where(inlier, alpha / np.where(inlier, s, 1.0), 0.0)
    rtj = np.einsum("nr,nrk->nk", res, jac)
    jac_c = sr[:, None, None] * (
        jac - a_s[:, None, None] * res[:, :, None] * rtj[:, None, :]
    )
    return res_c, jac_c


def _quat_rotate_np(q, p):
    t = 2.0 * np.cross(q[:, 1:], p)
    return p + q[:, :1] * t + np.cross(q[:, 1:], t)


def _quat_residuals_np(cams, pts, obs):
    """Snavely reprojection with a [q(4) | t(3) | f k1 k2] camera."""
    p = _quat_rotate_np(cams[:, :4], pts) + cams[:, 4:7]
    xp, yp = -p[:, 0] / p[:, 2], -p[:, 1] / p[:, 2]
    r2 = xp * xp + yp * yp
    sc = cams[:, 7] * (1.0 + r2 * (cams[:, 8] + cams[:, 9] * r2))
    return np.stack([sc * xp - obs[:, 0], sc * yp - obs[:, 1]], axis=1)


def _quat_plus_np(q, d):
    """exp(d) ⊗ q, [w, x, y, z] order (QuaternionManifold)."""
    n = np.linalg.norm(d, axis=1, keepdims=True)
    sinc = np.where(n > 0, np.sin(n) / np.where(n > 0, n, 1.0), 1.0)
    e = np.concatenate([np.cos(n), sinc * d], axis=1)
    w1, v1 = e[:, :1], e[:, 1:]
    w2, v2 = q[:, :1], q[:, 1:]
    return np.concatenate(
        [w1 * w2 - np.sum(v1 * v2, 1, keepdims=True),
         w1 * v2 + w2 * v1 + np.cross(v1, v2)], axis=1,
    )


def _fd(fun, x, plus=None, tangent=None):
    """Central-difference Jacobian [n, 2, tangent] of fun(x [n, k])."""
    tangent = tangent or x.shape[1]
    plus = plus or (lambda x, d: x + d)
    jac = np.empty((x.shape[0], 2, tangent))
    for k in range(tangent):
        h = 1e-6
        d = np.zeros((x.shape[0], tangent))
        d[:, k] = h
        jac[:, :, k] = (fun(plus(x, d)) - fun(plus(x, -d))) / (2 * h)
    return jac


class _Case:
    """A single-group BA problem and its NumPy f64 evaluation, laid out in
    the program's lane / tangent order."""

    def __init__(self, bal, loss=None, quaternions=False, manifolds=False):
        self.problem, cam_ids, pt_ids = build_ba_problem(
            bal, loss=loss, use_quaternions=quaternions,
            use_manifolds=manifolds,
        )
        self.program = p = self.problem.compile()
        n = bal.observations.shape[0]
        self.lanes = np.array([p.handle_entry(0, i)[1] for i in range(n)])
        cams = np.asarray(
            [self.problem.parameter_block_value(h) for h in cam_ids]
        )[bal.camera_index]
        pts = bal.points[bal.point_index]
        obs = bal.observations
        cs = cams.shape[1]
        if quaternions:
            fun = lambda x: _quat_residuals_np(x[:, :cs], x[:, cs:], obs)  # noqa: E731
        else:
            fun = lambda x: chip_smoke.snavely_residuals_np(  # noqa: E731
                x[:, :cs], x[:, cs:], obs
            )
        x = np.concatenate([cams, pts], axis=1)
        if manifolds:
            def plus(x, d):
                return np.concatenate(
                    [_quat_plus_np(x[:, :4], d[:, :3]), x[:, 4:] + d[:, 3:]],
                    axis=1,
                )

            jac = _fd(fun, x, plus, tangent=cs - 1 + 3)
        else:
            jac = _fd(fun, x)
        res = fun(x)
        self.rho0, rho1, rho2 = _loss_np(loss, np.sum(res * res, axis=1))
        self.cost = 0.5 * float(np.sum(self.rho0))
        self.res, self.jac = _correct_np(res, jac, rho1, rho2)
        tc = jac.shape[2] - 3
        self.cam_cols = p.t_offsets[cam_ids][bal.camera_index, None] + np.arange(tc)
        self.pt_cols = p.t_offsets[pt_ids][bal.point_index, None] + np.arange(3)
        self.grad = np.zeros(p.num_effective_parameters)
        contrib = np.einsum("nr,nrk->nk", self.res, self.jac)
        np.add.at(self.grad, self.cam_cols, contrib[:, :tc])
        np.add.at(self.grad, self.pt_cols, contrib[:, tc:])

    def dense_jacobian(self):
        """[2n, num_effective] in program row and column order."""
        p = self.program
        out = np.zeros((p.num_residuals, p.num_effective_parameters))
        tc = self.cam_cols.shape[1]
        for i, lane in enumerate(self.lanes):
            rows = 2 * lane + np.arange(2)
            out[np.ix_(rows, self.cam_cols[i])] = self.jac[i, :, :tc]
            out[np.ix_(rows, self.pt_cols[i])] = self.jac[i, :, tc:]
        return out

    def program_vector(self, res):
        """Observation-order [n, 2] -> flat residual vector in program
        row order."""
        out = np.zeros(2 * len(self.lanes))
        out[2 * self.lanes] = res[:, 0]
        out[2 * self.lanes + 1] = res[:, 1]
        return out

    def evaluate(self, with_jacobian=True):
        arrays = self.program.arrays(jnp.float64)
        state = self.program.state_vector(jnp.float64)
        return jax.jit(
            lambda a, s: evaluate(self.program, a, s, with_jacobian)
        )(arrays, state)

    def lane_residuals(self, res_groups):
        """Device residuals [2, n] in observation order."""
        return np.asarray(res_groups[0])[:, self.lanes].T


def _check(case, out, jac_rtol=1e-6):
    cost, res, jac, grad = out
    assert abs(float(cost) - case.cost) <= 1e-12 * case.cost
    np.testing.assert_allclose(
        case.lane_residuals(res), case.res, rtol=1e-10, atol=1e-9
    )
    if jac is not None:
        dense = np.asarray(jac.to_dense())
        ref = case.dense_jacobian()
        assert np.abs(dense - ref).max() <= jac_rtol * np.abs(ref).max()
        np.testing.assert_allclose(
            np.asarray(grad), case.grad, rtol=1e-5,
            atol=1e-6 * np.abs(case.grad).max(),
        )


def test_snavely_matches_numpy_reference():
    case = _Case(_bal())
    _check(case, case.evaluate())


@pytest.mark.parametrize("loss", [HuberLoss(1.0), CauchyLoss(0.5)])
def test_robust_loss_matches_numpy_triggs_correction(loss):
    case = _Case(_bal(seed=4), loss=loss)
    _check(case, case.evaluate())


def test_gradient_is_corrected_jt_r():
    case = _Case(_bal(seed=5), loss=HuberLoss(1.0))
    _, _, _, grad = case.evaluate()
    ref = case.dense_jacobian().T @ case.program_vector(case.res)
    np.testing.assert_allclose(np.asarray(grad), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(ref, case.grad, rtol=1e-9,
                               atol=1e-12 * np.abs(ref).max())


def test_masked_lanes_are_zeroed():
    """Sharding pads groups with masked lanes: they contribute nothing."""
    case = _Case(_bal(seed=6), loss=HuberLoss(1.0))
    p = case.program
    arrays = p.arrays(jnp.float64)
    state = p.state_vector(jnp.float64)
    garr = dict(arrays["groups"][0])
    mask = np.ones(N_OBS)
    mask[-5:] = 0.0
    garr["mask"] = jnp.asarray(mask)

    def run(g):
        return _group_eval(p.groups[0], g, state_tables(p, state), True,
                           True, None)

    cost, res, jacs = jax.jit(run)(garr)
    res = np.asarray(res)
    np.testing.assert_array_equal(res[:, -5:], 0.0)
    for j in jacs:
        np.testing.assert_array_equal(np.asarray(j)[:, -5:], 0.0)
    keep = case.lanes < N_OBS - 5
    np.testing.assert_allclose(res[:, case.lanes[keep]].T, case.res[keep],
                               rtol=1e-10, atol=1e-9)
    ref_cost = 0.5 * float(np.sum(case.rho0[keep]))
    assert abs(float(cost) - ref_cost) <= 1e-12 * ref_cost


def test_quaternion_manifold_jacobian_in_tangent_space():
    """Product-manifold (Quaternion x Euclidean(6)) cameras: the Jacobian
    is the ambient Jacobian times the plus-Jacobian, checked against
    central differences taken through the manifold's plus."""
    case = _Case(_bal(seed=7), loss=HuberLoss(1.0), quaternions=True,
                 manifolds=True)
    _check(case, case.evaluate())


def test_quaternion_manifold_jacobian_is_tangent_sized():
    case = _Case(_bal(seed=8), quaternions=True, manifolds=True)
    _, _, jac, _ = case.evaluate()
    cam_leaf, pt_leaf = jac.jac_groups[0]
    assert cam_leaf.shape == (2 * 9, N_OBS)
    assert pt_leaf.shape == (2 * 3, N_OBS)


def test_quaternion_camera_without_manifold_is_ambient():
    case = _Case(_bal(seed=9), loss=CauchyLoss(0.5), quaternions=True)
    out = case.evaluate()
    assert out[2].jac_groups[0][0].shape == (2 * 10, N_OBS)
    _check(case, out)


@pytest.mark.parametrize("loss", [None, HuberLoss(1.0)])
def test_residual_only_matches_numpy(loss):
    case = _Case(_bal(seed=10), loss=loss)
    cost, res, jac, grad = case.evaluate(with_jacobian=False)
    assert jac is None and grad is None
    _check(case, (cost, res, None, None))


def test_lane_chunked_matches_unchunked(monkeypatch):
    case = _Case(_bal(seed=11), loss=HuberLoss(1.0))
    whole = case.evaluate()
    monkeypatch.setattr(jacobian, "LANE_CHUNK", 64)
    monkeypatch.setattr(jacobian, "LANE_CHUNK_LARGE", 48)
    assert len(jacobian.lane_chunks(N_OBS)) == 4
    chunked = case.evaluate()
    assert abs(float(chunked[0]) - float(whole[0])) <= 1e-12 * float(whole[0])
    np.testing.assert_allclose(chunked[1][0], whole[1][0], rtol=1e-12)
    for a, b in zip(chunked[2].jac_groups[0], whole[2].jac_groups[0]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(chunked[3], whole[3], rtol=1e-10,
                               atol=1e-12 * np.abs(whole[3]).max())
    _check(case, chunked)


def test_bf16_mixed_copy_products():
    """The mixed-precision Jacobian copy: bf16 leaves, f32 accumulation,
    products within bf16 rounding of the f64 dense reference."""
    case = _Case(_bal(seed=12), loss=HuberLoss(1.0))
    _, _, jac, _ = case.evaluate()
    jac_f32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, jac
    )
    j16 = jac_f32.astype(jnp.bfloat16)
    assert all(leaf.dtype == jnp.bfloat16 for leaf in j16.jac_groups[0])
    dense = case.dense_jacobian()
    v = np.random.default_rng(0).normal(size=dense.shape[1])
    jv = jax.jit(lambda j, x: j.right_multiply(x))(
        j16, jnp.asarray(v, jnp.float32)
    )[0]
    assert jv.dtype == jnp.float32
    jv = np.asarray(jv, np.float64).T.reshape(-1)
    ref = dense @ v
    assert np.linalg.norm(jv - ref) <= 2e-2 * np.linalg.norm(ref)
    u = [jnp.ones((2, N_OBS), jnp.float32)]
    jtu = np.asarray(jax.jit(lambda j, x: j.left_multiply(x))(j16, u))
    ref = dense.T @ np.ones(dense.shape[0])
    assert np.linalg.norm(jtu - ref) <= 2e-2 * np.linalg.norm(ref)
