"""Shared mini-BA fixture for the on-card differential tier.

Mirrors the composition of the reference's CUDA differential test problem
(reference: internal/ceres/evaluator_cuda_test.cu.cc:426-456): one
problem combining a quaternion-manifold camera block, a constant block,
robust losses (Huber + Cauchy), and three distinct functor types — then the
SAME problem is evaluated on the card in f32 and on the CPU in f64 and the
outputs must agree at scale-aware tolerances.

Importable from both the card test process and the CPU-f64 reference
subprocess so the two sides build bit-identical programs.
"""

import numpy as np

# Small enough that the dense Jacobian is materializable for comparison and
# the CPU-f64 reference evaluates in seconds; large enough that the bucket
# and one-hot reduction plans (not just fallbacks) engage.
CAMS, PTS, OBS, SEED = 24, 600, 4000, 11
N_TETHERS = 128
PRIOR_W = 0.1
TETHER_W = 0.5


def build_mini_ba():
    from ceres_tpu.autodiff import CostFunction
    from ceres_tpu.io.bal import build_ba_problem, synthetic_bal
    from ceres_tpu.loss import CauchyLoss, HuberLoss

    bal = synthetic_bal(
        CAMS, PTS, OBS, seed=SEED,
        observation_noise=1.5, perturb_points=0.2, perturb_rotation=0.01,
    )
    # functor 1: quaternion Snavely reprojection + Huber, camera block on a
    # Quaternion x Euclidean(6) product manifold
    problem, cam_ids, pt_ids = build_ba_problem(
        bal, loss=HuberLoss(1.0), use_quaternions=True, use_manifolds=True
    )
    # constant block: gauge-fix the first camera
    problem.set_parameter_block_constant(cam_ids[0])

    # functor 2: Cauchy-robust translation prior, one per camera (exercises
    # a second signature group over the SAME manifold blocks)
    rng = np.random.default_rng(SEED + 1)
    t_ref = bal.cameras[:, 3:6] + rng.normal(0.0, 0.05, (CAMS, 3))

    def t_prior(params, data):
        return PRIOR_W * (params[0][4:7] - data[0])

    cf_prior = CostFunction(t_prior, 3, name="t_prior")
    prior_ids = cam_ids.reshape(-1, 1)
    problem.add_residual_blocks(
        cf_prior, CauchyLoss(0.5), prior_ids, (t_ref,)
    )

    # functor 3: point-pair tethers, two parameter blocks, no loss
    pairs = rng.choice(PTS, size=(N_TETHERS, 2), replace=True)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    d_ref = (
        bal.points[pairs[:, 0]] - bal.points[pairs[:, 1]]
        + rng.normal(0.0, 0.02, (len(pairs), 3))
    )

    def tether(params, data):
        return TETHER_W * ((params[0] - params[1]) - data[0])

    cf_tether = CostFunction(tether, 3, name="pt_tether")
    tether_ids = np.stack(
        [pt_ids[pairs[:, 0]], pt_ids[pairs[:, 1]]], axis=1
    )
    problem.add_residual_blocks(cf_tether, None, tether_ids, (d_ref,))
    return problem
