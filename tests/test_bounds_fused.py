"""Bounded problems on the fused device loop.

The reference clamps bounds in PlusWithBoundsClamping and runs a projected
line search when constrained (trust_region_minimizer.cc:101-106,462-502);
here all of that is in-graph so bounded problems keep the fused execution
path. These tests check (a) fused eligibility with bounds, (b) solution
parity between the fused and host loops on the Moré-Garbow-Hillstrom
bounds variants, and (c) constraint satisfaction.
"""

import numpy as np
import pytest

import ceres_tpu
from ceres_tpu import SolverOptions, TerminationType
from ceres_tpu.examples.more_garbow_hillstrom import PROBLEMS

BOUNDED = [p for p in PROBLEMS if p.lower_bounds is not None][:8]


def _solve(spec, fused: bool):
    p, b = spec.build(constrained=True)
    options = SolverOptions(
        max_num_iterations=200,
        fused_execution=fused,
        function_tolerance=1e-12,
        gradient_tolerance=1e-12,
        parameter_tolerance=1e-12,
    )
    summary = ceres_tpu.solve(options, p)
    return np.asarray(p.parameter_block_value(b)), summary


@pytest.mark.parametrize("spec", BOUNDED, ids=lambda s: s.name)
def test_bounded_mgh_fused_matches_host(spec):
    x_fused, s_fused = _solve(spec, fused=True)
    x_host, s_host = _solve(spec, fused=False)

    assert s_fused.used_fused_execution, "bounded problem fell off the fused path"
    assert not s_host.used_fused_execution

    # constraints hold on both paths
    for x in (x_fused, x_host):
        assert np.all(x >= spec.lower_bounds - 1e-10)
        assert np.all(x <= spec.upper_bounds + 1e-10)

    # identical solutions (same constrained minimum)
    scale = max(1.0, abs(s_host.final_cost))
    assert abs(s_fused.final_cost - s_host.final_cost) <= 1e-6 * scale, (
        spec.name,
        s_fused.final_cost,
        s_host.final_cost,
    )
    if spec.constrained_f_min is not None:
        assert s_fused.final_cost == pytest.approx(
            spec.constrained_f_min, rel=1e-4, abs=1e-10
        )


def test_bounded_fused_line_search_counts():
    # the projected Armijo inside the chunk reports its cost evaluations
    spec = BOUNDED[0]
    p, b = spec.build(constrained=True)
    summary = ceres_tpu.solve(SolverOptions(max_num_iterations=100), p)
    assert summary.used_fused_execution
    assert summary.num_residual_evaluations >= len(summary.iterations) - 1
