"""Conformance sweep over the 10 bundled reference problems.

Mirrors the reference test strategy (reference unit_tests.py): deterministic
seed, random x0, solve, and assert solution-space distance to the nearest
known ground truth ≤ Stol = 1e-3 (unit_tests.py:51, 405-409), in both exact
Hessian and L-BFGS(4) modes (unit_tests.py:49).  Where the reference sweep
activates only problems {1,4,5,10} for speed (unit_tests.py:106-237), we run
all 10.
"""

import numpy as np
import pytest

from pyipm_jax import IPMConfig, solve
from pyipm_jax.models import REFERENCE_PROBLEMS

STOL = 1.0e-3   # reference unit_tests.py:51


def _run(num, cfg):
    spec = REFERENCE_PROBLEMS[num]
    prob = spec.make()
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)
    res = solve(prob, x0, cfg)
    return spec, res


@pytest.mark.parametrize("num", sorted(REFERENCE_PROBLEMS))
def test_exact_hessian(num):
    cfg = IPMConfig(Ftol=1.0e-8, verbosity=0)
    spec, res = _run(num, cfg)
    assert int(res.signal) in (1, 2), f"signal={int(res.signal)}"
    assert spec.distance_to_truth(res.x) <= STOL


@pytest.mark.parametrize("num", sorted(REFERENCE_PROBLEMS))
def test_lbfgs(num):
    cfg = IPMConfig(Ftol=1.0e-8, verbosity=0, lbfgs=4)
    spec, res = _run(num, cfg)
    assert int(res.signal) in (1, 2), f"signal={int(res.signal)}"
    assert spec.distance_to_truth(res.x) <= STOL


@pytest.mark.parametrize("num", [3, 7, 8, 10])
def test_lu_parity_mode(num):
    """The 'lu' linear solver reproduces the reference's
    eigendecomposition-based inertia flow; it must converge too."""
    cfg = IPMConfig(Ftol=1.0e-8, verbosity=0, linear_solver="lu")
    spec, res = _run(num, cfg)
    assert int(res.signal) in (1, 2)
    assert spec.distance_to_truth(res.x) <= STOL


@pytest.mark.parametrize("num", [1, 4, 5, 10])
def test_kkt_residual_at_solution(num):
    """Property check absent in the reference: the returned KKT norms must
    actually certify the first-order conditions at the returned point."""
    cfg = IPMConfig(Ftol=1.0e-8, verbosity=0)
    spec, res = _run(num, cfg)
    kkt = np.asarray(res.kkt)
    if int(res.signal) == 1:
        assert np.all(kkt <= cfg.Ktol * (1 + 1e-12))


def test_warm_start_s0_lda0():
    """solve() accepts user s0/lda0 warm starts (reference pyipm.py:1567-1578,
    the de-facto resume mechanism)."""
    spec = REFERENCE_PROBLEMS[7]
    prob = spec.make()
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)
    cfg = IPMConfig(Ftol=1.0e-8, verbosity=0)
    res = solve(prob, x0, cfg)
    # restart from the solution: should converge immediately
    res2 = solve(prob, np.asarray(res.x), cfg,
                 s0=np.asarray(res.s), lda0=np.asarray(res.lda))
    assert int(res2.signal) in (1, 2)
    assert int(res2.iter_count) <= int(res.iter_count)
    assert spec.distance_to_truth(res2.x) <= STOL
