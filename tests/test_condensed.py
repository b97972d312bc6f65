"""Condensed KKT direction: must produce the IDENTICAL Newton step as the
full (D+2N+M)^2 factorization (ops/condensed.py is exact block
elimination, not an approximation)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax import IPMConfig, make_problem, solve
from pyipm_jax.core import kkt as K
from pyipm_jax.models import REFERENCE_PROBLEMS
from pyipm_jax.ops.condensed import condensed_direction
from pyipm_jax.ops.linalg import reg_solve_kkt


def _direction_full(problem, cfg, x, s, lda, mu, delta):
    g = -K.grad(problem, x, s, lda, mu)
    H = K.kkt_matrix(problem, x, s, lda, mu)
    return reg_solve_kkt(
        H, g, delta, mu, nvar=problem.nvar, neq=problem.neq,
        nineq=problem.nineq, eps=cfg.eps, reg_coef=cfg.reg_coef,
        eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
        max_retries=cfg.max_reg_retries, method="ldlt")


@pytest.mark.slow
@pytest.mark.parametrize("num", [1, 3, 5, 7, 10])
def test_condensed_matches_full_direction(num, rng):
    spec = REFERENCE_PROBLEMS[num]
    prob = spec.make()
    cfg = IPMConfig(verbosity=0)
    x = jnp.asarray(spec.sample_x0(rng))
    if prob.nineq:
        s = jnp.abs(jnp.asarray(rng.standard_normal(prob.nineq))) + 0.3
    else:
        s = jnp.zeros((0,))
    lda = jnp.asarray(rng.standard_normal(prob.ncon))
    if prob.nineq:
        lda = lda.at[prob.neq:].set(jnp.abs(lda[prob.neq:]) + 0.1)
    mu = jnp.asarray(0.2)
    delta = jnp.asarray(0.0)
    dz_c, _, _ = condensed_direction(prob, cfg, x, s, lda, mu, delta)
    dz_f, _, _ = _direction_full(prob, cfg, x, s, lda, mu, delta)
    np.testing.assert_allclose(np.asarray(dz_c), np.asarray(dz_f),
                               rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("num", sorted(REFERENCE_PROBLEMS))
def test_condensed_solver_converges(num):
    spec = REFERENCE_PROBLEMS[num]
    prob = spec.make()
    rng = np.random.default_rng(42)
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, linear_solver="condensed")
    res = solve(prob, spec.sample_x0(rng), cfg)
    assert int(res.signal) in (1, 2)
    assert spec.distance_to_truth(res.x) <= 1e-3
