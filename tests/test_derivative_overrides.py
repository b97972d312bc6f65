"""User-supplied-derivative sweep — the JAX analog of the reference's
combinatorial precompiled-vs-expression harness (reference unit_tests.py:20-25,
245-310, exercising the dual code paths of compile()).

Here the two states per callable are {autodiff, user-supplied-callable};
user Jacobians follow the reference's transposed DxM/DxN convention
(reference pyipm.py:223-225 note 2) and user constraint Hessians are
multiplier-contracted with the FULL lambda vector (pyipm.py:492-507)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax import IPMConfig, make_problem, solve
from pyipm_jax.models import REFERENCE_PROBLEMS

STOL = 1.0e-3


def _p10_callables():
    spec = REFERENCE_PROBLEMS[10]
    f, ce, ci = spec.f, spec.ce, spec.ci

    def ce1(x):
        return jnp.reshape(jnp.asarray(ce(x)), (1,))

    def ci1(x):
        return jnp.reshape(jnp.asarray(ci(x)), (1,))

    derivs = dict(
        df=jax.grad(f),
        d2f=jax.hessian(f),
        dce=lambda x: jax.jacfwd(ce1)(x).T,
        d2ce=lambda x, lda: jax.hessian(
            lambda xx: jnp.sum(ce1(xx) * lda[:1]))(x),
        dci=lambda x: jax.jacfwd(ci1)(x).T,
        d2ci=lambda x, lda: jax.hessian(
            lambda xx: jnp.sum(ci1(xx) * lda[1:]))(x),
    )
    return spec, derivs


FIRST = ["df", "dce", "dci"]
SECOND = ["d2f", "d2ce", "d2ci"]


@pytest.mark.parametrize(
    "supplied",
    [
        (),
        ("df",),
        ("df", "d2f"),
        ("dce", "dci"),
        ("d2ce", "d2ci"),
        ("df", "d2f", "dce", "d2ce", "dci", "d2ci"),
    ],
)
def test_exact_hessian_override_combos(supplied):
    spec, derivs = _p10_callables()
    overrides = {k: derivs[k] for k in supplied}
    prob = make_problem(spec.f, spec.nvar, ce=spec.ce, ci=spec.ci, **overrides)
    rng = np.random.default_rng(42)
    res = solve(prob, spec.sample_x0(rng), IPMConfig(Ftol=1e-8, verbosity=0))
    assert int(res.signal) in (1, 2)
    assert spec.distance_to_truth(res.x) <= STOL


@pytest.mark.parametrize("supplied", [(), ("df",), ("df", "dce", "dci")])
def test_lbfgs_override_combos(supplied):
    """L-BFGS mode forbids second-derivative use (reference unit_tests.py:291-295
    forces d2* to NULL under L-BFGS); first-derivative overrides apply."""
    spec, derivs = _p10_callables()
    overrides = {k: derivs[k] for k in supplied}
    prob = make_problem(spec.f, spec.nvar, ce=spec.ce, ci=spec.ci, **overrides)
    rng = np.random.default_rng(42)
    res = solve(prob, spec.sample_x0(rng),
                IPMConfig(Ftol=1e-8, verbosity=0, lbfgs=4))
    assert int(res.signal) in (1, 2)
    assert spec.distance_to_truth(res.x) <= STOL


def test_shifted_user_gradient_changes_result():
    """Sanity: user overrides are actually used (a shifted df moves the
    stationary point the solver finds)."""
    spec = REFERENCE_PROBLEMS[1]
    prob = make_problem(spec.f, spec.nvar,
                        df=lambda x: jax.grad(spec.f)(x) + 0.5)
    rng = np.random.default_rng(42)
    res = solve(prob, spec.sample_x0(rng), IPMConfig(verbosity=0))
    # the shifted-gradient stationary point is away from the true optimum
    assert spec.distance_to_truth(res.x) > 1e-3
