"""Large-D L-BFGS regime tests — the regime the mode EXISTS for.

The reference positions L-BFGS explicitly for problems where the
(D+M+N)^2 Hessian is prohibitive (/root/reference/README.md:196-207,
pyipm.py:195-199) but never exercises it beyond toy sizes.  These tests
prove the compact-Woodbury path (core/lbfgs.py) at D >= 4096: the
direction computation touches only O(D*m) and (M+N)^2 objects — no
(D+M+N)^2 matrix is ever materialized (asserted on the jaxpr) — and the
solve converges to Ktol.
"""

import jax
from jax.extend import core as xcore
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax.config import IPMConfig
from pyipm_jax.core.solver import make_solver
from pyipm_jax.models.random_nlp import (
    make_dense_nlp_problem, sample_dense_nlp,
)


@pytest.mark.slow
def test_lbfgs_converges_at_d4096_eq_constrained():
    """D=4096, M=8 equality-constrained nonconvex dense NLP, L-BFGS(8):
    KKT residual to Ktol (the large-D claim of the reference README)."""
    D, M = 4096, 8
    data = sample_dense_nlp(jax.random.key(0), D, M, dtype=jnp.float64)
    prob = make_dense_nlp_problem(data, D, M)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, lbfgs=8,
                    niter=10, miter=60)
    res = make_solver(prob, cfg)(jnp.zeros((D,), jnp.float64))
    assert int(res.signal) == 1, (int(res.signal), np.asarray(res.kkt))
    assert np.all(np.asarray(res.kkt) <= cfg.Ktol * (1 + 1e-9))


@pytest.mark.slow
def test_lbfgs_converges_at_d4096_unconstrained():
    """D=4096 unconstrained: the classic compact inverse-Hessian path."""
    D = 4096
    data = sample_dense_nlp(jax.random.key(1), D, 1, dtype=jnp.float64)

    from pyipm_jax.core.problem import Problem

    sqrtD = float(np.sqrt(D))

    def f(x):
        feat = jnp.tanh(data.W @ x / sqrtD)
        return (0.5 * x @ (data.P @ x) + data.c @ x
                + data.alpha * jnp.sum(feat))

    prob = Problem(f=f, nvar=D)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, lbfgs=8,
                    niter=10, miter=60)
    res = make_solver(prob, cfg)(jnp.zeros((D,), jnp.float64))
    assert int(res.signal) == 1, (int(res.signal), np.asarray(res.kkt))
    assert np.all(np.asarray(res.kkt) <= cfg.Ktol * (1 + 1e-9))


def test_lbfgs_direction_never_materializes_dense_hessian():
    """The L-BFGS solve must not allocate any (D+M+N)^2-sized array: scan
    the solver jaxpr for square shapes of the composite dimension.  (At
    D=512 tracing is fast; the property is shape-generic.)"""
    D, M = 512, 4
    data = sample_dense_nlp(jax.random.key(2), D, M, dtype=jnp.float64)
    prob = make_dense_nlp_problem(data, D, M)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, lbfgs=8)
    fn = make_solver(prob, cfg, jit=False)
    jaxpr = jax.make_jaxpr(fn)(jnp.zeros((D,), jnp.float64))
    big = (D + M, D + M)

    def subjaxprs(val):
        if isinstance(val, xcore.ClosedJaxpr):
            yield val.jaxpr
        elif isinstance(val, xcore.Jaxpr):
            yield val
        elif isinstance(val, (tuple, list)):
            for v in val:
                yield from subjaxprs(v)

    def shapes(jx):
        for eqn in jx.eqns:
            for v in eqn.outvars:
                if hasattr(v, "aval") and hasattr(v.aval, "shape"):
                    yield v.aval.shape
            for val in eqn.params.values():
                for sub in subjaxprs(val):
                    yield from shapes(sub)

    offenders = [s for s in shapes(jaxpr)
                 if len(s) >= 2 and tuple(s[-2:]) == big]
    assert not offenders, f"dense composite matrices materialized: {big}"


def test_lbfgs_batched_consistency_small():
    """Batched (vmapped) L-BFGS equals the loop of single solves — the
    DP-composability of the large-D mode."""
    D, M, B = 64, 4, 3
    keys = jax.random.split(jax.random.key(3), B)
    datas = jax.vmap(lambda k: sample_dense_nlp(k, D, M,
                                                dtype=jnp.float64))(keys)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, lbfgs=6,
                    niter=10, miter=40)

    def solve_one(x0, data):
        prob = make_dense_nlp_problem(data, D, M)
        return make_solver(prob, cfg, jit=False)(x0)

    x0 = jnp.zeros((B, D), jnp.float64)
    batched = jax.jit(jax.vmap(solve_one))(x0, datas)
    for i in range(B):
        data_i = jax.tree.map(lambda a: a[i], datas)
        single = jax.jit(solve_one)(x0[i], data_i)
        assert int(batched.signal[i]) == int(single.signal)
        np.testing.assert_allclose(np.asarray(batched.x[i]),
                                   np.asarray(single.x),
                                   rtol=1e-9, atol=1e-10)
