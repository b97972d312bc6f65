"""Application model families converge and certify their KKT conditions.

Each family is solved as a small vmapped fleet on the CPU test backend;
the oracle is structural (signal, feasibility, complementarity residual)
plus a family-specific optimality check where one is cheaply available.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax import IPMConfig
from pyipm_jax.models import applications as app

CFG = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)
B = 4


def _check_fleet(res, atol=2e-3):
    sigs = np.asarray(res.signal)
    assert np.all(np.isin(sigs, (1, 2))), f"signals={sigs.tolist()}"
    kkt = np.asarray(res.kkt)
    assert np.all(kkt[np.isin(sigs, (1,))] <= CFG.Ktol * (1 + 1e-6))


@pytest.mark.slow
def test_portfolio():
    D = 8
    data = app.sample_portfolio_batch(jax.random.key(0), B, D)
    fn = app.make_portfolio_batch_solver(CFG, D)
    res = fn(app.portfolio_x0(B, D), data)
    _check_fleet(res)
    x = np.asarray(res.x)
    # budget and long-only feasibility
    np.testing.assert_allclose(x.sum(-1), 1.0, atol=2e-3)
    assert np.all(x >= -2e-3)
    assert np.all(x <= np.asarray(data.cap) + 2e-3)


@pytest.mark.slow
def test_svm_dual():
    n = 10
    data = app.sample_svm_batch(jax.random.key(1), B, n)
    fn = app.make_svm_batch_solver(CFG, n)
    res = fn(app.svm_x0(data), data)
    _check_fleet(res)
    a = np.asarray(res.x)
    y = np.asarray(data.y)
    np.testing.assert_allclose((y * a).sum(-1), 0.0, atol=2e-3)
    assert np.all(a >= -2e-3)
    assert np.all(a <= np.asarray(data.C)[:, None] + 2e-3)


@pytest.mark.slow
def test_maxent():
    D = 12
    data = app.sample_maxent_batch(jax.random.key(2), B, D)
    fn = app.make_maxent_batch_solver(CFG, D)
    res = fn(app.maxent_x0(B, D), data)
    _check_fleet(res)
    p = np.asarray(res.x)
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=2e-3)
    assert np.all(p >= -1e-4)
    # moment constraints hold
    mom = np.einsum("bmd,bd->bm", np.asarray(data.A), p)
    np.testing.assert_allclose(mom, np.asarray(data.b), atol=5e-3)


@pytest.mark.slow
def test_maxent_no_moments_is_uniform():
    """With only the simplex constraint, max entropy = uniform — the
    scaled version of reference example 6 (pyipm.py:2019-2042)."""
    D = 6
    data = app.MaxEntData(A=jnp.zeros((B, 0, D), jnp.float32),
                          b=jnp.zeros((B, 0), jnp.float32))
    fn = app.make_maxent_batch_solver(CFG, D)
    res = fn(app.maxent_x0(B, D) + 0.01, data)
    _check_fleet(res)
    np.testing.assert_allclose(np.asarray(res.x), 1.0 / D, atol=1e-3)


@pytest.mark.slow
def test_mpc():
    T, nu = 6, 2
    data = app.sample_mpc_batch(jax.random.key(3), B)
    fn = app.make_mpc_batch_solver(CFG, T)
    res = fn(app.mpc_x0(B, T, nu), data)
    _check_fleet(res)
    u = np.asarray(res.x)
    umax = np.asarray(data.umax)[:, None]
    assert np.all(np.abs(u) <= umax + 2e-3)
    # solver cost must beat the zero-input rollout (x0 objective)
    f0 = np.asarray(jax.vmap(
        lambda d: app.make_mpc_problem(d, T).f_val(
            jnp.zeros((T * nu,), jnp.float32)))(data))
    assert np.all(np.asarray(res.fval) <= f0 + 1e-5)


def test_resource_allocation_distributed():
    """Multi-agent resource allocation solves as ONE interior-point
    program over the 8-device mesh: all local constraints + the shared
    resource pool satisfied at the KKT point."""
    import jax

    from pyipm_jax.models.applications import (
        make_resource_alloc_spec, sample_resource_alloc,
    )
    from pyipm_jax.parallel.schur import make_block_solver

    K, d, nres = 16, 6, 3
    data = sample_resource_alloc(jax.random.key(0), K, d, nres=nres,
                                 dtype=jnp.float64)
    spec = make_resource_alloc_spec(d, nres=nres)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("model",))
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                    miter=25)
    fn = make_block_solver(spec, mesh, cfg)
    res = fn(jnp.full((K, d), 1.0, jnp.float64), data.theta,
             ccdata=data.ccdata)
    assert int(res.signal) == 1, np.asarray(res.kkt)
    x = np.asarray(res.x)
    assert np.all(x >= -1e-8)                      # nonnegativity
    th = data.theta
    eres = np.asarray(jnp.einsum("kmd,kd->km", th["Ce"], res.x)
                      - th["e"])
    assert np.linalg.norm(eres.ravel()) <= 1e-4    # local demands
    pool = np.asarray(jnp.einsum("krd,kd->r", th["R"], res.x))
    np.testing.assert_allclose(pool, np.asarray(data.ccdata["budget"]),
                               atol=1e-4)          # shared pool binding


def test_resource_allocation_inequality_cap():
    """The ineq-cap variant (sum_k R_k x_k <= budget, the coupling-
    INEQUALITY class): caps hold at the solution and active resources
    carry positive shadow prices."""
    import jax

    from pyipm_jax.models.applications import (
        make_resource_alloc_spec, sample_resource_alloc,
    )
    from pyipm_jax.parallel.schur import make_block_solver

    K, d, nres = 16, 6, 3
    data = sample_resource_alloc(jax.random.key(1), K, d, nres=nres,
                                 dtype=jnp.float64)
    spec = make_resource_alloc_spec(d, nres=nres, cap="ineq")
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("model",))
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                    miter=25)
    fn = make_block_solver(spec, mesh, cfg)
    res = fn(jnp.full((K, d), 1.0, jnp.float64), data.theta,
             ccdata=data.ccdata)
    assert int(res.signal) == 1, np.asarray(res.kkt)
    pool = np.asarray(jnp.einsum("krd,kd->r", data.theta["R"], res.x))
    budget = np.asarray(data.ccdata["budget"])
    assert np.all(pool <= budget + 1e-5)
    # complementarity: where the cap binds, lci > 0; where slack, lci ~ 0
    slack = budget - pool
    lci = np.asarray(res.lci)
    assert np.all(lci >= -1e-8)
    assert np.all(slack * lci <= 1e-3)
