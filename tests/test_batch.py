"""Batched (vmap) and sharded scenario solving.

The reference has no batching or multi-device story; these tests cover the
batched layers: batch-consistency (batched result == loop of single
solves, SURVEY.md §4) and sharding over an 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from pyipm_jax import IPMConfig, solve, solve_batch
from pyipm_jax.models import REFERENCE_PROBLEMS
from pyipm_jax.parallel.batch import make_batch_solver
import pytest

CFG = IPMConfig(Ftol=1e-8, verbosity=0)


@pytest.mark.slow
def test_batch_matches_single_solves():
    spec = REFERENCE_PROBLEMS[7]
    prob = spec.make()
    rng = np.random.default_rng(42)
    B = 5
    x0s = np.stack([spec.sample_x0(rng) for _ in range(B)])
    batched = solve_batch(prob, x0s, CFG)
    for i in range(B):
        single = solve(prob, x0s[i], CFG)
        np.testing.assert_allclose(np.asarray(batched.x[i]),
                                   np.asarray(single.x),
                                   rtol=1e-9, atol=1e-9)
        assert int(batched.signal[i]) == int(single.signal)
        assert int(batched.iter_count[i]) == int(single.iter_count)


@pytest.mark.slow
def test_batch_mixed_convergence():
    """Instances converge independently; per-instance signals/iters differ."""
    spec = REFERENCE_PROBLEMS[5]
    prob = spec.make()
    rng = np.random.default_rng(1)
    B = 16
    x0s = np.stack([spec.sample_x0(rng) * (1 + 5 * i / B)
                    for i in range(B)])
    res = solve_batch(prob, x0s, CFG)
    sigs = np.asarray(res.signal)
    assert np.all(np.isin(sigs, [1, 2, -1, -2]))
    # the vast majority must converge
    assert np.mean(np.isin(sigs, [1, 2])) >= 0.9
    for i in range(B):
        if sigs[i] in (1, 2):
            assert spec.distance_to_truth(res.x[i]) <= 1e-3


@pytest.mark.slow
def test_batch_sharded_over_mesh():
    """Shard the instance axis over all 8 virtual devices; results must
    match the unsharded batch exactly."""
    spec = REFERENCE_PROBLEMS[7]
    prob = spec.make()
    rng = np.random.default_rng(3)
    ndev = len(jax.devices())
    B = 2 * ndev
    x0s = np.stack([spec.sample_x0(rng) for _ in range(B)])

    from pyipm_jax.parallel.mesh import make_batch_mesh

    mesh = make_batch_mesh()
    fn = make_batch_solver(prob, CFG, mesh=mesh)
    res_sharded = fn(jnp.asarray(x0s))
    res_plain = solve_batch(prob, x0s, CFG)
    np.testing.assert_allclose(np.asarray(res_sharded.x),
                               np.asarray(res_plain.x),
                               rtol=1e-9, atol=1e-9)
    # outputs carry the batch sharding
    shard_devs = {d for s in res_sharded.x.addressable_shards
                  for d in [s.device]}
    assert len(shard_devs) == ndev


def test_rescue_failures_recovers_stragglers():
    """rescue_failures re-solves non-converged instances under a stronger
    config and scatters successes back, leaving converged instances
    untouched (the r03 failure-tail recipe as a library call)."""
    import jax

    from pyipm_jax.models.random_nlp import (
        make_qp_problem, sample_qp_batch,
    )
    from pyipm_jax.parallel.batch import rescue_failures

    B, D, L = 32, 8, 2
    data = sample_qp_batch(jax.random.key(5), B, D, nlin=L,
                           dtype=jnp.float64)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=2, miter=3)

    def family(d_):
        return make_qp_problem(d_, D, L)

    def solve_one(x0_i, d_):
        from pyipm_jax.core.solver import make_solver
        return make_solver(family(d_), cfg, jit=False)(x0_i)

    x0 = jnp.zeros((B, D), jnp.float64)
    res = jax.jit(jax.vmap(solve_one))(x0, data)
    sigs0 = np.asarray(res.signal)
    n_fail0 = int(np.sum(~np.isin(sigs0, (1, 2))))
    assert n_fail0 > 0, "fixture should produce budget-outs at niter=2"

    merged, n_failed, n_rescued = rescue_failures(
        res, x0, cfg, family, data)
    assert n_failed == n_fail0
    assert n_rescued == n_failed          # QPs: all rescue under 'auto'
    sigs1 = np.asarray(merged.signal)
    assert np.all(np.isin(sigs1, (1, 2)))
    # originally-converged instances are untouched
    keep = np.isin(sigs0, (1, 2))
    np.testing.assert_array_equal(np.asarray(merged.x)[keep],
                                  np.asarray(res.x)[keep])
