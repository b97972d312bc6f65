"""Mehrotra predictor-corrector barrier strategy (an extension;
IPMConfig.mu_strategy='mehrotra', ops/condensed.py
condensed_direction_mehrotra).

The reference only has the per-outer Fiacco-McCormick/centrality update
(reference pyipm.py:1804-1814) — kept as the default for parity; the
predictor-corrector is the standard upgrade for the batched production
path (measured: mean iterations halved, Ktol hit rate 1.0 on the headline
QP family)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax import IPMConfig, solve
from pyipm_jax.models import REFERENCE_PROBLEMS
from pyipm_jax.models.random_nlp import make_qp_batch_solver, sample_qp_batch

INEQ_PROBLEMS = (5, 6, 7, 9, 10)


@pytest.mark.parametrize("num", INEQ_PROBLEMS)
def test_mehrotra_converges_reference_problems(num):
    spec = REFERENCE_PROBLEMS[num]
    prob = spec.make()
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)
    res = solve(prob, x0, IPMConfig(Ftol=1e-8, verbosity=0,
                                    mu_strategy="mehrotra"))
    assert int(res.signal) in (1, 2)
    assert spec.distance_to_truth(res.x) <= 1e-3


@pytest.mark.slow
def test_mehrotra_iteration_advantage():
    """On the headline QP family the predictor-corrector must converge in
    materially fewer iterations than the adaptive rule at an equal-or-
    better hit rate (the property the bench relies on)."""
    B, D, L = 96, 8, 3
    data = sample_qp_batch(jax.random.key(5), B, D, nlin=L)
    x0 = jnp.zeros((B, D), jnp.float32)
    stats = {}
    for strat in ("adaptive", "mehrotra"):
        cfg = IPMConfig(float_dtype="float32", verbosity=0,
                        mu_strategy=strat)
        res = make_qp_batch_solver(cfg, nvar=D, nlin=L)(x0, data)
        sigs = np.asarray(res.signal)
        stats[strat] = (float(np.mean(np.isin(sigs, (1, 2)))),
                        float(np.mean(np.asarray(res.iter_count))))
    hit_a, it_a = stats["adaptive"]
    hit_m, it_m = stats["mehrotra"]
    assert hit_m >= hit_a
    assert it_m <= 0.75 * it_a, stats


def test_mehrotra_config_validation():
    with pytest.raises(AssertionError):
        IPMConfig(mu_strategy="mehrotra", lbfgs=4)
    with pytest.raises(AssertionError):
        IPMConfig(mu_strategy="mehrotra", linear_solver="ldlt")
    with pytest.raises(AssertionError):
        IPMConfig(mu_strategy="nonsense")


def test_mehrotra_no_ineq_falls_back():
    """Problems without inequality constraints take the standard path
    under mu_strategy='mehrotra' (nothing to predict/correct)."""
    spec = REFERENCE_PROBLEMS[4]          # eq-only
    prob = spec.make()
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)
    res = solve(prob, x0, IPMConfig(Ftol=1e-8, verbosity=0,
                                    mu_strategy="mehrotra"))
    assert int(res.signal) in (1, 2)
    assert spec.distance_to_truth(res.x) <= 1e-3


def test_auto_strategy_resolves_per_problem():
    """mu_strategy='auto' must pick Mehrotra for inequality-constrained
    problems under the condensed solver and fall back to adaptive where
    Mehrotra does not apply (no inequalities / L-BFGS)."""
    cfg = IPMConfig(verbosity=0, mu_strategy="auto")
    assert cfg.resolve_mu_strategy(4).mu_strategy == "mehrotra"
    assert cfg.resolve_mu_strategy(0).mu_strategy == "adaptive"
    assert (cfg.replace(lbfgs=4).resolve_mu_strategy(4).mu_strategy
            == "adaptive")
    assert (cfg.replace(linear_solver="ldlt").resolve_mu_strategy(4)
            .mu_strategy == "adaptive")
    # end-to-end: auto solves an inequality problem (Mehrotra path) and an
    # eq-only problem (adaptive path) identically to the explicit configs
    spec = REFERENCE_PROBLEMS[5]
    prob = spec.make()
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)
    res_auto = solve(prob, x0, IPMConfig(verbosity=0, mu_strategy="auto"))
    res_meh = solve(prob, x0,
                    IPMConfig(verbosity=0, mu_strategy="mehrotra"))
    assert int(res_auto.signal) == int(res_meh.signal)
    np.testing.assert_allclose(np.asarray(res_auto.x),
                               np.asarray(res_meh.x), rtol=1e-12)
