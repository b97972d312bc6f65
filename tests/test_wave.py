"""Wave-compacted batching and solver pause/resume.

The solver core's flattened loop (core/solver.py) pauses after a bounded
iteration budget and resumes exactly; the wave batch solver
(parallel/batch.py) uses that to retire converged instances instead of
paying the vmap lockstep straggler tax.  These tests pin the contract:
wave-compacted results match lockstep results instance-for-instance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax import IPMConfig
from pyipm_jax.core.solver import make_solver
from pyipm_jax.models.random_nlp import (
    make_qp_batch_solver, make_qp_problem, sample_qp_batch,
)
from pyipm_jax.models.reference_problems import get_problem
from pyipm_jax.parallel.batch import make_wave_batch_solver


def _budget_matches_full(nums):
    """Chunked run_budget solves must match straight-through solves on
    iteration counts, signals, and (to roundoff across compilation
    boundaries) iterates."""
    for num in nums:
        spec = get_problem(num)
        prob = spec.make(dtype=np.float64)
        cfg = IPMConfig(Ftol=1e-8, verbosity=0)
        fn = make_solver(prob, cfg, jit=False)
        rng = np.random.default_rng(42)
        x0 = jnp.asarray(spec.sample_x0(rng))
        full = jax.jit(fn)(x0)

        st = fn.init_state(x0)
        runb = jax.jit(fn.run_budget)
        for _ in range(cfg.niter * cfg.miter):
            st = runb(st, 3)
            if int(st.signal) != 0:
                break
        res = fn.finalize(st)
        assert int(res.signal) == int(full.signal)
        assert int(res.iter_count) == int(full.iter_count)
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(full.x),
                                   rtol=1e-12, atol=1e-12)


def test_run_budget_pause_resume_matches_full():
    _budget_matches_full((5, 10))      # ineq-only + mixed


@pytest.mark.slow
def test_run_budget_pause_resume_all_classes():
    _budget_matches_full((1, 7))       # unconstrained + eq+ineq


@pytest.mark.slow
def test_wave_matches_lockstep_qp_family():
    B, D, L = 192, 8, 3
    cfg = IPMConfig(float_dtype="float32", verbosity=0)
    data = sample_qp_batch(jax.random.key(7), B, D, nlin=L)
    x0 = jnp.zeros((B, D), jnp.float32)

    ref = make_qp_batch_solver(cfg, nvar=D, nlin=L)(x0, data)
    wavefn = make_wave_batch_solver(
        config=cfg, family=lambda d: make_qp_problem(d, D, L),
        first_wave=8, wave=16, min_pad=16)
    res = wavefn(x0, data)

    # Wave compaction re-batches instances into different shapes, so
    # batched ops differ from the lockstep run at the ulp level and an
    # occasional instance near a test boundary may flip an iteration.
    # The contract: same convergence status everywhere, same iteration
    # count for nearly all instances, converged solutions agree.
    sig_ref = np.asarray(ref.signal)
    sig = np.asarray(res.signal)
    np.testing.assert_array_equal(np.isin(sig_ref, (1, 2)),
                                  np.isin(sig, (1, 2)))
    same_iters = np.mean(np.asarray(ref.iter_count)
                         == np.asarray(res.iter_count))
    assert same_iters >= 0.95, same_iters
    ok = np.isin(sig_ref, (1, 2))
    np.testing.assert_allclose(np.asarray(ref.x)[ok],
                               np.asarray(res.x)[ok], rtol=2e-3, atol=2e-3)


def test_wave_fixed_problem_matches_single_solves():
    """Fixed-problem path (no per-instance data): wave results must match
    per-instance single solves."""
    spec = get_problem(7)
    prob = spec.make(dtype=np.float64)
    cfg = IPMConfig(Ftol=1e-8, verbosity=0)
    rng = np.random.default_rng(3)
    B = 6
    x0s = jnp.asarray(np.stack([spec.sample_x0(rng) for _ in range(B)]))

    wavefn = make_wave_batch_solver(prob, cfg, first_wave=4, wave=8,
                                    min_pad=4)
    res = wavefn(x0s)

    single = make_solver(prob, cfg)
    for i in range(B):
        ri = single(x0s[i])
        assert int(res.signal[i]) == int(ri.signal)
        assert int(res.iter_count[i]) == int(ri.iter_count)
        np.testing.assert_allclose(np.asarray(res.x[i]), np.asarray(ri.x),
                                   rtol=1e-10, atol=1e-10)
