"""Metrics tracing, fault injection, and profiling hooks (SURVEY.md §5 —
subsystems the reference lacks entirely)."""

import numpy as np

from pyipm_jax import IPMConfig, solve
from pyipm_jax.models import REFERENCE_PROBLEMS


def test_metrics_history():
    spec = REFERENCE_PROBLEMS[7]
    prob = spec.make()
    rng = np.random.default_rng(42)
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, trace_metrics=True)
    res = solve(prob, spec.sample_x0(rng), cfg)
    T = cfg.niter * cfg.miter
    n = int(res.iter_count)
    assert res.hist.kkt.shape == (T, 4)
    kkt = np.asarray(res.hist.kkt)
    mu = np.asarray(res.hist.mu)
    alpha = np.asarray(res.hist.alpha)
    # recorded iterations are populated, the tail stays zero
    assert np.all(kkt[:n].sum(axis=1) > 0)
    assert np.all(kkt[n:] == 0)
    # mu trace matches the barrier schedule: nonincreasing across recorded
    # outer boundaries (mu only decreases, pyipm.py:1804-1814)
    assert mu[0] >= mu[n - 1]
    # steps were taken
    assert np.any(alpha[:n] > 0)
    # final recorded kkt matches the result
    np.testing.assert_allclose(kkt[n - 1], np.asarray(res.kkt), rtol=1e-12)


def test_metrics_off_by_default():
    spec = REFERENCE_PROBLEMS[1]
    prob = spec.make()
    rng = np.random.default_rng(42)
    res = solve(prob, spec.sample_x0(rng), IPMConfig(verbosity=0))
    assert res.hist.kkt.shape == (0, 4)


def test_fault_injection_small_fault_recovers():
    """A small injected direction fault must be absorbed by the merit line
    search (solver still converges)."""
    spec = REFERENCE_PROBLEMS[5]
    prob = spec.make()
    rng = np.random.default_rng(42)
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, inject_solve_fault=1e-4,
                    niter=20)
    res = solve(prob, spec.sample_x0(rng), cfg)
    assert int(res.signal) in (1, 2)
    assert spec.distance_to_truth(res.x) <= 5e-3


def test_fault_injection_large_fault_flagged():
    """A catastrophic fault must terminate with a defined signal, not
    NaNs or a hang."""
    spec = REFERENCE_PROBLEMS[5]
    prob = spec.make()
    rng = np.random.default_rng(42)
    cfg = IPMConfig(verbosity=0, inject_solve_fault=50.0)
    res = solve(prob, spec.sample_x0(rng), cfg)
    assert int(res.signal) in (1, 2, -1, -2)
    assert np.all(np.isfinite(np.asarray(res.x)))


def test_verbosity_notices(capfd):
    """Verbosity contract: the mode banner (verbosity>0, reference
    pyipm.py:1642-1648) and the unreliable-direction notice (verbosity>2,
    pyipm.py:1496-1500) are emitted at the reference's levels."""
    import jax

    spec = REFERENCE_PROBLEMS[7]
    prob = spec.make()
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)

    solve(prob, x0, IPMConfig(verbosity=1))
    jax.effects_barrier()
    out = capfd.readouterr().out
    assert "Searching for a feasible local minimizer using the exact " \
           "Hessian." in out

    solve(prob, x0, IPMConfig(verbosity=1, lbfgs=4))
    jax.effects_barrier()
    out = capfd.readouterr().out
    assert ("Searching for a feasible local minimizer using L-BFGS to "
            "approximate the Hessian.") in out

    # catastrophic fault -> signal -2 path -> notice at verbosity 3
    spec5 = REFERENCE_PROBLEMS[5]
    res = solve(spec5.make(), spec5.sample_x0(rng),
                IPMConfig(verbosity=3, inject_solve_fault=1e3))
    jax.effects_barrier()
    out = capfd.readouterr().out
    if int(res.signal) == -2:
        assert "Search direction is unreliable to machine precision." in out


def test_nan_guard_flags_poisoned_problem():
    """A derivative that goes NaN mid-domain must terminate with signal
    -3 (the in-loop sanitizer), not iterate on NaNs to the budget."""
    import jax
    import jax.numpy as jnp

    from pyipm_jax import make_problem

    def f(x):
        return (x[0] - 2.0) ** 2 + x[1] ** 2

    def df(x):
        # poisoned GRADIENT beyond the cliff: the merit stays finite (so
        # the line search cannot catch it — a NaN merit aborts with -2),
        # but the next direction/iterate goes non-finite
        return jax.grad(f)(x) + jnp.where(x[0] > 0.5, jnp.nan, 0.0)

    prob = make_problem(f, nvar=2, df=df)
    res = solve(prob, np.array([0.0, 1.0]),
                IPMConfig(verbosity=0, niter=30))
    assert int(res.signal) == -3, int(res.signal)
    # terminated promptly, not at the iteration budget
    assert int(res.iter_count) < 30 * 20


def test_nan_guard_off_preserves_reference_behavior():
    import jax.numpy as jnp

    from pyipm_jax import make_problem

    def f(x):
        return jnp.where(x[0] < 0.5, (x[0] - 2.0) ** 2,
                         jnp.nan) + x[1] ** 2

    prob = make_problem(f, nvar=2)
    res = solve(prob, np.array([0.0, 1.0]),
                IPMConfig(verbosity=0, nan_guard=False))
    assert int(res.signal) != -3


def test_profile_solve_and_iteration_report():
    from pyipm_jax import make_solver
    from pyipm_jax.utils.profiling import (
        SolveProfile, iteration_report, profile_solve,
    )

    spec = REFERENCE_PROBLEMS[7]
    prob = spec.make()
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, trace_metrics=True)
    fn = make_solver(prob, cfg)
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)

    prof = profile_solve(fn, x0, reps=2)
    assert isinstance(prof, SolveProfile)
    assert prof.compile_s > 0 and prof.execute_s > 0
    assert prof.total_iters and prof.total_iters > 0
    assert "execute" in str(prof)

    res = fn(x0)
    rep = iteration_report(res)
    assert rep.count("\n") >= int(res.iter_count)
    assert "mu" in rep


def test_named_scopes_in_lowered_hlo():
    """The hot-path phases are named-scope annotated (SURVEY.md §5): the
    lowered HLO carries ipm-direction / ipm-line-search / ipm-kkt-residual
    (and, through reg_solve_kkt, ipm-kkt-factor / ipm-kkt-solve) so
    --profile traces are phase-labeled instead of raw XLA fusions."""
    import jax

    from pyipm_jax.core.solver import make_solver

    spec = REFERENCE_PROBLEMS[7]
    prob = spec.make()
    rng = np.random.default_rng(42)
    fn = make_solver(prob, IPMConfig(verbosity=0), jit=False)
    txt = jax.jit(fn).lower(spec.sample_x0(rng)).as_text(debug_info=True)
    for scope in ("ipm-direction", "ipm-line-search", "ipm-kkt-residual",
                  "ipm-outer-epilogue"):
        assert scope in txt, f"missing named scope {scope}"
    # the factor/solve scopes live inside reg_solve_kkt (ldlt method);
    # problem 7 is small so they route through the lane-kernel wrappers,
    # still inside the ipm-kkt-factor scope
    assert "ipm-kkt-factor" in txt
    assert "ipm-kkt-solve" in txt
