"""Heterogeneous fleet solving (parallel/fleet.py) — the EP analog.

Contract (SURVEY.md §2 EP row, VERDICT item 3): ``solve_fleet`` over mixed
shapes/families must match per-instance single solves, while fusing
same-structure instances into batched buckets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax import IPMConfig
from pyipm_jax.core.solver import make_solver
from pyipm_jax.models.random_nlp import make_qp_problem, sample_qp_batch
from pyipm_jax.models.reference_problems import get_problem
from pyipm_jax.parallel.fleet import _LiftedInstance, solve_fleet


def _qp_instances(key, n, D, L):
    data = sample_qp_batch(key, n, D, nlin=L, dtype=jnp.float64)
    return [make_qp_problem(jax.tree.map(lambda a: a[i], data), D, L)
            for i in range(n)]


def _run_mixed_fleet(nA, nB, ref_nums):
    """Mixed-shape fleet vs per-instance single solves."""
    cfg = IPMConfig(Ftol=1e-8, verbosity=0)
    rng = np.random.default_rng(42)

    problems, x0s = [], []
    # family A: D=4 QPs (batchable bucket)
    for p in _qp_instances(jax.random.key(0), nA, 4, 2):
        problems.append(p)
        x0s.append(np.zeros(4))
    # family B: D=8 QPs with more constraints (second bucket)
    for p in _qp_instances(jax.random.key(1), nB, 8, 3):
        problems.append(p)
        x0s.append(np.zeros(8))
    # reference problems: distinct singleton buckets
    for num in ref_nums:
        spec = get_problem(num)
        problems.append(spec.make(dtype=np.float64))
        x0s.append(spec.sample_x0(rng))

    results = solve_fleet(problems, x0s, cfg, first_wave=4, wave=8)
    assert len(results) == len(problems)

    for prob, x0, res in zip(problems, x0s, results):
        single = make_solver(prob, cfg)(jnp.asarray(x0))
        assert int(res.signal) == int(single.signal)
        assert int(res.iter_count) == int(single.iter_count)
        np.testing.assert_allclose(np.asarray(res.x), np.asarray(single.x),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.slow
def test_fleet_mixed_shapes_matches_single_solves():
    """3 distinct (D, M, N) shapes in one fleet; every instance must match
    its own single solve exactly (same bucketing => identical programs for
    singletons; batched buckets match to f64 roundoff)."""
    _run_mixed_fleet(3, 2, (7,))


@pytest.mark.slow
def test_fleet_mixed_shapes_larger():
    """4 distinct shapes, bigger buckets (incl. an unconstrained
    singleton)."""
    _run_mixed_fleet(5, 3, (7, 1))


def test_fleet_bucketing_groups_same_structure():
    """Same-family same-shape instances share one bucket key; different
    shapes or constants-baked-as-literals split."""
    cfg = IPMConfig(verbosity=0)
    a = _qp_instances(jax.random.key(2), 2, 4, 2)
    b = _qp_instances(jax.random.key(3), 2, 6, 2)
    dt = np.dtype(np.float64)
    ka0 = _LiftedInstance(a[0], dt).key
    ka1 = _LiftedInstance(a[1], dt).key
    kb0 = _LiftedInstance(b[0], dt).key
    assert ka0 == ka1
    assert ka0 != kb0


def test_cross_code_path_bucketing():
    """Structurally identical problems built through DIFFERENT code paths
    (distinct lambdas/closure layouts computing the same expressions)
    must share one bucket key: jaxpr printing alpha-renames variables at
    print time, so the str(jaxpr) fingerprint is canonical (VERDICT r4
    weak #6)."""
    from pyipm_jax.core.problem import Problem

    c = np.arange(1.0, 5.0)
    A = np.eye(4)[:2]
    b = np.array([1.0, 2.0])

    def build_a(cv, Av, bv):
        cj, Aj, bj = jnp.asarray(cv), jnp.asarray(Av), jnp.asarray(bv)
        return Problem(
            nvar=4, neq=0, nineq=2,
            f=lambda x: jnp.sum(cj * x ** 2),
            ci=lambda x: Aj @ x - bj)

    def build_b(arrs):
        cost_w, mat, off = (jnp.asarray(a) for a in arrs)

        def obj(y):
            sq = y ** 2
            return jnp.sum(cost_w * sq)

        def ineq(y):
            return mat @ y - off

        return Problem(nvar=4, neq=0, nineq=2, f=obj, ci=ineq)

    dt = np.dtype(np.float64)
    ka = _LiftedInstance(build_a(c, A, b), dt).key
    kb = _LiftedInstance(build_b((c, A, b)), dt).key
    assert ka == kb


def test_fleet_single_instance():
    """A fleet of one behaves like solve()."""
    spec = get_problem(5)
    prob = spec.make(dtype=np.float64)
    cfg = IPMConfig(verbosity=0)
    rng = np.random.default_rng(0)
    x0 = spec.sample_x0(rng)
    (res,) = solve_fleet([prob], [x0], cfg)
    single = make_solver(prob, cfg)(jnp.asarray(x0))
    assert int(res.signal) == int(single.signal)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(single.x))
