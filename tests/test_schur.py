"""Distributed block-separable Schur-complement solver tests
(the TP-analog layer, SURVEY.md §2) on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax.config import IPMConfig
from pyipm_jax.parallel.schur import (
    SeparableData, make_separable_solver, sample_separable,
)


def _mesh(n):
    return jax.sharding.Mesh(
        np.asarray(jax.devices()[:n]), ("model",),
        axis_types=(jax.sharding.AxisType.Auto,))


def test_separable_converges_and_satisfies_constraints():
    K, d, mc = 8, 4, 3
    spec, data, x0 = sample_separable(jax.random.key(0), K, d, mc,
                                      dtype=jnp.float64)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=8, miter=20)
    fn = make_separable_solver(spec, _mesh(8), cfg)
    res = fn(x0, data)
    kkt = np.asarray(res.kkt)
    assert int(res.signal) == 1, f"kkt={kkt} signal={int(res.signal)}"
    assert np.all(kkt <= cfg.Ktol * (1 + 1e-9))
    # coupling constraints satisfied
    ce = np.einsum("kcd,kd->c", np.asarray(data.A), np.asarray(res.x)) \
        - np.asarray(data.b)
    assert np.linalg.norm(ce) <= 1e-4
    # bounds respected
    assert np.all(np.asarray(res.x) >= np.asarray(data.lb) - 1e-8)


@pytest.mark.slow
def test_separable_matches_global_kkt():
    """The distributed solution must satisfy the GLOBAL first-order
    conditions of the assembled problem (cross-check against a dense
    single-device formulation)."""
    K, d, mc = 4, 3, 2
    spec, data, x0 = sample_separable(jax.random.key(1), K, d, mc,
                                      dtype=jnp.float64)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=8, miter=20)
    fn = make_separable_solver(spec, _mesh(4), cfg)
    res = fn(x0, data)
    assert int(res.signal) == 1

    x = np.asarray(res.x)          # (K, d)
    z = np.asarray(res.z)
    lc = np.asarray(res.lc)
    Q = np.asarray(data.theta["Q"])
    c = np.asarray(data.theta["c"])
    A = np.asarray(data.A)
    # stationarity: Q_k x_k + c_k - A_k^T lc - z_k = 0
    r = np.einsum("kij,kj->ki", Q, x) + c \
        - np.einsum("kcd,c->kd", A, lc) - z
    assert np.linalg.norm(r.ravel()) <= 2e-4


@pytest.mark.slow
def test_separable_invariant_to_mesh_size():
    """Same problem, 2-device vs 8-device mesh: identical solution (the
    Schur psum is the only cross-device coupling)."""
    K, d, mc = 8, 3, 2
    spec, data, x0 = sample_separable(jax.random.key(2), K, d, mc,
                                      dtype=jnp.float64)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=6, miter=15)
    r2 = make_separable_solver(spec, _mesh(2), cfg)(x0, data)
    r8 = make_separable_solver(spec, _mesh(8), cfg)(x0, data)
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r8.x),
                               rtol=1e-8, atol=1e-8)
    assert int(r2.iter_count) == int(r8.iter_count)


def test_separable_with_blockwise_equalities():
    """Eq-beyond-box structure: per-block equality constraints ce_k(x_k)=0
    on top of coupling + bounds.  The distributed solve must converge and
    satisfy ALL constraint classes plus global stationarity."""
    from pyipm_jax.parallel.schur import sample_separable_eq

    K, d, mc, me = 8, 4, 2, 1
    spec, data, x0 = sample_separable_eq(jax.random.key(3), K, d, mc,
                                         me=me, dtype=jnp.float64)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=8, miter=20)
    fn = make_separable_solver(spec, _mesh(8), cfg)
    res = fn(x0, data)
    kkt = np.asarray(res.kkt)
    assert int(res.signal) == 1, f"kkt={kkt} signal={int(res.signal)}"
    assert np.all(kkt <= cfg.Ktol * (1 + 1e-9))

    x = np.asarray(res.x)
    z = np.asarray(res.z)
    le = np.asarray(res.le)
    lc = np.asarray(res.lc)
    Q = np.asarray(data.theta["Q"])
    c = np.asarray(data.theta["c"])
    C = np.asarray(data.theta["C"])
    e = np.asarray(data.theta["e"])
    A = np.asarray(data.A)
    # per-block equalities satisfied
    ceb = np.einsum("kmd,kd->km", C, x) - e
    assert np.linalg.norm(ceb.ravel()) <= 1e-4, ceb
    # coupling satisfied
    cec = np.einsum("kcd,kd->c", A, x) - np.asarray(data.b)
    assert np.linalg.norm(cec) <= 1e-4
    # bounds respected
    assert np.all(x >= np.asarray(data.lb) - 1e-8)
    # global stationarity: Q x + c - A^T lc - C^T le - z = 0
    r = (np.einsum("kij,kj->ki", Q, x) + c
         - np.einsum("kcd,c->kd", A, lc)
         - np.einsum("kmd,km->kd", C, le) - z)
    assert np.linalg.norm(r.ravel()) <= 2e-4, np.linalg.norm(r.ravel())


def test_separable_eq_without_box():
    """Pure-equality separable problem (no bounds): per-block + coupling
    equalities only."""
    from pyipm_jax.parallel.schur import sample_separable_eq

    K, d, mc, me = 4, 3, 2, 1
    spec, data, x0 = sample_separable_eq(jax.random.key(4), K, d, mc,
                                         me=me, dtype=jnp.float64,
                                         has_box=False)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=8, miter=20)
    fn = make_separable_solver(spec, _mesh(4), cfg)
    res = fn(x0, data)
    assert int(res.signal) == 1, np.asarray(res.kkt)
    x = np.asarray(res.x)
    C = np.asarray(data.theta["C"])
    e = np.asarray(data.theta["e"])
    ceb = np.einsum("kmd,kd->km", C, x) - e
    assert np.linalg.norm(ceb.ravel()) <= 1e-4


# ----------------------------------------------------------------------
# general block-NLP structure (round-3): per-block equalities, GENERAL
# per-block inequalities, upper+lower bounds, NONLINEAR coupling
def test_block_general_converges_nonlinear_coupling():
    """Full generality: nonlinear per-block inequalities (not bounds),
    per-block equalities, and a NONLINEAR coupling constraint
    cc(sum_k g_k(x_k)) = 0 with quadratic pooled features."""
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    K, d = 8, 3
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(10), K, d, me=1, ni=2, p=2, mc=1)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10, miter=25)
    fn = make_block_solver(spec, _mesh(8), cfg)
    res = fn(x0, theta, ccdata=ccdata)
    kkt = np.asarray(res.kkt)
    assert int(res.signal) == 1, f"kkt={kkt} signal={int(res.signal)}"
    assert np.all(kkt <= cfg.Ktol * (1 + 1e-9))
    x = np.asarray(res.x)
    # per-block equalities
    ceb = np.asarray(jax.vmap(spec.ce_blk)(jnp.asarray(x), theta))
    assert np.linalg.norm(ceb.ravel()) <= 2e-4
    # general inequalities respected (to slack tolerance)
    cib = np.asarray(jax.vmap(spec.ci_blk)(jnp.asarray(x), theta))
    assert np.all(cib >= -1e-6), cib.min()
    # nonlinear coupling satisfied
    u = np.asarray(jnp.sum(jax.vmap(spec.g_blk)(jnp.asarray(x), theta),
                           axis=0))
    ccv = np.asarray(spec.cc(jnp.asarray(u), ccdata))
    assert np.linalg.norm(ccv) <= 2e-4, ccv


def test_block_general_parity_with_assembled_single_device():
    """THE distributed-correctness oracle: the general sharded solver on
    the 8-device mesh must match a single-device 'condensed' solve of the
    ASSEMBLED problem (blocks concatenated, coupling appended to ce) —
    same constraint classes as the reference's full NLP
    (/root/reference/pyipm.py:29-36)."""
    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.core.problem import Problem
    from pyipm_jax.core.solver import solve as solve_single
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    K, d, me, ni, p, mc = 8, 3, 1, 2, 2, 1
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(11), K, d, me=me, ni=ni, p=p, mc=mc)
    cfg = Cfg(float_dtype="float64", verbosity=0, niter=10, miter=25,
              linear_solver="condensed")

    # distributed solve (defaults: le=0, li=Ktol, lc=0)
    fn = make_block_solver(spec, _mesh(8), cfg)
    res_d = fn(x0, theta, ccdata=ccdata)
    assert int(res_d.signal) == 1, np.asarray(res_d.kkt)

    # assembled single-device problem: ce = [ce_1..ce_K; cc(sum g)],
    # ci = [ci_1..ci_K]
    def f(x):
        xb = x.reshape(K, d)
        return jnp.sum(jax.vmap(spec.f_blk)(xb, theta))

    def ce(x):
        xb = x.reshape(K, d)
        per = jax.vmap(spec.ce_blk)(xb, theta).reshape(-1)
        u = jnp.sum(jax.vmap(spec.g_blk)(xb, theta), axis=0)
        return jnp.concatenate([per, spec.cc(u, ccdata)])

    def ci(x):
        xb = x.reshape(K, d)
        return jax.vmap(spec.ci_blk)(xb, theta).reshape(-1)

    prob = Problem(f=f, nvar=K * d, neq=K * me + mc, nineq=K * ni,
                   ce=ce, ci=ci)
    # NO hand-fed lda0 anywhere: both sides default to the least-squares
    # multiplier initializer (distributed: the bordered ls_multiplier_init;
    # single-device: core/kkt.py init_lambda) — the r3 le=0/li=Ktol
    # deviation is gone
    res_s = solve_single(prob, x0.reshape(-1), cfg)
    assert int(res_s.signal) == 1, np.asarray(res_s.kkt)

    # the two solves follow the same trajectory to roundoff
    np.testing.assert_allclose(np.asarray(res_d.x).reshape(-1),
                               np.asarray(res_s.x), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(res_d.fval), float(res_s.fval),
                               rtol=1e-9)
    assert abs(int(res_d.iter_count) - int(res_s.iter_count)) <= 1, (
        int(res_d.iter_count), int(res_s.iter_count))
    # multipliers agree too (assembled layout: [le blocks; lc; li blocks])
    lda_s = np.asarray(res_s.lda)
    np.testing.assert_allclose(np.asarray(res_d.le).reshape(-1),
                               lda_s[:K * me], atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_d.lc),
                               lda_s[K * me:K * me + mc], atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_d.li).reshape(-1),
                               lda_s[K * me + mc:], atol=1e-6)


def test_block_upper_and_lower_bounds():
    """Box constraints with BOTH bounds via the general inequality class
    (ci = [x - lb; ub - x])."""
    from pyipm_jax.parallel.schur import BlockNLP, box_ci, make_block_solver

    K, d, mc = 8, 3, 2
    key = jax.random.key(12)
    kq, kc, ka, kx = jax.random.split(key, 4)
    G = jax.random.normal(kq, (K, d, d), jnp.float64) / np.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", G, G) + jnp.eye(d, dtype=jnp.float64)
    c = 3.0 * jax.random.normal(kc, (K, d), jnp.float64)
    A = jax.random.normal(ka, (K, mc, d), jnp.float64) / np.sqrt(K * d)
    xfeas = jax.random.normal(kx, (K, d), jnp.float64) * 0.1
    theta = {"Q": Q, "c": c, "A": A,
             "lb": jnp.full((K, d), -0.5, jnp.float64),
             "ub": jnp.full((K, d), 0.5, jnp.float64)}
    ccdata = {"b": jnp.einsum("kcd,kd->c", A, xfeas)}

    spec = BlockNLP(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        d=d, ci_blk=box_ci("lb", "ub"), ni=2 * d,
        g_blk=lambda xk, th: th["A"] @ xk,
        cc=lambda u, ccd: u - ccd["b"], p=mc, mc=mc)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10, miter=25)
    fn = make_block_solver(spec, _mesh(8), cfg)
    res = fn(jnp.zeros((K, d), jnp.float64), theta, ccdata=ccdata)
    assert int(res.signal) == 1, np.asarray(res.kkt)
    x = np.asarray(res.x)
    assert np.all(x >= -0.5 - 1e-8) and np.all(x <= 0.5 + 1e-8)
    # with a pull of |c| ~ 3 and tight bounds some bound must be active
    assert np.any(np.abs(np.abs(x) - 0.5) <= 1e-3)


def test_block_mehrotra_parity_with_assembled_single_device():
    """Distributed Mehrotra predictor-corrector must match the assembled
    single-device mu_strategy='mehrotra' solve — same factorization-reuse
    predictor/corrector, psum-reduced centering (parallel/schur.py vs
    ops/condensed.py condensed_direction_mehrotra)."""
    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.core.problem import Problem
    from pyipm_jax.core.solver import solve as solve_single
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    K, d, me, ni, p, mc = 8, 3, 1, 2, 2, 1
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(13), K, d, me=me, ni=ni, p=p, mc=mc)
    cfg = Cfg(float_dtype="float64", verbosity=0, niter=10, miter=25,
              mu_strategy="mehrotra")

    fn = make_block_solver(spec, _mesh(8), cfg)
    res_d = fn(x0, theta, ccdata=ccdata)
    assert int(res_d.signal) == 1, np.asarray(res_d.kkt)

    def f(x):
        xb = x.reshape(K, d)
        return jnp.sum(jax.vmap(spec.f_blk)(xb, theta))

    def ce(x):
        xb = x.reshape(K, d)
        per = jax.vmap(spec.ce_blk)(xb, theta).reshape(-1)
        u = jnp.sum(jax.vmap(spec.g_blk)(xb, theta), axis=0)
        return jnp.concatenate([per, spec.cc(u, ccdata)])

    def ci(x):
        xb = x.reshape(K, d)
        return jax.vmap(spec.ci_blk)(xb, theta).reshape(-1)

    prob = Problem(f=f, nvar=K * d, neq=K * me + mc, nineq=K * ni,
                   ce=ce, ci=ci)
    res_s = solve_single(prob, x0.reshape(-1), cfg)   # LS init both sides
    assert int(res_s.signal) == 1, np.asarray(res_s.kkt)
    np.testing.assert_allclose(np.asarray(res_d.x).reshape(-1),
                               np.asarray(res_s.x), rtol=1e-6, atol=1e-8)
    assert abs(int(res_d.iter_count) - int(res_s.iter_count)) <= 1


def test_block_solver_pause_resume_checkpoint():
    """The distributed solve pauses after a bounded number of iterations,
    round-trips its sharded SolverState through host numpy (the
    checkpoint unit), and resumes BIT-EXACTLY to the straight-through
    result — the multi-host failure-recovery contract (parallel/launch.py
    docstring: recovery = relaunch + resume from checkpoint)."""
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    K, d = 8, 3
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(14), K, d, me=1, ni=2, p=2, mc=1)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10, miter=25)
    mesh = _mesh(8)
    fn = make_block_solver(spec, mesh, cfg)

    straight = fn(x0, theta, ccdata=ccdata)
    assert int(straight.signal) == 1

    st = fn.init_state(x0, theta, ccdata=ccdata)
    st = fn.run_budget(st, theta, ccdata=ccdata, max_new_iters=3)
    assert int(st.signal) == 0          # paused mid-solve
    # checkpoint round-trip through host numpy (what utils/checkpoint
    # serializes), then restore onto the mesh and resume
    host = jax.tree.map(lambda a: np.asarray(a), st)
    st2 = jax.tree.map(lambda a: jnp.asarray(a), host)
    st2 = fn.run(st2, theta, ccdata=ccdata)
    resumed = fn.finalize(st2, theta, ccdata=ccdata)

    assert int(resumed.signal) == int(straight.signal)
    assert int(resumed.iter_count) == int(straight.iter_count)
    np.testing.assert_array_equal(np.asarray(resumed.x),
                                  np.asarray(straight.x))
    np.testing.assert_array_equal(np.asarray(resumed.lc),
                                  np.asarray(straight.lc))


def test_block_solver_trace_metrics():
    """trace_metrics=True records per-iteration history for the
    distributed solve (observability parity with the single-device core;
    utils.profiling.iteration_report renders it)."""
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )
    from pyipm_jax.utils.profiling import iteration_report

    K, d = 8, 3
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(15), K, d, me=1, ni=2, p=2, mc=1)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=8,
                    miter=20, trace_metrics=True)
    fn = make_block_solver(spec, _mesh(8), cfg)
    res = fn(x0, theta, ccdata=ccdata)
    assert int(res.signal) == 1
    n = int(res.iter_count)
    kkt = np.asarray(res.hist.kkt)
    assert kkt.shape == (cfg.niter * cfg.miter, 4)
    assert np.all(kkt[:n].sum(axis=1) > 0)
    assert np.all(kkt[n:] == 0)
    np.testing.assert_allclose(kkt[n - 1], np.asarray(res.kkt),
                               rtol=1e-12)
    report = iteration_report(res)
    assert str(n) in report.split("\n")[-1]


def test_ci_identity_fast_path_matches_general():
    """ci_identity=True (bounds fast path: Sigma on the diagonal,
    elementwise slack recovery) must reproduce the general-Jacobian path
    on the same problem."""
    from pyipm_jax.parallel.schur import BlockNLP, make_block_solver

    K, d, mc = 8, 4, 2
    key = jax.random.key(16)
    kq, kc, ka, kx = jax.random.split(key, 4)
    G = jax.random.normal(kq, (K, d, d), jnp.float64) / np.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", G, G) + jnp.eye(d, dtype=jnp.float64)
    c = jax.random.normal(kc, (K, d), jnp.float64)
    A = jax.random.normal(ka, (K, mc, d), jnp.float64) / np.sqrt(K * d)
    xfeas = jax.random.normal(kx, (K, d), jnp.float64) * 0.1
    theta = {"Q": Q, "c": c, "A": A,
             "lb": jnp.full((K, d), -2.0, jnp.float64)}
    ccdata = {"b": jnp.einsum("kcd,kd->c", A, xfeas)}
    kw = dict(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        d=d, ci_blk=lambda xk, th: xk - th["lb"], ni=d,
        g_blk=lambda xk, th: th["A"] @ xk,
        cc=lambda u, ccd: u - ccd["b"], p=mc, mc=mc)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=8, miter=20)
    mesh = _mesh(8)
    x0 = jnp.zeros((K, d), jnp.float64)
    r_fast = make_block_solver(BlockNLP(ci_identity=True, **kw),
                               mesh, cfg)(x0, theta, ccdata=ccdata)
    r_gen = make_block_solver(BlockNLP(ci_identity=False, **kw),
                              mesh, cfg)(x0, theta, ccdata=ccdata)
    assert int(r_fast.signal) == int(r_gen.signal) == 1
    assert int(r_fast.iter_count) == int(r_gen.iter_count)
    np.testing.assert_allclose(np.asarray(r_fast.x), np.asarray(r_gen.x),
                               rtol=1e-10, atol=1e-12)


def test_block_coupling_inequality_parity_with_assembled():
    """Coupling INEQUALITIES cci(sum_k g_k(x_k)) >= 0 (global caps) with
    replicated slacks through the bordered Schur complement: must match
    the assembled single-device condensed solve (ci = [blocks; cci]) to
    roundoff, and the cap must bind/hold at the solution."""
    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.core.problem import Problem
    from pyipm_jax.core.solver import solve as solve_single
    from pyipm_jax.parallel.schur import BlockNLP, make_block_solver

    K, d, me, ni, pdim, mc, mci = 8, 3, 1, 2, 2, 1, 2
    key = jax.random.key(21)
    kq, kc, ke, ki, kg, kx = jax.random.split(key, 6)
    Q0 = jax.random.normal(kq, (K, d, d), jnp.float64) / np.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", Q0, Q0) + jnp.eye(d, dtype=jnp.float64)
    c = jax.random.normal(kc, (K, d), jnp.float64)
    Ce = jax.random.normal(ke, (K, me, d), jnp.float64) / np.sqrt(d)
    Ci = jax.random.normal(ki, (K, ni, d), jnp.float64) / np.sqrt(d)
    Gl = jax.random.normal(kg, (K, pdim, d), jnp.float64) / np.sqrt(K * d)
    xfeas = jax.random.normal(kx, (K, d), jnp.float64) * 0.1
    ee = jnp.einsum("kmd,kd->km", Ce, xfeas)
    di = 1.0 - jnp.einsum("knd,kd->kn", Ci, xfeas)
    theta = {"Q": Q, "c": c, "Ce": Ce, "e": ee, "Ci": Ci, "di": di,
             "G": Gl}

    def f_blk(xk, th):
        return 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk

    def ce_blk(xk, th):
        return th["Ce"] @ xk - th["e"]

    def ci_blk(xk, th):
        return th["Ci"] @ xk + th["di"]

    def g_blk(xk, th):
        return th["G"] @ xk

    ufeas = jnp.sum(jax.vmap(g_blk)(xfeas, theta), axis=0)
    ccdata = {"u0": ufeas}

    def cc(u, ccd):
        return (u - ccd["u0"])[:mc]          # eq coupling

    def cci(u, ccd):
        # NONLINEAR global caps, strictly feasible at xfeas (value 0.5)
        v = u - ccd["u0"]
        return 0.5 - jnp.stack([v[0] + 0.1 * jnp.sum(v ** 2),
                                -v[1] + 0.05 * jnp.sum(v ** 2)])

    spec = BlockNLP(f_blk=f_blk, d=d, ce_blk=ce_blk, me=me,
                    ci_blk=ci_blk, ni=ni, g_blk=g_blk, cc=cc, p=pdim,
                    mc=mc, cci=cci, mci=mci)
    cfg = Cfg(float_dtype="float64", verbosity=0, niter=10, miter=25)
    fn = make_block_solver(spec, _mesh(8), cfg)
    x0 = jnp.zeros((K, d), jnp.float64)
    res_d = fn(x0, theta, ccdata=ccdata)
    assert int(res_d.signal) == 1, np.asarray(res_d.kkt)

    # caps hold at the solution
    u = jnp.sum(jax.vmap(g_blk)(res_d.x, theta), axis=0)
    assert np.all(np.asarray(cci(u, ccdata)) >= -1e-6)

    # assembled single-device problem: coupling ineq appended to ci
    def f(x):
        return jnp.sum(jax.vmap(f_blk)(x.reshape(K, d), theta))

    def ce(x):
        xb = x.reshape(K, d)
        per = jax.vmap(ce_blk)(xb, theta).reshape(-1)
        uu = jnp.sum(jax.vmap(g_blk)(xb, theta), axis=0)
        return jnp.concatenate([per, cc(uu, ccdata)])

    def ci(x):
        xb = x.reshape(K, d)
        per = jax.vmap(ci_blk)(xb, theta).reshape(-1)
        uu = jnp.sum(jax.vmap(g_blk)(xb, theta), axis=0)
        return jnp.concatenate([per, cci(uu, ccdata)])

    prob = Problem(f=f, nvar=K * d, neq=K * me + mc,
                   nineq=K * ni + mci, ce=ce, ci=ci)
    res_s = solve_single(prob, x0.reshape(-1), cfg)   # LS init both sides
    assert int(res_s.signal) == 1, np.asarray(res_s.kkt)
    np.testing.assert_allclose(np.asarray(res_d.x).reshape(-1),
                               np.asarray(res_s.x), rtol=1e-6, atol=1e-8)
    # coupling-inequality multipliers and slacks agree with the assembled
    # solve's tail entries
    lda_s = np.asarray(res_s.lda)
    np.testing.assert_allclose(np.asarray(res_d.lci),
                               lda_s[K * me + mc + K * ni:], atol=1e-6)
    s_s = np.asarray(res_s.s)
    np.testing.assert_allclose(np.asarray(res_d.sc), s_s[K * ni:],
                               atol=1e-6)
    assert abs(int(res_d.iter_count) - int(res_s.iter_count)) <= 1


def test_block_coupling_inequality_mehrotra():
    """The Mehrotra predictor-corrector handles coupling-inequality pairs
    (centering over block + replicated slacks) and reaches the same
    KKT point."""
    from pyipm_jax.parallel.schur import BlockNLP, make_block_solver

    K, d, pdim, mci = 8, 3, 2, 1
    key = jax.random.key(22)
    kq, kc, kg, kx = jax.random.split(key, 4)
    Q0 = jax.random.normal(kq, (K, d, d), jnp.float64) / np.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", Q0, Q0) + jnp.eye(d, dtype=jnp.float64)
    c = jax.random.normal(kc, (K, d), jnp.float64)
    Gl = jax.random.normal(kg, (K, pdim, d), jnp.float64) / np.sqrt(K * d)
    xfeas = jax.random.normal(kx, (K, d), jnp.float64) * 0.1
    theta = {"Q": Q, "c": c, "G": Gl,
             "lb": jnp.full((K, d), -2.0, jnp.float64)}
    ufeas = jnp.einsum("kpd,kd->p", Gl, xfeas)
    ccdata = {"u0": ufeas}

    kw = dict(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        d=d, ci_blk=lambda xk, th: xk - th["lb"], ni=d, ci_identity=True,
        g_blk=lambda xk, th: th["G"] @ xk,
        cci=lambda u, ccd: 1.0 - (u - ccd["u0"])[:mci], mci=mci, p=pdim)
    x0 = jnp.zeros((K, d), jnp.float64)
    mesh = _mesh(8)
    r_a = make_block_solver(
        BlockNLP(**kw), mesh,
        IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                  miter=25))(x0, theta, ccdata=ccdata)
    r_m = make_block_solver(
        BlockNLP(**kw), mesh,
        IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                  miter=25, mu_strategy="mehrotra"))(
        x0, theta, ccdata=ccdata)
    assert int(r_a.signal) == 1 and int(r_m.signal) == 1
    np.testing.assert_allclose(np.asarray(r_a.x), np.asarray(r_m.x),
                               rtol=1e-5, atol=1e-6)


def test_block_coupling_inequality_only_barrier():
    """Edge: NO per-block inequalities (ni=0) but a coupling inequality —
    the barrier lives entirely in the replicated slacks (empty block
    slack arrays through FTB/centrality/merit paths)."""
    from pyipm_jax.parallel.schur import BlockNLP, make_block_solver

    K, d, pdim, mci, me = 8, 3, 2, 1, 1
    key = jax.random.key(23)
    kq, kc, ke, kg, kx = jax.random.split(key, 5)
    Q0 = jax.random.normal(kq, (K, d, d), jnp.float64) / np.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", Q0, Q0) + jnp.eye(d, dtype=jnp.float64)
    c = jax.random.normal(kc, (K, d), jnp.float64)
    Ce = jax.random.normal(ke, (K, me, d), jnp.float64) / np.sqrt(d)
    Gl = jax.random.normal(kg, (K, pdim, d), jnp.float64) / np.sqrt(K * d)
    xfeas = jax.random.normal(kx, (K, d), jnp.float64) * 0.1
    theta = {"Q": Q, "c": c, "Ce": Ce,
             "e": jnp.einsum("kmd,kd->km", Ce, xfeas), "G": Gl}
    ccdata = {"u0": jnp.einsum("kpd,kd->p", Gl, xfeas)}

    spec = BlockNLP(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        d=d, ce_blk=lambda xk, th: th["Ce"] @ xk - th["e"], me=me,
        g_blk=lambda xk, th: th["G"] @ xk,
        cci=lambda u, ccd: 1.0 - (u - ccd["u0"])[:mci], mci=mci, p=pdim)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                    miter=25)
    fn = make_block_solver(spec, _mesh(8), cfg)
    res = fn(jnp.zeros((K, d), jnp.float64), theta, ccdata=ccdata)
    assert int(res.signal) == 1, np.asarray(res.kkt)
    # block equalities and the cap both hold
    x = np.asarray(res.x)
    ceb = np.asarray(jnp.einsum("kmd,kd->km", theta["Ce"], res.x)
                     - theta["e"])
    assert np.linalg.norm(ceb.ravel()) <= 1e-4
    u = np.asarray(jnp.einsum("kpd,kd->p", theta["G"], res.x))
    assert (1.0 - (u - np.asarray(ccdata["u0"]))[:mci]).min() >= -1e-6


def test_block_ragged_masks_parity_with_assembled():
    """RAGGED per-block constraint counts (me_k, ni_k) under static
    maxima + validity masks: ONE compiled sharded program solves a fleet
    of unequal blocks and matches the assembled single-device solve that
    only ever sees the active rows.  The sampler fills inactive rows
    with junk data (violated-if-leaked), so any masking hole breaks
    parity."""
    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.core.problem import Problem
    from pyipm_jax.core.solver import solve as solve_single
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_ragged,
    )

    K, d, me, ni, p, mc = 8, 4, 2, 3, 2, 1
    spec, theta, ccdata, x0, me_counts, ni_counts = sample_block_ragged(
        jax.random.key(21), K, d, me=me, ni=ni, p=p, mc=mc)
    cfg = Cfg(float_dtype="float64", verbosity=0, niter=10, miter=25,
              linear_solver="condensed")

    fn = make_block_solver(spec, _mesh(8), cfg)
    res_d = fn(x0, theta, ccdata=ccdata)
    assert int(res_d.signal) == 1, np.asarray(res_d.kkt)

    # inactive rows pinned: multipliers exactly 0, slacks exactly 1
    ce_m = np.asarray(theta["ce_mask"])
    ci_m = np.asarray(theta["ci_mask"])
    np.testing.assert_array_equal(np.asarray(res_d.le)[ce_m == 0], 0.0)
    np.testing.assert_array_equal(np.asarray(res_d.li)[ci_m == 0], 0.0)
    np.testing.assert_array_equal(np.asarray(res_d.s)[ci_m == 0], 1.0)

    # assembled single-device problem over ONLY the active rows
    th_h = jax.tree.map(np.asarray, theta)

    def f(x):
        xb = x.reshape(K, d)
        return jnp.sum(jax.vmap(spec.f_blk)(xb, theta))

    def ce(x):
        xb = x.reshape(K, d)
        rows = [th_h["Ce"][k][:me_counts[k]] @ xb[k]
                - th_h["e"][k][:me_counts[k]] for k in range(K)]
        u = jnp.sum(jax.vmap(spec.g_blk)(xb, theta), axis=0)
        return jnp.concatenate(rows + [spec.cc(u, ccdata)])

    def ci(x):
        xb = x.reshape(K, d)
        rows = [th_h["Ci"][k][:ni_counts[k]] @ xb[k]
                + th_h["di"][k][:ni_counts[k]] for k in range(K)]
        return jnp.concatenate(rows)

    neq = int(np.sum(me_counts)) + mc
    nineq = int(np.sum(ni_counts))
    prob = Problem(f=f, nvar=K * d, neq=neq, nineq=nineq, ce=ce, ci=ci)
    res_s = solve_single(prob, x0.reshape(-1), cfg)   # LS init both sides
    assert int(res_s.signal) == 1, np.asarray(res_s.kkt)

    np.testing.assert_allclose(np.asarray(res_d.x).reshape(-1),
                               np.asarray(res_s.x), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(res_d.fval), float(res_s.fval),
                               rtol=1e-9)
    assert abs(int(res_d.iter_count) - int(res_s.iter_count)) <= 1, (
        int(res_d.iter_count), int(res_s.iter_count))
    # active multipliers line up against the assembled layout
    le_d = np.asarray(res_d.le)
    li_d = np.asarray(res_d.li)
    lda_s = np.asarray(res_s.lda)
    le_s = np.concatenate([le_d[k][:me_counts[k]] for k in range(K)])
    li_s = np.concatenate([li_d[k][:ni_counts[k]] for k in range(K)])
    np.testing.assert_allclose(le_s, lda_s[:neq - mc], atol=1e-6)
    np.testing.assert_allclose(li_s, lda_s[neq:], atol=1e-6)


def test_block_all_ones_masks_match_unmasked():
    """Masks of all-ones must reproduce the unmasked solver exactly (the
    ragged machinery is a no-op when every row is active)."""
    import dataclasses as _dc

    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    K, d, me, ni, p, mc = 8, 3, 1, 2, 2, 1
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(23), K, d, me=me, ni=ni, p=p, mc=mc)
    cfg = Cfg(float_dtype="float64", verbosity=0, niter=10, miter=25)

    res_u = make_block_solver(spec, _mesh(8), cfg)(
        x0, theta, ccdata=ccdata)

    theta_m = dict(theta)
    theta_m["ce_mask"] = jnp.ones((K, me), jnp.float64)
    theta_m["ci_mask"] = jnp.ones((K, ni), jnp.float64)
    spec_m = _dc.replace(spec, ce_mask_key="ce_mask",
                         ci_mask_key="ci_mask")
    res_m = make_block_solver(spec_m, _mesh(8), cfg)(
        x0, theta_m, ccdata=ccdata)

    assert int(res_m.signal) == int(res_u.signal) == 1
    assert int(res_m.iter_count) == int(res_u.iter_count)
    np.testing.assert_allclose(np.asarray(res_m.x), np.asarray(res_u.x),
                               rtol=1e-12, atol=1e-12)


def test_ls_init_overdetermined_branch_parity():
    """The distributed LS multiplier init's OVERDETERMINED branch
    (fewer multipliers than primal variables: normal equations over
    multipliers, Schur over coupling columns) matches the assembled
    single-device default-init solve: per-block eq only (me=1, ni=0)
    plus one coupling equality."""
    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.core.problem import Problem
    from pyipm_jax.core.solver import solve as solve_single
    from pyipm_jax.parallel.schur import BlockNLP, make_block_solver

    K, d, me, p, mc = 8, 4, 1, 2, 1
    kq, kc, ke, kg, kx = jax.random.split(jax.random.key(31), 5)
    G = jax.random.normal(kq, (K, d, d)) / np.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", G, G) + jnp.eye(d)[None]
    c = jax.random.normal(kc, (K, d))
    Ce = jax.random.normal(ke, (K, me, d)) / np.sqrt(d)
    Gl = jax.random.normal(kg, (K, p, d)) / np.sqrt(K * d)
    xf = jax.random.normal(kx, (K, d)) * 0.1
    ee = jnp.einsum("kmd,kd->km", Ce, xf)
    theta = {"Q": Q, "c": c, "Ce": Ce, "e": ee, "G": Gl}
    u0 = jnp.sum(jnp.einsum("kpd,kd->kp", Gl, xf), axis=0)
    ccdata = {"u0": u0}

    def f_blk(xk, th):
        return 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk

    def ce_blk(xk, th):
        return th["Ce"] @ xk - th["e"]

    def g_blk(xk, th):
        return th["G"] @ xk

    def cc(u, ccd):
        return (u - ccd["u0"])[:mc]

    spec = BlockNLP(f_blk=f_blk, d=d, ce_blk=ce_blk, me=me,
                    g_blk=g_blk, cc=cc, p=p, mc=mc)
    # K*me + mc = 9 multipliers << K*d = 32 primal rows: overdetermined
    cfg = Cfg(float_dtype="float64", verbosity=0, niter=10, miter=25,
              linear_solver="condensed")
    x0 = jnp.zeros((K, d))
    res_d = make_block_solver(spec, _mesh(8), cfg)(x0, theta,
                                                   ccdata=ccdata)
    assert int(res_d.signal) in (1, 2), np.asarray(res_d.kkt)

    def f(x):
        return jnp.sum(jax.vmap(f_blk)(x.reshape(K, d), theta))

    def ce(x):
        xb = x.reshape(K, d)
        per = jax.vmap(ce_blk)(xb, theta).reshape(-1)
        u = jnp.sum(jax.vmap(g_blk)(xb, theta), axis=0)
        return jnp.concatenate([per, cc(u, ccdata)])

    prob = Problem(f=f, nvar=K * d, neq=K * me + mc, nineq=0, ce=ce)
    res_s = solve_single(prob, x0.reshape(-1), cfg)   # LS init both
    assert int(res_s.signal) in (1, 2), np.asarray(res_s.kkt)
    np.testing.assert_allclose(np.asarray(res_d.x).reshape(-1),
                               np.asarray(res_s.x), rtol=1e-6, atol=1e-8)
    assert abs(int(res_d.iter_count) - int(res_s.iter_count)) <= 1
    # the eq multipliers themselves agree (LS init drove both paths)
    lda_s = np.asarray(res_s.lda)
    np.testing.assert_allclose(np.asarray(res_d.le).reshape(-1),
                               lda_s[:K * me], atol=1e-6)


def test_block_lbfgs_mode_converges_and_matches_exact():
    """Per-block compact L-BFGS mode (cfg.lbfgs > 0) for the distributed
    solver: the d^3 per-block factorization is replaced by a
    Woodbury-operator condensed solve (B_k = zeta I - W M^-1 W^T), the
    coupling border runs unchanged through the operator, and the solve
    converges to the same optimum as exact-Hessian mode — the
    distributed form of the reference's large-D escape hatch
    (reference README.md:196-207)."""
    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(11), 8, 6, me=1, ni=2, p=2, mc=1)
    cfg_e = Cfg(float_dtype="float64", verbosity=0, niter=10, miter=25)
    res_e = make_block_solver(spec, _mesh(8), cfg_e)(
        x0, theta, ccdata=ccdata)
    assert int(res_e.signal) == 1

    cfg_l = cfg_e.replace(lbfgs=6, niter=20, miter=40)
    fn = make_block_solver(spec, _mesh(8), cfg_l)
    res_l = fn(x0, theta, ccdata=ccdata)
    assert int(res_l.signal) == 1, np.asarray(res_l.kkt)
    np.testing.assert_allclose(np.asarray(res_l.x), np.asarray(res_e.x),
                               atol=1e-3)
    # quasi-Newton costs extra iterations but stays in the same ballpark
    assert int(res_l.iter_count) <= 4 * int(res_e.iter_count) + 5

    # pause/resume carries the per-block memory bit-exactly
    st = fn.init_state(x0, theta, ccdata=ccdata)
    st = fn.run_budget(st, theta, ccdata=ccdata, max_new_iters=4)
    assert int(st.signal) == 0
    host = jax.tree.map(np.asarray, st)
    st2 = jax.tree.map(jnp.asarray, host)
    st2 = fn.run(st2, theta, ccdata=ccdata)
    resumed = fn.finalize(st2, theta, ccdata=ccdata)
    assert int(resumed.iter_count) == int(res_l.iter_count)
    np.testing.assert_array_equal(np.asarray(resumed.x),
                                  np.asarray(res_l.x))


def test_block_lbfgs_box_identity_fast_path():
    """L-BFGS mode through the ci_identity (box bounds) fast path: the
    slack Sigma folds into the DIAGONAL Woodbury base instead of
    widening the low-rank correction."""
    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.parallel.schur import (
        make_separable_solver, sample_separable,
    )

    spec, data, x0 = sample_separable(jax.random.key(1), 8, 8, 3,
                                      dtype=jnp.float64)
    cfg = Cfg(float_dtype="float64", verbosity=0, lbfgs=6, niter=20,
              miter=40)
    res = make_separable_solver(spec, _mesh(8), cfg)(x0, data)
    assert int(res.signal) == 1, np.asarray(res.kkt)
    cfg_e = cfg.replace(lbfgs=0)
    res_e = make_separable_solver(spec, _mesh(8), cfg_e)(x0, data)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res_e.x),
                               atol=1e-3)


def test_block_lbfgs_combos():
    """L-BFGS mode composes with ragged per-block masks (masked secant
    pairs, pinned eq rows in the per-block Schur complement).
    mu_strategy='mehrotra' with lbfgs is rejected at CONFIG level (the
    single-device contract: predictor-corrector requires exact-Hessian
    factor reuse) — assert that stays true."""
    import pytest as _pt

    from pyipm_jax.config import IPMConfig as Cfg
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_ragged,
    )

    with _pt.raises(AssertionError, match="exact-Hessian"):
        Cfg(lbfgs=6, mu_strategy="mehrotra")

    # ragged + lbfgs
    rspec, rtheta, rccdata, rx0, me_k, ni_k = sample_block_ragged(
        jax.random.key(21), 8, d=4, me=2, ni=3, p=2, mc=1)
    cfg_r = Cfg(float_dtype="float64", verbosity=0, lbfgs=6, niter=20,
                miter=40)
    res_r = make_block_solver(rspec, _mesh(8), cfg_r)(
        rx0, rtheta, ccdata=rccdata)
    assert int(res_r.signal) in (1, 2), np.asarray(res_r.kkt)
    ce_m = np.asarray(rtheta["ce_mask"])
    ci_m = np.asarray(rtheta["ci_mask"])
    np.testing.assert_array_equal(np.asarray(res_r.le)[ce_m == 0], 0.0)
    np.testing.assert_array_equal(np.asarray(res_r.li)[ci_m == 0], 0.0)
    res_re = make_block_solver(rspec, _mesh(8), cfg_r.replace(lbfgs=0))(
        rx0, rtheta, ccdata=rccdata)
    np.testing.assert_allclose(np.asarray(res_r.x),
                               np.asarray(res_re.x), atol=1e-3)


def test_linear_coupling_declaration_matches_general_path():
    """BlockNLP.linear_coupling (the r5 collective fusion: constant
    border Jacobians, zero border Hessian, pooled-feature/Schur-border/
    first-bordered-solve psums fused into one, deferred coupling rhs)
    must be a pure PERFORMANCE declaration: for a genuinely affine
    cc(u), the fused and general paths produce the same solve to
    roundoff."""
    import dataclasses

    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    K, d = 8, 4
    # nonlinear_cc=False builds an affine cc AND sets linear_coupling
    spec_lin, theta, ccdata, x0 = sample_block_general(
        jax.random.key(21), K, d, me=1, ni=2, p=2, mc=1,
        nonlinear_cc=False)
    assert spec_lin.linear_coupling
    spec_gen = dataclasses.replace(spec_lin, linear_coupling=False)
    for strat in ("adaptive", "mehrotra"):
        cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                        miter=25, mu_strategy=strat)
        r_lin = make_block_solver(spec_lin, _mesh(8), cfg)(
            x0, theta, ccdata=ccdata)
        r_gen = make_block_solver(spec_gen, _mesh(8), cfg)(
            x0, theta, ccdata=ccdata)
        assert int(r_lin.signal) == 1 and int(r_gen.signal) == 1
        assert int(r_lin.iter_count) == int(r_gen.iter_count), strat
        np.testing.assert_allclose(np.asarray(r_lin.x),
                                   np.asarray(r_gen.x),
                                   rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(np.asarray(r_lin.lc),
                                   np.asarray(r_gen.lc),
                                   rtol=1e-7, atol=1e-8)


def test_refinement_knob_configs_solve_correctly():
    """The collective-budget knobs (schur_refine_steps=0, unguarded
    refinement) must still SOLVE, not just compile (the census only
    lowers them): each config converges on the general coupled problem
    and lands on the same optimum as the default guarded-2-step config."""
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    K, d = 8, 3
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(31), K, d, me=1, ni=2, p=2, mc=1)
    base_cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                         miter=25)
    ref = make_block_solver(spec, _mesh(8), base_cfg)(
        x0, theta, ccdata=ccdata)
    assert int(ref.signal) == 1
    for kw in ({"schur_refine_steps": 0},
               {"schur_refine_steps": 1, "schur_refine_guard": False},
               {"schur_refine_steps": 3}):
        cfg = base_cfg.replace(**kw)
        r = make_block_solver(spec, _mesh(8), cfg)(
            x0, theta, ccdata=ccdata)
        assert int(r.signal) == 1, (kw, np.asarray(r.kkt))
        np.testing.assert_allclose(np.asarray(r.x), np.asarray(ref.x),
                                   rtol=0, atol=5e-4, err_msg=str(kw))


@pytest.mark.slow
@pytest.mark.parametrize("combo", [
    dict(me=0, ni=2, p=2, mc=1, mci=0),
    dict(me=2, ni=0, p=2, mc=1, mci=1),
    dict(me=1, ni=3, p=3, mc=2, mci=1),
    dict(me=2, ni=2, p=2, mc=0, mci=2),
    dict(me=1, ni=2, p=2, mc=1, mci=0, strategy="mehrotra"),
    dict(me=1, ni=2, p=2, mc=2, mci=1, strategy="mehrotra"),
])
def test_block_general_combo_fuzz(combo):
    """Cross-product fuzz over constraint-class combinations (the r5
    collective surgery touched every reduction path): each combo must
    converge with all four global KKT norms <= Ktol and satisfy its
    per-block and coupling constraints."""
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    combo = dict(combo)
    strategy = combo.pop("strategy", "adaptive")
    K, d = 8, 3
    seed = 100 + sum(v * (i + 2) for i, v in enumerate(combo.values()))
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(seed), K, d, **combo)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=12,
                    miter=30, mu_strategy=strategy)
    res = make_block_solver(spec, _mesh(8), cfg)(x0, theta,
                                                 ccdata=ccdata)
    kkt = np.asarray(res.kkt)
    assert int(res.signal) in (1, 2), (combo, strategy, kkt)
    assert np.all(kkt <= cfg.Ktol * (1 + 1e-9)), (combo, kkt)
    x = jnp.asarray(np.asarray(res.x))
    if combo["me"]:
        ceb = np.asarray(jax.vmap(spec.ce_blk)(x, theta))
        assert np.linalg.norm(ceb.ravel()) <= 5e-4
    if combo["ni"]:
        cib = np.asarray(jax.vmap(spec.ci_blk)(x, theta))
        assert np.all(cib >= -1e-6)
    if combo["mc"] or combo["mci"]:
        u = jnp.sum(jax.vmap(spec.g_blk)(x, theta), axis=0)
        if combo["mc"]:
            assert np.linalg.norm(np.asarray(spec.cc(u, ccdata))) <= 5e-4
        if combo["mci"]:
            assert np.all(np.asarray(spec.cci(u, ccdata)) >= -1e-5)


def test_linear_coupling_composes_with_ragged_masks():
    """The fused linear-coupling border must compose with RAGGED validity
    masks (deferred pooled-feature reduction + masked residual rows):
    declared vs undeclared solves of the ragged fleet (whose cc is
    affine) agree to roundoff."""
    import dataclasses

    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_ragged,
    )

    spec, theta, ccdata, x0, me_k, ni_k = sample_block_ragged(
        jax.random.key(41), K=8, d=4, me=2, ni=3, p=2, mc=1, seed=3)
    assert not spec.linear_coupling
    spec_lin = dataclasses.replace(spec, linear_coupling=True)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                    miter=25)
    r_gen = make_block_solver(spec, _mesh(8), cfg)(x0, theta,
                                                   ccdata=ccdata)
    r_lin = make_block_solver(spec_lin, _mesh(8), cfg)(x0, theta,
                                                       ccdata=ccdata)
    assert int(r_gen.signal) == 1 and int(r_lin.signal) == 1
    assert int(r_gen.iter_count) == int(r_lin.iter_count)
    np.testing.assert_allclose(np.asarray(r_lin.x), np.asarray(r_gen.x),
                               rtol=1e-8, atol=1e-8)
