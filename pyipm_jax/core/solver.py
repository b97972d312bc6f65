"""The interior-point solver core: a pure jittable iteration.

This is the accelerator-resident re-design of the reference's host-side
solver loop (reference IPM.solve, pyipm.py:1567-1863).  The reference runs Python
``for`` loops on the host, crossing the host/device boundary at every
compiled-function call; here the ENTIRE solve — outer/inner iterations,
convergence tests, inertia correction, line search, mu/nu updates — is a
nested ``lax.while_loop`` over an immutable :class:`SolverState` pytree.
Consequences:

  - one XLA compilation, zero per-iteration host round-trips;
  - the solver is ``vmap``-able (thousands of instances in lockstep, each
    with its own convergence state — while_loop under vmap masks finished
    instances automatically) and shardable with ``jax.sharding``;
  - the state pytree doubles as the checkpoint unit (see utils/checkpoint).

Signal taxonomy (reference pyipm.py:1656, 1665, 1761, 1796, 1502):
    0 running | 1 Ktol converged | 2 Ftol converged
   -1 max iterations | -2 unreliable search direction
   -3 numerical failure: non-finite iterate (an extension — the
      in-loop NaN guard, IPMConfig.nan_guard; no reference analog)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pyipm_jax.config import IPMConfig
from pyipm_jax.core import kkt as K
from pyipm_jax.core.lbfgs import (
    LBFGSState, lbfgs_direction, lbfgs_init, lbfgs_update,
)
from pyipm_jax.core.linesearch import max_step_ftb, search
from pyipm_jax.core.problem import Problem
from pyipm_jax.core.updates import centrality_mu, nu_threshold
from pyipm_jax.ops.linalg import reg_solve_kkt


class MetricsHistory(NamedTuple):
    """Per-iteration metric traces (observability the reference lacks —
    it only prints, SURVEY.md §5).  Fixed-size buffers indexed by
    iter_count; empty (T=0) when tracing is off."""
    kkt: jnp.ndarray     # (T, 4)
    mu: jnp.ndarray      # (T,)
    nu: jnp.ndarray      # (T,)
    alpha: jnp.ndarray   # (T,)
    delta: jnp.ndarray   # (T,)


class SolverState(NamedTuple):
    """Immutable per-instance solver state — the while_loop carry and the
    checkpoint unit (the reference keeps the equivalent scattered across
    mutable ``self`` members and Aesara shared scalars, pyipm.py:363-364,
    1816-1821)."""
    x: jnp.ndarray
    s: jnp.ndarray
    lda: jnp.ndarray
    mu: jnp.ndarray
    nu: jnp.ndarray
    delta: jnp.ndarray           # inertia-correction shift, warm-started
    kkt: jnp.ndarray             # (4,) KKT condition norms
    signal: jnp.ndarray          # i32
    iter_count: jnp.ndarray      # i32 total inner iterations executed
    outer: jnp.ndarray           # i32 outer iteration index
    inner: jnp.ndarray           # i32 inner iteration index (current outer)
    inner_done: jnp.ndarray      # bool: inner loop hit its muTol exit
    in_inner: jnp.ndarray        # bool: mid-inner-loop (flat-loop phase
    #                              marker; makes the state pause/resumable
    #                              at any iteration boundary)
    f_past: jnp.ndarray          # last cost for Ftol test
    alpha: jnp.ndarray           # last accepted primal step length
    reg_retries: jnp.ndarray     # i32 cumulative inertia-correction retries
    lbfgs: LBFGSState
    x_old: jnp.ndarray           # previous iterate (L-BFGS)
    g: jnp.ndarray               # cached -grad (L-BFGS)
    hist: MetricsHistory


class SolverResult(NamedTuple):
    x: jnp.ndarray
    s: jnp.ndarray
    lda: jnp.ndarray
    fval: jnp.ndarray
    kkt: jnp.ndarray             # (4,) KKT condition norms
    signal: jnp.ndarray
    iter_count: jnp.ndarray
    outer: jnp.ndarray
    inner: jnp.ndarray
    mu: jnp.ndarray
    nu: jnp.ndarray
    delta: jnp.ndarray
    reg_retries: jnp.ndarray
    hist: MetricsHistory


# ----------------------------------------------------------------------
def _i32(v):
    return jnp.asarray(v, jnp.int32)


def _all_le(kkt, tol):
    return jnp.all(kkt <= tol)


class LoopEngine(NamedTuple):
    run: callable                # SolverState -> SolverState (to completion)
    run_budget: callable         # (SolverState, max_new_iters) -> SolverState


def make_loop_engine(cfg, *, inner_iter, f_val, centrality_stats,
                     has_ineq: bool, unconstrained: bool = False,
                     dtype) -> LoopEngine:
    """The flattened outer/inner interior-point loop over a
    :class:`SolverState` carry, generic over the iteration body.

    This is THE loop of the framework: the single-device solver
    (:func:`make_solver`) and the distributed Schur solver
    (parallel/schur.py) both instantiate it, so muTol inner exits, Ftol
    placement, the signal taxonomy, the mu schedule and pause/resume
    (``run_budget``) are implemented exactly once.  The reference nests two
    host-side loops (outer niter x inner miter, pyipm.py:1658, 1672);
    here they are FLATTENED into one while_loop whose body advances the
    solve by exactly one phase step — either the top-of-outer convergence
    check, or one inner iteration (with the outer epilogue fused into the
    step that finishes an inner loop).  Every piece of loop position lives
    in the SolverState carry (outer/inner/inner_done/in_inner), so a solve
    can be PAUSED after any bounded number of iterations and RESUMED
    bit-exactly — the mechanism behind wave-compacted batching
    (parallel/batch.py), which retires converged instances instead of
    paying the vmap straggler tax.

    Args:
      inner_iter: ``SolverState -> SolverState`` — one primal-dual
        iteration (direction, line search, residuals); must bump
        ``iter_count`` itself.
      f_val: ``SolverState -> scalar`` — the (globally reduced) objective,
        for the Ftol test.
      centrality_stats: ``SolverState -> (s_dot_li, min_s_li, n_total)``
        — globally reduced inputs of the centrality mu update
        (reference pyipm.py:1804-1814); only called when ``has_ineq``.
      has_ineq: whether the problem has inequality constraints (selects
        the reference's Ftol placement and enables the barrier schedule).
    """
    def outer_start(st: SolverState) -> SolverState:
        # top-of-outer convergence check (pyipm.py:1663-1667)
        conv = _all_le(st.kkt, jnp.asarray(cfg.Ktol, dtype))

        def on_conv(st):
            return st._replace(signal=_i32(1), outer=st.outer + 1)

        def enter(st):
            if cfg.verbosity > 0 and has_ineq:
                jax.debug.print("OUTER ITERATION {}", st.outer + 1)
            return st._replace(inner=_i32(0),
                               inner_done=jnp.zeros((), jnp.bool_),
                               in_inner=jnp.ones((), jnp.bool_))

        return lax.cond(conv, on_conv, enter, st)

    def outer_epilogue(st: SolverState) -> SolverState:
        """Everything the reference does after the inner loop exits
        (pyipm.py:1776-1814)."""
        if cfg.Ftol is not None and has_ineq:
            # per-outer Ftol test with inequality constraints
            # (pyipm.py:1776-1789)
            def ftol_chk(st):
                f_new = f_val(st)
                hit = jnp.abs(st.f_past - f_new) <= abs(cfg.Ftol)
                return st._replace(
                    signal=jnp.where(hit, _i32(2), st.signal),
                    f_past=f_new)

            st = lax.cond(st.signal != -2, ftol_chk, lambda s_: s_, st)

        # max-iterations signal at the end of the last outer iteration
        # (pyipm.py:1795-1802)
        is_last = st.outer >= cfg.niter - 1
        st = st._replace(signal=jnp.where((st.signal == 0) & is_last,
                                          _i32(-1), st.signal))

        if has_ineq and cfg.mu_strategy != "mehrotra":
            # adaptive centrality-based barrier update (pyipm.py:1804-1814;
            # shared formula, core/updates.py).  Under 'mehrotra' the
            # barrier evolves per-iteration inside the direction solve.
            def mu_upd(st):
                sl, smin, ntot = centrality_stats(st)
                mu_new = centrality_mu(sl, smin, ntot,
                                       float(np.finfo(dtype).eps),
                                       cfg.mu_floor, dtype)
                return st._replace(mu=mu_new)

            st = lax.cond(st.signal == 0, mu_upd, lambda s_: s_, st)
        return st._replace(outer=st.outer + 1,
                           in_inner=jnp.zeros((), jnp.bool_))

    def outer_epilogue_scoped(st: SolverState) -> SolverState:
        with jax.named_scope("ipm-outer-epilogue"):
            return outer_epilogue(st)

    def inner_phase(st: SolverState) -> SolverState:
        # one step of the inner loop (cond at pyipm.py:1672 + body)
        active = ((st.inner < cfg.miter) & (st.signal == 0)
                  & (~st.inner_done))

        def step(st):
            # muTol inner exit (pyipm.py:1676-1682)
            muTol = jnp.maximum(jnp.asarray(cfg.Ktol, dtype), st.mu)
            conv = _all_le(st.kkt, muTol)

            def on_conv(st):
                # fully UNCONSTRAINED solves have mu pinned at Ktol, so the
                # muTol exit IS Ktol convergence — set signal=1 here;
                # constrained solves re-check at the next outer top
                if unconstrained:
                    st = st._replace(signal=_i32(1))
                return st._replace(inner_done=jnp.ones((), jnp.bool_))

            def on_run(st):
                st = inner_iter(st)
                return st._replace(inner=st.inner + 1)

            return lax.cond(conv, on_conv, on_run, st)

        st = lax.cond(active, step, lambda s_: s_, st)

        # inner loop finished (by muTol exit, miter, or a signal) -> fuse
        # the outer epilogue into this same step
        done = (st.inner >= cfg.miter) | (st.signal != 0) | st.inner_done
        return lax.cond(done, outer_epilogue_scoped, lambda s_: s_, st)

    def flat_body(st: SolverState) -> SolverState:
        return lax.cond(st.in_inner, inner_phase, outer_start, st)

    def run(st: SolverState) -> SolverState:
        def cond_fn(st):
            return (st.outer < cfg.niter) & (st.signal == 0)

        return lax.while_loop(cond_fn, flat_body, st)

    def run_budget(st: SolverState, max_new_iters) -> SolverState:
        """Advance the solve by at most ``max_new_iters`` additional inner
        iterations, then pause.  The returned state resumes exactly (call
        again, or finish with ``run``); ``signal == 0`` means paused."""
        limit = st.iter_count + jnp.asarray(max_new_iters, jnp.int32)

        def cond_fn(c):
            st, lim = c
            return ((st.outer < cfg.niter) & (st.signal == 0)
                    & (st.iter_count < lim))

        def body_fn(c):
            st, lim = c
            return flat_body(st), lim

        st, _ = lax.while_loop(cond_fn, body_fn, (st, limit))
        return st

    return LoopEngine(run=run, run_budget=run_budget)


def make_solver(problem: Problem, config: Optional[IPMConfig] = None, *,
                with_s0: bool = False, with_lda0: bool = False,
                jit: bool = True):
    """Build a solve function for (problem, config).

    Returns ``solve_fn`` with signature ``(x0[, s0][, lda0]) -> SolverResult``
    (the optional arguments are present iff the corresponding ``with_*``
    flag is set).  The returned function is jitted end-to-end and safe to
    ``vmap`` over a leading batch axis of its inputs.
    """
    cfg = config if config is not None else IPMConfig()
    if cfg.np_dtype == np.float64 and not jax.config.jax_enable_x64:
        # The reference dictates precision globally through THEANO_FLAGS
        # (pyipm.py:1903-1917); the JAX analog is the x64 flag.
        jax.config.update("jax_enable_x64", True)

    D, M, N = problem.nvar, problem.neq, problem.nineq
    cfg = cfg.resolve_mu_strategy(N)    # 'auto' -> mehrotra if compatible
    ncon = M + N
    Ktot = problem.ntot
    dtype = cfg.np_dtype
    eps = cfg.eps
    tiny = float(np.finfo(dtype).tiny)

    # ------------------------------------------------------------------
    def direction_exact(st: SolverState):
        """g = -grad; Hc = reghess(hess); dz = solve(Hc, g)
        (reference pyipm.py:1717-1721).  The default 'condensed' method
        computes the identical Newton step from the slack-eliminated
        (D+M)^2 system (ops/condensed.py); 'ldlt'/'lu' factor the full
        (D+2N+M)^2 matrix like the reference."""
        if cfg.linear_solver == "condensed":
            if cfg.mu_strategy == "mehrotra" and N:
                from pyipm_jax.ops.condensed import (
                    condensed_direction_mehrotra,
                )

                dz, mu_new, delta_new, retries = \
                    condensed_direction_mehrotra(
                        problem, cfg, st.x, st.s, st.lda, st.mu,
                        st.delta, cfg.mu_floor)
                return dz, st._replace(
                    mu=mu_new, delta=delta_new,
                    reg_retries=st.reg_retries + retries)

            from pyipm_jax.ops.condensed import condensed_direction

            dz, delta_new, retries = condensed_direction(
                problem, cfg, st.x, st.s, st.lda, st.mu, st.delta)
            return dz, st._replace(delta=delta_new,
                                   reg_retries=st.reg_retries + retries)
        g = -K.grad(problem, st.x, st.s, st.lda, st.mu)
        H = K.kkt_matrix(problem, st.x, st.s, st.lda, st.mu)
        dz, delta_new, retries = reg_solve_kkt(
            H, g, st.delta, st.mu,
            nvar=D, neq=M, nineq=N, eps=eps, reg_coef=cfg.reg_coef,
            eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
            max_retries=cfg.max_reg_retries, method=cfg.linear_solver,
            block=cfg.ldlt_block,
        )
        st = st._replace(delta=delta_new,
                         reg_retries=st.reg_retries + retries)
        return dz, st

    def direction_lbfgs(st: SolverState):
        """Memory update + compact direction (reference pyipm.py:1702-1713).
        The update is skipped only on the very first inner body of the whole
        solve (the reference's ``inner > 0 or outer > 0`` gate,
        pyipm.py:1705)."""
        not_first = (st.outer > 0) | (st.inner > 0)

        def upd(st):
            g_old = -K.grad(problem, st.x_old, st.s, st.lda, st.mu)
            g_new = -K.grad(problem, st.x, st.s, st.lda, st.mu)
            dx = st.x - st.x_old
            dg = g_old[:D] - g_new[:D]
            mem = lbfgs_update(
                st.lbfgs, dx, dg, constrained=ncon > 0, eps=eps,
                zeta0=cfg.zeta0, fail_max=cfg.lbfgs_fail_max,
                verbose=cfg.verbosity > 2)
            return st._replace(lbfgs=mem, x_old=st.x, g=g_new)

        st = lax.cond(not_first, upd, lambda s_: s_, st)
        dz = lbfgs_direction(problem, cfg, st.lbfgs, st.x, st.s, st.lda,
                             st.g, st.mu)
        return dz, st

    # ------------------------------------------------------------------
    def inner_iter(st: SolverState) -> SolverState:
        """One primal-dual iteration (the body of the reference's inner
        loop, pyipm.py:1672-1770)."""
        if cfg.verbosity > 0:
            if N:
                jax.debug.print("* INNER ITERATION {}", st.inner + 1)
            else:
                jax.debug.print("ITERATION {}", st.iter_count + 1)
        if cfg.verbosity > 1:
            jax.debug.print("f(x) = {}", problem.f_val(st.x))
        if cfg.verbosity > 2:
            jax.debug.print(
                "|dL/dx| = {}, |dL/ds| = {}, |ce| = {}, |ci-s| = {}",
                st.kkt[0], st.kkt[1], st.kkt[2], st.kkt[3])

        # phase-labeled scopes (SURVEY.md §5): --profile traces show
        # ipm/direction, ipm/line-search, ipm/kkt-residual instead of raw
        # XLA fusions
        with jax.named_scope("ipm-direction"):
            if cfg.lbfgs:
                dz, st = direction_lbfgs(st)
            else:
                dz, st = direction_exact(st)

        if ncon:
            # sign convention flip for the multiplier block (pyipm.py:1723-1725)
            dz = dz.at[D + N:].multiply(-1)

            # merit penalty update (pyipm.py:1727-1735; shared formula,
            # core/updates.py)
            nu_thres = nu_threshold(
                K.barrier_cost_grad(problem, st.x, st.s, st.mu)
                @ dz[:D + N],
                jnp.sum(jnp.abs(K.con(problem, st.x, st.s))),
                cfg.rho, tiny)
            st = st._replace(nu=jnp.maximum(st.nu, nu_thres))

        if N:
            # fraction-to-the-boundary (pyipm.py:1737-1742)
            a_s = max_step_ftb(st.s, dz[D:D + N], cfg.tau)
            a_l = max_step_ftb(st.lda[M:], dz[D + N + M:], cfg.tau)
        else:
            a_s = jnp.ones((), dtype)
            a_l = jnp.ones((), dtype)

        if cfg.inject_solve_fault:
            # fault-injection hook (SURVEY.md §5): corrupt the computed
            # direction by a deterministic relative perturbation; the
            # merit line search / signal taxonomy must absorb or flag it
            dz = dz + cfg.inject_solve_fault * jnp.roll(dz, 1)

        with jax.named_scope("ipm-line-search"):
            res = search(problem, cfg, st.x, st.s, st.lda, dz, a_s, a_l,
                         st.mu, st.nu, st.signal)
        if cfg.verbosity > 2:
            # line-search notices (reference pyipm.py:1485-1487, 1496-1500)
            lax.cond(res.soc,
                     lambda: jax.debug.print(
                         "Second-order feasibility correction accepted"),
                     lambda: None)
            lax.cond(res.signal == -2,
                     lambda: jax.debug.print(
                         "Search direction is unreliable to machine "
                         "precision."),
                     lambda: None)
        st = st._replace(x=res.x, s=res.s, lda=res.lda, signal=res.signal,
                         alpha=res.alpha, iter_count=st.iter_count + 1)
        with jax.named_scope("ipm-kkt-residual"):
            st = st._replace(
                kkt=K.kkt_norms(problem, st.x, st.s, st.lda, st.mu))

        if cfg.nan_guard:
            # in-loop sanitizer (SURVEY.md §5; absent in the reference):
            # a non-finite iterate or residual is terminal — flag it with
            # signal -3 instead of spinning the remaining budget on NaNs
            finite = (jnp.all(jnp.isfinite(st.x))
                      & jnp.all(jnp.isfinite(st.s))
                      & jnp.all(jnp.isfinite(st.lda))
                      & jnp.all(jnp.isfinite(st.kkt)))
            st = st._replace(signal=jnp.where(
                (st.signal >= 0) & ~finite, _i32(-3), st.signal))
            if cfg.verbosity > 2:
                lax.cond(st.signal == -3,
                         lambda: jax.debug.print(
                             "Non-finite iterate detected; terminating."),
                         lambda: None)

        if cfg.trace_metrics:
            t = st.iter_count - 1
            h = st.hist
            st = st._replace(hist=MetricsHistory(
                kkt=h.kkt.at[t].set(st.kkt),
                mu=h.mu.at[t].set(st.mu),
                nu=h.nu.at[t].set(st.nu),
                alpha=h.alpha.at[t].set(st.alpha),
                delta=h.delta.at[t].set(st.delta),
            ))

        if cfg.Ftol is not None and N == 0:
            # per-inner-iteration Ftol test, unconstrained/eq-only
            # (pyipm.py:1756-1766)
            f_new = problem.f_val(st.x)
            live = st.signal != -2
            hit = live & (jnp.abs(st.f_past - f_new) <= abs(cfg.Ftol))
            st = st._replace(
                signal=jnp.where(hit, _i32(2), st.signal),
                f_past=jnp.where(live, f_new, st.f_past))
        return st

    # ------------------------------------------------------------------
    # NOTE the inner-loop convergence subtlety preserved by the engine's
    # has_ineq flag: the UNCONSTRAINED/eq-only muTol exit sets signal=1
    # directly (ncon == 0 has mu pinned at Ktol, pyipm.py:1606), while the
    # inequality case re-checks at the outer level.  The shared loop (muTol
    # inner exit, Ftol placement, signals, mu schedule, pause/resume) lives
    # in :func:`make_loop_engine` — one implementation for this solver and
    # the distributed Schur solver.
    def centrality_stats(st: SolverState):
        li = st.lda[M:]
        return st.s @ li, jnp.min(st.s * li), N

    engine = make_loop_engine(
        cfg, inner_iter=inner_iter,
        f_val=lambda st: problem.f_val(st.x),
        centrality_stats=centrality_stats,
        has_ineq=N > 0, unconstrained=ncon == 0, dtype=dtype)
    run, run_budget = engine.run, engine.run_budget

    # ------------------------------------------------------------------
    def init_state(x0, s0=None, lda0=None, mu0=None, nu0=None) -> SolverState:
        """Initialization (reference pyipm.py:1596-1651).

        ``mu0``/``nu0`` override the configured initial barrier/penalty
        values at RUNTIME (no recompile across values) — the explicit
        analog of the reference's stateful warm-start semantics, where
        the device copies of mu/nu keep their final values across
        solve() calls (reference pyipm.py:273-275, 363-364).  With N == 0
        mu stays pinned at Ktol regardless (reference pyipm.py:1606)."""
        if cfg.verbosity > 0:
            # mode banner (reference pyipm.py:1642-1648)
            jax.debug.print(
                "Searching for a feasible local minimizer using "
                + ("L-BFGS to approximate the Hessian."
                   if cfg.lbfgs else "the exact Hessian."))
        x = jnp.asarray(x0, dtype).reshape((D,))
        if N:
            s = (K.init_slack(problem, x, cfg.Ktol) if s0 is None
                 else jnp.asarray(s0, dtype).reshape((N,)))
            mu0 = jnp.asarray(cfg.mu if mu0 is None else mu0, dtype)
        else:
            s = jnp.zeros((0,), dtype)
            mu0 = jnp.asarray(cfg.Ktol, dtype)    # pyipm.py:1606
        if ncon:
            lda = (K.init_lambda(problem, x, cfg.Ktol) if lda0 is None
                   else jnp.asarray(lda0, dtype).reshape((ncon,)))
        else:
            lda = jnp.zeros((0,), dtype)
        nu0 = jnp.asarray(cfg.nu if nu0 is None else nu0, dtype)
        kkt0 = K.kkt_norms(problem, x, s, lda, mu0)
        if cfg.Ftol is not None:
            f_past = problem.f_val(x)
        else:
            f_past = jnp.zeros((), dtype)
        if cfg.lbfgs:
            g0 = -K.grad(problem, x, s, lda, mu0)
        else:
            g0 = jnp.zeros((Ktot,), dtype)
        T = cfg.niter * cfg.miter if cfg.trace_metrics else 0
        hist = MetricsHistory(
            kkt=jnp.zeros((T, 4), dtype), mu=jnp.zeros((T,), dtype),
            nu=jnp.zeros((T,), dtype), alpha=jnp.zeros((T,), dtype),
            delta=jnp.zeros((T,), dtype))
        return SolverState(
            x=x, s=s, lda=lda, mu=mu0, nu=nu0,
            delta=jnp.zeros((), dtype), kkt=kkt0,
            signal=_i32(0), iter_count=_i32(0), outer=_i32(0),
            inner=_i32(0), inner_done=jnp.zeros((), jnp.bool_),
            in_inner=jnp.zeros((), jnp.bool_),
            f_past=f_past, alpha=jnp.zeros((), dtype),
            reg_retries=_i32(0),
            lbfgs=lbfgs_init(D, cfg.lbfgs_mem, cfg.zeta0, dtype),
            x_old=x, g=g0, hist=hist,
        )

    def finalize(st: SolverState) -> SolverResult:
        return SolverResult(
            x=st.x, s=st.s, lda=st.lda, fval=problem.f_val(st.x),
            kkt=st.kkt, signal=st.signal, iter_count=st.iter_count,
            outer=st.outer, inner=st.inner, mu=st.mu, nu=st.nu,
            delta=st.delta, reg_retries=st.reg_retries, hist=st.hist,
        )

    # ------------------------------------------------------------------
    def _prec(fn):
        # trace at the configured matmul precision: a reduced-precision
        # default (TF32 for float32 on the GPU) costs the factorization
        # accuracy (see IPMConfig.matmul_precision).  Applied to every
        # exposed phase function so budgeted/resumed runs are bit-identical
        # to a straight-through solve.
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return fn(*a, **kw)
        return wrapped

    init_state_p = _prec(init_state)
    run_p = _prec(run)
    run_budget_p = _prec(run_budget)
    finalize_p = _prec(finalize)

    def _full(x0, s0, lda0):
        with jax.default_matmul_precision(cfg.matmul_precision):
            return finalize(run(init_state(x0, s0, lda0)))

    if with_s0 and with_lda0:
        def solve_fn(x0, s0, lda0):
            return _full(x0, s0, lda0)
    elif with_s0:
        def solve_fn(x0, s0):
            return _full(x0, s0, None)
    elif with_lda0:
        def solve_fn(x0, lda0):
            return _full(x0, None, lda0)
    else:
        def solve_fn(x0):
            return _full(x0, None, None)

    solve_fn.init_state = init_state_p
    solve_fn.run = run_p
    solve_fn.run_budget = run_budget_p
    solve_fn.finalize = finalize_p
    solve_fn.problem = problem
    solve_fn.config = cfg
    if jit:
        wrapped = jax.jit(solve_fn)
        wrapped.init_state = init_state_p
        wrapped.run = run_p
        wrapped.run_budget = run_budget_p
        wrapped.finalize = finalize_p
        wrapped.problem = problem
        wrapped.config = cfg
        return wrapped
    return solve_fn


# ----------------------------------------------------------------------
def solve(problem: Problem, x0, config: Optional[IPMConfig] = None,
          s0=None, lda0=None) -> SolverResult:
    """One-shot functional solve (builds and caches nothing; for repeated
    solves of the same problem build the solver once with
    :func:`make_solver`)."""
    fn = make_solver(problem, config,
                     with_s0=s0 is not None, with_lda0=lda0 is not None)
    args = [x0]
    if s0 is not None:
        args.append(s0)
    if lda0 is not None:
        args.append(lda0)
    return fn(*args)
