"""Condensed KKT direction: exact elimination of the slack/ineq-multiplier
blocks before factorization.

The reference factors the full (D+2N+M)^2 primal-dual matrix every
iteration (reference pyipm.py:816-844, 1717-1721).  The slack rows are
trivially eliminable: with Sigma = diag(lda_i/(s+guard)), the Newton system

    [ W    0    Je   Ji ] [dx ]   [g1]
    [ 0   Sig   0    -I ] [ds ]   [g2]
    [ Je'  0    0     0 ] [da ] = [g3]
    [ Ji' -I    0     0 ] [db ]   [g4]

reduces EXACTLY (no inverse of Sigma required) to the (D+M)^2 system

    [ W + Ji Sig Ji' + delta*I   Je ] [dx]   [g1 + Ji (Sig g4 + g2)]
    [ Je'                         0 ] [da] = [g3]

with  ds = Ji' dx - g4  and  db = Sig ds - g2  recovered elementwise.
The eliminated 2x2 block contributes exactly N positive and N negative
eigenvalues, so the reference's inertia condition (M+N negatives on the
full matrix, pyipm.py:1381) becomes M negatives on the condensed matrix —
same delta-escalation semantics, same eq-block regularization, SAME Newton
step, at (D+M)^3/(D+2N+M)^3 of the factorization cost (166x for the
benchmark QP family), with the Ji Sig Ji' formation one matmul.
"""

from __future__ import annotations

import jax.numpy as jnp

from pyipm_jax.core import kkt as K
from pyipm_jax.core.linesearch import max_step_ftb
from pyipm_jax.core.problem import Problem
from pyipm_jax.ops.linalg import reg_solve_kkt


def condensed_direction(problem: Problem, cfg, x, s, lda, mu, delta):
    """Solve the full KKT Newton system via condensation.

    Returns (dz, delta_new, retries) with dz in the FULL composite layout
    [dx; ds; da; db] (so the surrounding solver logic — multiplier sign
    flip, fraction-to-boundary, line search — is untouched).
    """
    D, M, N = problem.nvar, problem.neq, problem.nineq
    dtype = x.dtype
    guard = jnp.sqrt(jnp.finfo(dtype).tiny)

    g = -K.grad(problem, x, s, lda, mu)
    g1 = g[:D]
    g2 = g[D:D + N]
    g3 = g[D + N:D + N + M]
    g4 = g[D + N + M:]

    d2L = problem.hess_lagrangian(x, lda)
    # same upper-triangle mirror as the full assembly (pyipm.py:843-844)
    W = jnp.triu(d2L) + jnp.triu(d2L, 1).T

    if N:
        Ji = problem.jac_ci(x)                       # (D, N)
        sig = lda[M:] / (s + guard)
        A = W + (Ji * sig[None, :]) @ Ji.T
        rhs1 = g1 + Ji @ (sig * g4 + g2)
    else:
        Ji = jnp.zeros((D, 0), dtype)
        sig = jnp.zeros((0,), dtype)
        A = W
        rhs1 = g1

    if M:
        Je = problem.jac_ce(x)                       # (D, M)
        Kc = jnp.zeros((D + M, D + M), dtype)
        Kc = Kc.at[:D, :D].set(A)
        Kc = Kc.at[:D, D:].set(Je)
        Kc = Kc.at[D:, :D].set(Je.T)
        rhs = jnp.concatenate([rhs1, g3])
    else:
        Kc = A
        rhs = rhs1

    # symmetrize exactly (A is symmetric analytically; enforce bitwise)
    Kc = (Kc + Kc.T) * jnp.asarray(0.5, dtype)

    dxa, delta_new, retries, apply_factors, applied = reg_solve_kkt(
        Kc, rhs, delta, mu,
        nvar=D, neq=M, nineq=0, eps=cfg.eps, reg_coef=cfg.reg_coef,
        eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
        max_retries=cfg.max_reg_retries, method="ldlt",
        block=cfg.ldlt_block, want_solver=True,
    )
    delta_applied, eq_applied = applied

    if M:
        Je = problem.jac_ce(x)
    else:
        Je = jnp.zeros((D, 0), dtype)

    def recover(dxa_):
        dx = dxa_[:D]
        da = dxa_[D:]
        ds = Ji.T @ dx - g4 if N else jnp.zeros((0,), dtype)
        db = sig * ds - g2 if N else jnp.zeros((0,), dtype)
        return dx, ds, da, db

    def full_residual(dx, ds, da, db):
        """Residual of the REGULARIZED (D+2N+M) Newton system via block
        matvecs — no materialized full matrix.  Refining against the full
        system matters in float32: forming Ji Sig Ji' loses digits before
        the factorization, and condensed-only refinement cannot see that
        error, costing extra outer iterations.  The applied delta/eq-reg
        shifts MUST be included: the algorithm's direction is defined by
        the shifted system (reference pyipm.py:1718-1721), and refining
        against the unshifted one would pull dz toward the wrong-inertia
        solution."""
        r1 = g1 - (W @ dx + delta_applied * dx + Je @ da + Ji @ db)
        r2 = g2 - (sig * ds - db) if N else g2
        r3 = g3 - (Je.T @ dx - eq_applied * da) if M else g3
        r4 = g4 - (Ji.T @ dx - ds) if N else g4
        return r1, r2, r3, r4

    def condensed_apply(r1, r2, r3, r4):
        """One condensed solve of the residual system against the CACHED
        factors (no refactorization)."""
        rr1 = r1 + (Ji @ (sig * r4 + r2) if N else 0.0)
        rr = jnp.concatenate([rr1, r3]) if M else rr1
        sol = apply_factors(rr)
        ex = sol[:D]
        ea = sol[D:]
        es = Ji.T @ ex - r4 if N else jnp.zeros((0,), dtype)
        eb = sig * es - r2 if N else jnp.zeros((0,), dtype)
        return ex, es, ea, eb

    dx, ds, da, db = recover(dxa)
    # full-system refinement steps, each kept only if it reduces the
    # residual (cheap: block matvecs + cached triangular solves)
    for _ in range(2):
        r = full_residual(dx, ds, da, db)
        rn0 = sum(jnp.sum(ri ** 2) for ri in r)
        ex, es, ea, eb = condensed_apply(*r)
        dx2, ds2, da2, db2 = dx + ex, ds + es, da + ea, db + eb
        r2_ = full_residual(dx2, ds2, da2, db2)
        rn1 = sum(jnp.sum(ri ** 2) for ri in r2_)
        better = rn1 < rn0
        dx = jnp.where(better, dx2, dx)
        ds = jnp.where(better, ds2, ds)
        da = jnp.where(better, da2, da)
        db = jnp.where(better, db2, db)

    dz = jnp.concatenate([dx, ds, da, db])
    return dz, delta_new, retries


def condensed_direction_mehrotra(problem: Problem, cfg, x, s, lda, mu,
                                 delta, mu_floor):
    """Mehrotra-style predictor-corrector direction (an extension;
    the reference only has the Fiacco-McCormick/centrality update at
    pyipm.py:1804-1814, applied per OUTER iteration).

    One factorization per iteration (the condensed matrix is
    mu-independent), two cached-factor solves:

      1. predictor: affine-scaling step (mu = 0 complementarity rhs);
      2. sigma = (mu_aff / mu_mean)^3 from the affine step's
         fraction-to-the-boundary progress (Mehrotra's heuristic);
      3. corrector: centered rhs at sigma*mu_mean plus the second-order
         complementarity term ds_aff o dlda_aff.

    Returns (dz, mu_new, delta_new, retries) with dz in the same pre-flip
    composite layout as :func:`condensed_direction` and ``mu_new`` the
    barrier value the iteration should adopt (also used by the merit
    line search).  Requires N > 0.
    """
    D, M, N = problem.nvar, problem.neq, problem.nineq
    assert N > 0, "Mehrotra predictor-corrector needs inequality slacks"
    dtype = x.dtype
    guard = jnp.sqrt(jnp.finfo(dtype).tiny)
    eps_s = s + jnp.asarray(K._eps_of(x), dtype)

    # ---- shared assembly (identical to condensed_direction) ----------
    d2L = problem.hess_lagrangian(x, lda)
    W = jnp.triu(d2L) + jnp.triu(d2L, 1).T
    Ji = problem.jac_ci(x)
    li = lda[M:]
    sig = li / (s + guard)
    A = W + (Ji * sig[None, :]) @ Ji.T
    if M:
        Je = problem.jac_ce(x)
        Kc = jnp.zeros((D + M, D + M), dtype)
        Kc = Kc.at[:D, :D].set(A)
        Kc = Kc.at[:D, D:].set(Je)
        Kc = Kc.at[D:, :D].set(Je.T)
    else:
        Je = jnp.zeros((D, 0), dtype)
        Kc = A
    Kc = (Kc + Kc.T) * jnp.asarray(0.5, dtype)

    # residual blocks shared by both rhs (only g2 differs with mu)
    g = -K.grad(problem, x, s, lda, jnp.zeros((), dtype))   # affine: mu=0
    g1 = g[:D]
    g2_aff = g[D:D + N]
    g3 = g[D + N:D + N + M]
    g4 = g[D + N + M:]

    def condensed_rhs(g2):
        rr1 = g1 + Ji @ (sig * g4 + g2)
        return jnp.concatenate([rr1, g3]) if M else rr1

    # ---- factor once, with the affine rhs ----------------------------
    dxa, delta_new, retries, apply_factors, applied = reg_solve_kkt(
        Kc, condensed_rhs(g2_aff), delta, mu,
        nvar=D, neq=M, nineq=0, eps=cfg.eps, reg_coef=cfg.reg_coef,
        eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
        max_retries=cfg.max_reg_retries, method="ldlt",
        block=cfg.ldlt_block, want_solver=True,
    )
    delta_applied, eq_applied = applied

    def recover(dxa_, g2, g4_):
        dx = dxa_[:D]
        da = dxa_[D:]
        ds = Ji.T @ dx - g4_
        db = sig * ds - g2
        return dx, ds, da, db

    def refine(dx, ds, da, db, g2):
        """Same guarded full-system refinement as condensed_direction."""
        def full_residual(dx, ds, da, db):
            r1 = g1 - (W @ dx + delta_applied * dx + Je @ da + Ji @ db)
            r2 = g2 - (sig * ds - db)
            r3 = g3 - (Je.T @ dx - eq_applied * da) if M else g3
            r4 = g4 - (Ji.T @ dx - ds)
            return r1, r2, r3, r4

        def apply_(r1, r2, r3, r4):
            rr1 = r1 + Ji @ (sig * r4 + r2)
            rr = jnp.concatenate([rr1, r3]) if M else rr1
            sol = apply_factors(rr)
            ex = sol[:D]
            ea = sol[D:]
            es = Ji.T @ ex - r4
            eb = sig * es - r2
            return ex, es, ea, eb

        for _ in range(2):
            r = full_residual(dx, ds, da, db)
            rn0 = sum(jnp.sum(ri ** 2) for ri in r)
            ex, es, ea, eb = apply_(*r)
            dx2, ds2, da2, db2 = dx + ex, ds + es, da + ea, db + eb
            r2_ = full_residual(dx2, ds2, da2, db2)
            rn1 = sum(jnp.sum(ri ** 2) for ri in r2_)
            better = rn1 < rn0
            dx = jnp.where(better, dx2, dx)
            ds = jnp.where(better, ds2, ds)
            da = jnp.where(better, da2, da)
            db = jnp.where(better, db2, db)
        return dx, ds, da, db

    # ---- predictor ----------------------------------------------------
    dx_a, ds_a, da_a, db_a = refine(*recover(dxa, g2_aff, g4), g2_aff)
    dli_a = -db_a                       # post-flip multiplier step
    one = jnp.ones((), dtype)
    # affine steps to the exact boundary (tau = 1)
    a_s = max_step_ftb(s, ds_a, one)
    a_l = max_step_ftb(li, dli_a, one)
    mu_mean = (s @ li) / N
    mu_aff = ((s + a_s * ds_a) @ (li + a_l * dli_a)) / N
    sigma = jnp.clip((mu_aff / (mu_mean + guard)) ** 3, 0.0, 1.0)
    mu_new = jnp.maximum(sigma * mu_mean, jnp.asarray(mu_floor, dtype))

    # ---- corrector -----------------------------------------------------
    # centered complementarity residual at mu_new plus Mehrotra's
    # second-order term: g2 = mu_new/s - li - (ds_aff o dli_aff)/s
    g2_c = g2_aff + (mu_new - ds_a * dli_a) / eps_s
    sol_c = apply_factors(condensed_rhs(g2_c))
    dx, ds, da, db = refine(*recover(sol_c, g2_c, g4), g2_c)

    dz = jnp.concatenate([dx, ds, da, db])
    return dz, mu_new, delta_new, retries
