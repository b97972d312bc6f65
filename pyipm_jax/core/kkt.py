"""KKT residuals, matrix assembly, merit function, and initializers.

Pure functions of (problem, x, s, lda, mu, nu).  This module is the JAX
equivalent of the expression-building half of the reference's ``compile``
(reference pyipm.py:564-851): composite constraints, composite Jacobian,
Lagrangian gradient, merit phi/dphi, initializers, barrier-objective
gradient, and the primal-dual KKT matrix.

Layout of the composite residual/search vector (reference pyipm.py:654-668):

    r = [ df - dce.lda_e - dci.lda_i   (D)     dL/dx
          lda_i - mu/(s+eps)           (N)     dL/ds (scaled barrier)
          ce(x)                        (M)     primal feasibility, eq
          ci(x) - s                    (N) ]   primal feasibility, ineq
"""

from __future__ import annotations

import jax.numpy as jnp

from pyipm_jax.core.problem import Problem


def _eps_of(x):
    """Slack-denominator guard for mu/s terms.

    The reference adds machine eps (pyipm.py:498, 625, 666, 700, ...),
    which is invisible in float64 but catastrophic in float32: near
    convergence active-constraint slacks shrink to ~mu (1e-8 and below),
    so eps(f32) ≈ 1.2e-7 DOMINATES s, corrupting Sigma and the barrier
    gradient and stalling the stationarity residual around 1e-3.  We guard
    only against literal division by zero with sqrt(tiny)
    (≈1e-19 in f32, ≈1e-154 in f64) — indistinguishable from the
    reference in f64, correct in f32."""
    return jnp.sqrt(jnp.finfo(x.dtype).tiny)


# ----------------------------------------------------------------------
# composite constraints & Jacobian
def con(problem: Problem, x, s):
    """Composite constraints [ce(x); ci(x) - s], shape (M+N,)
    (reference pyipm.py:564-579)."""
    parts = []
    if problem.neq:
        parts.append(problem.ce_val(x))
    if problem.nineq:
        parts.append(problem.ci_val(x) - s)
    if not parts:
        return jnp.zeros((0,), dtype=x.dtype)
    return jnp.concatenate(parts)


def jaco(problem: Problem, x):
    """Composite constraint Jacobian, shape (D+N, M+N)
    (reference pyipm.py:581-607):

        [ dce  dci ]      top D rows
        [  0   -I  ]      bottom N (slack) rows
    """
    D, M, N = problem.nvar, problem.neq, problem.nineq
    J = jnp.zeros((D + N, M + N), dtype=x.dtype)
    if M:
        J = J.at[:D, :M].set(problem.jac_ce(x))
    if N:
        J = J.at[:D, M:].set(problem.jac_ci(x))
        J = J.at[D:, M:].set(-jnp.eye(N, dtype=x.dtype))
    return J


# ----------------------------------------------------------------------
# Lagrangian gradient / KKT residual
def grad(problem: Problem, x, s, lda, mu):
    """Length D+2N+M residual vector (reference pyipm.py:609-668)."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    eps = _eps_of(x)
    gx = problem.grad_f(x)
    if M:
        gx = gx - problem.jac_ce(x) @ lda[:M]
    if N:
        gx = gx - problem.jac_ci(x) @ lda[M:]
    parts = [gx]
    if N:
        parts.append(lda[M:] - mu / (s + eps))
    if M:
        parts.append(problem.ce_val(x))
    if N:
        parts.append(problem.ci_val(x) - s)
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def kkt_norms(problem: Problem, x, s, lda, mu):
    """The four first-order KKT condition norms, shape (4,).

    kkt1 = ||dL/dx||, kkt2 = ||s*(lda_i - mu/s)|| (complementarity, the *s
    scaling is at reference pyipm.py:972), kkt3 = ||ce||, kkt4 = ||ci - s||.
    Absent blocks are 0 (reference pyipm.py:958-991).
    """
    D, M, N = problem.nvar, problem.neq, problem.nineq
    r = grad(problem, x, s, lda, mu)
    zero = jnp.zeros((), dtype=x.dtype)
    k1 = jnp.linalg.norm(r[:D])
    k2 = jnp.linalg.norm(r[D:D + N] * s) if N else zero
    k3 = jnp.linalg.norm(r[D + N:D + N + M]) if M else zero
    k4 = jnp.linalg.norm(r[D + N + M:]) if N else zero
    return jnp.stack([k1, k2, k3, k4])


def kkt_blocks(problem: Problem, x, s, lda, mu):
    """The four KKT condition blocks as arrays (reference IPM.KKT,
    pyipm.py:958-991); absent blocks are scalar 0."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    r = grad(problem, x, s, lda, mu)
    zero = jnp.zeros((), dtype=x.dtype)
    kkt1 = r[:D]
    kkt2 = r[D:D + N] * s if N else zero
    kkt3 = r[D + N:D + N + M] if M else zero
    kkt4 = r[D + N + M:] if N else zero
    return kkt1, kkt2, kkt3, kkt4


# ----------------------------------------------------------------------
# merit function
def phi(problem: Problem, x, s, mu, nu):
    """l1-penalty merit with log-barrier (reference pyipm.py:670-694):

        phi = f + nu*(|ce|_1 + |ci - s|_1) - mu*sum(log s)
    """
    val = problem.f_val(x)
    if problem.neq:
        val = val + nu * jnp.sum(jnp.abs(problem.ce_val(x)))
    if problem.nineq:
        val = val + nu * jnp.sum(jnp.abs(problem.ci_val(x) - s))
        val = val - mu * jnp.sum(jnp.log(s))
    return val


def dphi(problem: Problem, x, s, dz_xs, mu, nu):
    """Directional derivative bound D(phi) along dz_xs = dz[:D+N]
    (reference pyipm.py:696-721): uses the penalty *value* as the standard
    Nocedal–Wright upper bound on the directional derivative."""
    D = problem.nvar
    eps = _eps_of(x)
    val = problem.grad_f(x) @ dz_xs[:D]
    if problem.neq:
        val = val - nu * jnp.sum(jnp.abs(problem.ce_val(x)))
    if problem.nineq:
        val = val - nu * jnp.sum(jnp.abs(problem.ci_val(x) - s))
        val = val - (mu / (s + eps)) @ dz_xs[D:]
    return val


def barrier_cost_grad(problem: Problem, x, s, mu):
    """[df(x); -mu/(s+eps)] — used only for the nu update test
    (reference pyipm.py:746-763)."""
    gf = problem.grad_f(x)
    if problem.nineq:
        eps = _eps_of(x)
        return jnp.concatenate([gf, -mu / (s + eps)])
    return gf


# ----------------------------------------------------------------------
# initializers
def init_slack(problem: Problem, x, Ktol):
    """s0 = max(ci(x0), Ktol) elementwise (reference pyipm.py:732-744)."""
    c = problem.ci_val(x)
    return jnp.maximum(c, jnp.asarray(Ktol, dtype=c.dtype))


def init_lambda(problem: Problem, x, Ktol):
    """Least-squares dual estimate lda0 = pinv(jaco[:D,:]) @ df(x0)
    (reference pyipm.py:723-730), with negative inequality multipliers
    clamped to Ktol (reference pyipm.py:1612-1621)."""
    from pyipm_jax.ops.linalg import lstsq_minnorm

    D, M, N = problem.nvar, problem.neq, problem.nineq
    J = jaco(problem, x)[:D, :]
    # pinv(J) @ g is the min-norm least-squares solution of J lda = g;
    # lstsq_minnorm computes it via regularized normal equations instead
    # of pinv's SVD custom call (which serializes badly under vmap)
    lda = lstsq_minnorm(J, problem.grad_f(x))
    if N:
        li = lda[M:]
        li = jnp.where(li < 0, jnp.asarray(Ktol, dtype=li.dtype), li)
        lda = lda.at[M:].set(li)
    return lda


# ----------------------------------------------------------------------
# KKT matrix (exact-Hessian mode)
def kkt_matrix(problem: Problem, x, s, lda, mu):
    """Symmetric (D+2N+M)^2 primal-dual matrix (reference pyipm.py:816-844):

        [ d2L   0    Je   Ji ]
        [  0   Sig   0    -I ]        Sig = diag(lda_i / (s+eps))
        [ Je'   0    0     0 ]
        [ Ji'  -I    0     0 ]

    Built as the upper triangle then mirrored, exactly like the reference's
    triu + triu.T - diag/2 trick (pyipm.py:843-844), so user-supplied
    non-symmetric d2f blocks behave identically.
    """
    D, M, N = problem.nvar, problem.neq, problem.nineq
    K = D + 2 * N + M
    eps = _eps_of(x)
    H = jnp.zeros((K, K), dtype=x.dtype)
    d2L = problem.hess_lagrangian(x, lda)
    H = H.at[:D, :D].set(jnp.triu(d2L))
    if M:
        H = H.at[:D, D + N:D + N + M].set(problem.jac_ce(x))
    if N:
        H = H.at[:D, D + N + M:].set(problem.jac_ci(x))
        sig = lda[M:] / (s + eps)
        H = H.at[D:D + N, D:D + N].set(jnp.diag(sig))
        H = H.at[D:D + N, D + N + M:].set(-jnp.eye(N, dtype=x.dtype))
    return jnp.triu(H) + jnp.triu(H, 1).T
