"""Fraction-to-the-boundary stepping and the merit line search.

The reference implements fraction-to-the-boundary as a host-side
golden-section search (reference pyipm.py:1408-1436) and the merit line
search as Python control flow with try/except solves (pyipm.py:1438-1565).
Both are host-loop artifacts, not algorithmic requirements:

  - the fraction-to-the-boundary rule has a closed form (a masked min
    reduction), exact instead of golden-section-approximate;
  - the backtracking search becomes a bounded ``lax.while_loop`` with the
    abort signal carried in the loop state;
  - the second-order correction's try-square-solve/except-lstsq is replaced
    by an unconditional minimum-norm least squares (which is what the
    reference actually computes: its eq-only square solve always throws due
    to the reshape bug at pyipm.py:1525 and silently falls back to lstsq).

Everything here is jittable and vmappable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pyipm_jax.core import kkt as K
from pyipm_jax.core.problem import Problem
from pyipm_jax.ops.linalg import lstsq_minnorm


def max_step_ftb(z, dz, tau, axis=None):
    """Largest alpha in [0,1] with z + alpha*dz >= (1-tau)*z.

    Closed form of the reference's golden-section search
    (pyipm.py:1408-1436): alpha*dz_i >= -tau*z_i, binding only where
    dz_i < 0.  With ``axis`` (a mesh axis name) the minimum is reduced
    across devices with ``pmin`` — the sharded (Schur) path's global
    fraction-to-the-boundary."""
    if z.size == 0:
        return jnp.ones((), dtype=z.dtype)
    tau_ = jnp.asarray(tau, z.dtype)
    neg = dz < 0
    denom = jnp.where(neg, -dz, jnp.ones((), z.dtype))
    ratio = jnp.where(neg, tau_ * z / denom, jnp.inf)
    a = jnp.minimum(jnp.ones((), z.dtype), jnp.min(ratio))
    if axis is not None:
        a = lax.pmin(a, axis_name=axis)
    return a


def backtrack_armijo(phi_at, armijo_rhs, base, a_s_in, a_l_in, *,
                     tau, eps, chunk, max_backtrack):
    """Chunk-vectorized Armijo backtracking on the geometric trial schedule
    a_k = a_in * tau^(k+1) (reference pyipm.py:1490-1505).

    The ONE line-search kernel of the framework: the single-device solver
    core and the sharded Schur path both compose it with their own merit
    evaluations (``phi_at(a_s)`` may psum internally — collectives batch
    fine under the chunk vmap).

    The reference walks the trial sequence one merit test per host
    iteration; with tau = 0.995 that is hundreds-to-thousands of
    SEQUENTIAL evaluations, and under vmap every instance pays the batch
    maximum.  The schedule is closed-form, so each loop step evaluates a
    CHUNK of trial step lengths at once (one vmapped merit evaluation —
    elementwise + matmul work, cheap on the accelerator) and takes the first
    index where the sequential walk would have stopped.  The accepted
    alpha is bit-identical to the one-at-a-time loop.

    Sequential semantics reproduced, per trial k:
      - Armijo pass at a_k  -> accept a_k;
      - Armijo fail and shrink_k * base < eps -> abort (the reference's
        ||step|| < eps unreliable-direction exit, pyipm.py:1496);
      - else continue to k+1.

    Args:
      phi_at: merit evaluation at primal step length a_s.
      armijo_rhs: the acceptance threshold phi0 + a*eta*dphi0 (+slack).
      base: reference step norm at the input step lengths.
      a_s_in / a_l_in: entry step lengths for slacks/multipliers.

    Returns (a_s, a_l, aborted)."""
    dtype = jnp.asarray(a_s_in).dtype
    tau = jnp.asarray(tau, dtype)
    eps = jnp.asarray(eps, dtype)
    W = int(chunk)
    ks0 = jnp.arange(W, dtype=jnp.int32)

    def scan_chunk(c):
        ks = c * W + ks0
        shrink = jnp.power(tau, (ks + 1).astype(dtype))
        a_s_k = a_s_in * shrink
        a_l_k = a_l_in * shrink
        passes = jax.vmap(phi_at)(a_s_k) <= jax.vmap(armijo_rhs)(a_s_k)
        abort_k = shrink * base < eps       # step unreliable at trial k
        events = passes | abort_k
        idx = jnp.argmax(events)            # first event in the chunk
        found = jnp.any(events)
        return found, passes[idx], a_s_k[idx], a_l_k[idx]

    def cond_fn(c):
        i, found, _, _, _ = c
        return (~found) & (i * W < max_backtrack)

    def body_fn(c):
        i, _, _, _, _ = c
        found, passed, a_s, a_l = scan_chunk(i)
        return i + 1, found, passed, a_s, a_l

    _, found, passed, a_s, a_l = lax.while_loop(
        cond_fn, body_fn,
        (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.bool_),
         jnp.zeros((), jnp.bool_), a_s_in * tau, a_l_in * tau))
    aborted = found & (~passed)
    return a_s, a_l, aborted


def merit_line_search(phi_at, armijo_rhs, base, a_s_max, a_l_max,
                      try_soc, payload_zero, apply, abort, *,
                      tau, eps, chunk, max_backtrack):
    """The accept / second-order-correct / backtrack / abort policy of the
    merit line search (reference IPM.search, pyipm.py:1438-1565), generic
    over the state representation.  The single-device solver core and the
    sharded Schur path both instantiate THIS engine — one line-search
    implementation framework-wide.

    Args:
      phi_at(a_s): merit value at primal step length a_s (may psum).
      armijo_rhs(a): acceptance threshold phi0 + a*eta*dphi0 (+slack).
      base: step norm at the entry step lengths (abort test reference).
      a_s_max / a_l_max: fraction-to-the-boundary step lengths.
      try_soc(a_s) -> (accepted, payload): evaluate the second-order
        correction at step a_s; must return (False, payload_zero-like)
        when not applicable (e.g. infeasibility did not increase).
      payload_zero: SOC payload prototype for the non-SOC branches.
      apply(a_s, a_l, soc, payload) -> out: build the accepted state.
      abort() -> out: the unreliable-direction (-2) outcome.

    Control flow (reference pyipm.py:1462-1551): Armijo at the full step;
    on failure attempt the SOC; otherwise backtrack on the geometric
    schedule via :func:`backtrack_armijo`; abort when the trial step
    shrinks below machine precision."""
    pass0 = phi_at(a_s_max) <= armijo_rhs(a_s_max)
    false_ = jnp.zeros((), jnp.bool_)

    def accept_full(_):
        return apply(a_s_max, a_l_max, false_, payload_zero)

    def on_fail(_):
        accepted, payload = try_soc(a_s_max)

        def corrected(_):
            return apply(a_s_max, a_l_max, jnp.ones((), jnp.bool_), payload)

        def backtracked(_):
            a_s, a_l, aborted = backtrack_armijo(
                phi_at, armijo_rhs, base, a_s_max, a_l_max,
                tau=tau, eps=eps, chunk=chunk, max_backtrack=max_backtrack)
            return lax.cond(aborted,
                            lambda _: abort(),
                            lambda _: apply(a_s, a_l, false_, payload_zero),
                            None)

        return lax.cond(accepted, corrected, backtracked, None)

    return lax.cond(pass0, accept_full, on_fail, None)


class SearchResult(NamedTuple):
    x: jnp.ndarray
    s: jnp.ndarray
    lda: jnp.ndarray
    signal: jnp.ndarray      # -2 on unreliable direction, else unchanged
    alpha: jnp.ndarray       # accepted primal step length
    soc: jnp.ndarray         # bool: second-order correction accepted


def search(problem: Problem, cfg, x0, s0, lda0, dz, alpha_smax, alpha_lmax,
           mu, nu, signal):
    """Backtracking merit line search with second-order correction
    (reference IPM.search, pyipm.py:1438-1565).

    Returns updated (x, s, lda) and the (possibly -2) abort signal; on abort
    the original iterates are returned unchanged (pyipm.py:1502-1503).
    """
    D, M, N = problem.nvar, problem.neq, problem.nineq
    dtype = x0.dtype
    eps = jnp.asarray(cfg.eps, dtype)
    eta = jnp.asarray(cfg.eta, dtype)
    tau = jnp.asarray(cfg.tau, dtype)

    dx = dz[:D]
    ds = dz[D:D + N]
    dl = dz[D + N:]

    phi0 = K.phi(problem, x0, s0, mu, nu)
    dphi0 = K.dphi(problem, x0, s0, dz[:D + N], mu, nu)

    # Roundoff-aware Armijo slack: once the required decrease a*eta*dphi0
    # falls below the floating-point resolution of phi itself, the strict
    # test (reference pyipm.py:1462) compares pure noise and the search
    # aborts with signal=-2.  Accepting within ~10 ulps of phi0 is the
    # standard low-precision fix; at f64 the slack (~1e-14*|phi0|) is
    # far below Ktol-relevant scales and preserves reference behavior.
    slack = 10.0 * eps * (1.0 + jnp.abs(phi0))

    def armijo_rhs(a):
        return phi0 + a * eta * dphi0 + slack

    def phi_at(a_s):
        return K.phi(problem, x0 + a_s * dx, s0 + a_s * ds, mu, nu)

    false_ = jnp.zeros((), jnp.bool_)

    def try_soc(a_s):
        """Second-order feasibility correction (pyipm.py:1464-1489 for the
        inequality case, 1516-1536 for the equality-only case).

        Returns (accepted, dz_p, alpha_corr)."""
        xa = x0 + a_s * dx
        sa = s0 + a_s * ds
        c_old = K.con(problem, x0, s0)
        c_new = K.con(problem, xa, sa)
        infeas_up = jnp.sum(jnp.abs(c_new)) > jnp.sum(jnp.abs(c_old))

        def do_soc(_):
            A = K.jaco(problem, x0).T        # (M+N, D+N)
            dz_p = -lstsq_minnorm(A, c_new)  # (D+N,)
            rhs = armijo_rhs(a_s)
            ok1 = K.phi(problem, xa + dz_p[:D], sa + dz_p[D:], mu, nu) <= rhs
            if N:
                a_corr = max_step_ftb(s0, a_s * ds + dz_p[D:], tau)
                ok2 = K.phi(problem,
                            x0 + a_corr * (a_s * dx + dz_p[:D]),
                            s0 + a_corr * (a_s * ds + dz_p[D:]),
                            mu, nu) <= rhs
                accepted = ok1 & ok2
            else:
                a_corr = jnp.ones((), dtype)
                accepted = ok1
            return accepted, dz_p, a_corr

        def no_soc(_):
            return false_, jnp.zeros((D + N,), dtype), jnp.ones((), dtype)

        return lax.cond(infeas_up, do_soc, no_soc, None)

    # ------------------------------------------------------------------
    # instantiate the shared policy engine (one line-search implementation
    # framework-wide; the Schur path instantiates the same engine)
    if N:
        base = jnp.sqrt(jnp.linalg.norm(alpha_smax * dx) ** 2 +
                        jnp.linalg.norm(alpha_lmax * ds) ** 2)
    else:
        base = jnp.linalg.norm(alpha_smax * dx)

    payload_zero = (jnp.zeros((D + N,), dtype), jnp.ones((), dtype))

    def try_soc_engine(a_s):
        if not problem.ncon:
            return false_, payload_zero
        accepted, dz_p, a_corr = try_soc(a_s)
        return accepted, (dz_p, a_corr)

    def apply(a_s, a_l, soc, payload):
        # soc: x = x0 + a_corr*(a_s dx + dz_p) (pyipm.py:1506-1512);
        # else: x = x0 + a_s dx  (a_corr == 1, dz_p == 0 in payload_zero,
        # and the where() masks any SOC payload on non-SOC branches)
        dz_p, a_corr = payload
        one = jnp.ones((), dtype)
        corr = jnp.where(soc, a_corr, one)
        gate = jnp.where(soc, one, jnp.zeros((), dtype))
        x = x0 + corr * (a_s * dx + gate * dz_p[:D])
        s = s0 + corr * (a_s * ds + gate * dz_p[D:])
        lda = lda0 + a_l * dl if problem.ncon else lda0
        return SearchResult(x, s, lda, signal, a_s, soc)

    def abort():
        sig = jnp.asarray(-2, signal.dtype)
        return SearchResult(x0, s0, lda0, sig, jnp.zeros((), dtype), false_)

    return merit_line_search(
        phi_at, armijo_rhs, base, alpha_smax, alpha_lmax,
        try_soc_engine, payload_zero, apply, abort,
        tau=cfg.tau, eps=cfg.eps, chunk=cfg.backtrack_chunk,
        max_backtrack=cfg.max_backtrack)
