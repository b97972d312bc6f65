"""Compact-representation L-BFGS (Byrd–Nocedal–Schnabel) for the IPM.

Re-design of the reference's L-BFGS machinery (reference pyipm.py:993-1371)
with two structural changes required for jit/vmap:

  1. **Fixed-size masked memory.**  The reference grows S/Y dynamically and
     FIFO-shifts once ``S.shape[1] > lbfgs`` (pyipm.py:1300-1326) — i.e. its
     effective memory is lbfgs+1 pairs.  Here S/Y are statically
     (D, lbfgs+1) with a valid-column counter; the compact middle matrices
     SS/L/D are recomputed from the masked arrays (m is small, the m^2*D
     matmuls are noise next to the direction solve) instead of being
     maintained incrementally.  Invalid rows/columns of every small system
     are pinned to identity so all solves stay well-posed and contribute
     exactly zero — reproducing the reference's ``ifelse(m>0, ...)`` gating
     (pyipm.py:1097, 1148, 1175) without data-dependent shapes.

  2. **Single general direction path.**  The reference's special-cased
     square-full-rank-Jacobian branch is dead on arrival (its compiled
     function's input list duplicates ``s_dev`` where ``S_dev`` belongs,
     pyipm.py:877-880, so it would error if ever triggered); the general
     Woodbury path below covers that case.

The direction math follows pyipm.py:1032-1182: for constrained problems the
approximate Hessian is Z - U M^{-1} U^T with Z = [[diag(Adiag), B],[B^T, 0]]
and is inverted with a block inverse + the Woodbury identity; for
unconstrained problems the classic compact inverse-Hessian update is applied
directly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pyipm_jax.core import kkt as K
from pyipm_jax.core.problem import Problem
from pyipm_jax.ops.linalg import _eq_reg_term


class LBFGSState(NamedTuple):
    """Fixed-size L-BFGS memory (reference lbfgs_init, pyipm.py:993-1005)."""
    zeta: jnp.ndarray        # initial-Hessian scaling
    S: jnp.ndarray           # (D, m) weight displacements
    Y: jnp.ndarray           # (D, m) gradient displacements
    count: jnp.ndarray       # i32 number of valid columns in [0, m]
    fail: jnp.ndarray        # i32 consecutive curvature failures


def lbfgs_init(nvar: int, mem: int, zeta0: float, dtype) -> LBFGSState:
    return LBFGSState(
        zeta=jnp.asarray(zeta0, dtype),
        S=jnp.zeros((nvar, mem), dtype),
        Y=jnp.zeros((nvar, mem), dtype),
        count=jnp.zeros((), jnp.int32),
        fail=jnp.zeros((), jnp.int32),
    )


def lbfgs_update(state: LBFGSState, dx, dg, *, constrained: bool,
                 eps: float, zeta0: float, fail_max: int,
                 verbose: bool = False) -> LBFGSState:
    """Memory update with curvature guard and failure reset
    (reference lbfgs_update, pyipm.py:1282-1371).  ``verbose`` emits the
    reset notice (reference verbosity > 2, pyipm.py:1366-1367)."""
    dtype = dx.dtype
    eps_ = jnp.asarray(eps, dtype)
    sqrt_eps = jnp.sqrt(eps_)
    m = state.S.shape[1]

    dgdx = dg @ dx
    if constrained:
        zeta_new = dgdx / (dx @ dx + eps_)      # pyipm.py:1293-1294
    else:
        zeta_new = dgdx / (dg @ dg + eps_)      # pyipm.py:1295-1296
    good = (dgdx > sqrt_eps) & (zeta_new > sqrt_eps)   # pyipm.py:1297

    def accept(st: LBFGSState) -> LBFGSState:
        full = st.count >= m

        def insert_shift(args):
            S, Y = args
            S = jnp.roll(S, -1, axis=1).at[:, m - 1].set(dx)
            Y = jnp.roll(Y, -1, axis=1).at[:, m - 1].set(dg)
            return S, Y, jnp.asarray(m, jnp.int32)

        def insert_grow(args):
            S, Y = args
            S = S.at[:, st.count].set(dx)
            Y = Y.at[:, st.count].set(dg)
            return S, Y, st.count + 1

        S, Y, cnt = lax.cond(full, insert_shift, insert_grow, (st.S, st.Y))
        return LBFGSState(zeta=zeta_new, S=S, Y=Y, count=cnt,
                          fail=jnp.zeros((), jnp.int32))

    def reject(st: LBFGSState) -> LBFGSState:
        return st._replace(fail=st.fail + 1)

    state = lax.cond(good, accept, reject, state)

    # full reset after too many consecutive failures (pyipm.py:1363-1368)
    def reset(st: LBFGSState) -> LBFGSState:
        if verbose:
            jax.debug.print(
                "Max failures reached, resetting storage arrays.")
        return lbfgs_init(st.S.shape[0], m, zeta0, dtype)

    do_reset = (state.fail > fail_max) & (state.count > 0)
    return lax.cond(do_reset, reset, lambda st: st, state)


# ----------------------------------------------------------------------
def _masked_mem(state: LBFGSState, constrained: bool):
    """Masked S, Y and the compact middle matrices.

    constrained:  SS = S^T S,  L = strict-lower(S^T Y),  D = diag(S^T Y)
                  (reference pyipm.py:1330-1345)
    unconstrained: SS holds Y^T Y, L holds R = upper(S^T Y)
                  (reference pyipm.py:1333-1334, 1347-1350)
    """
    m = state.S.shape[1]
    valid = (jnp.arange(m) < state.count)
    vm = valid.astype(state.S.dtype)
    Sm = state.S * vm[None, :]
    Ym = state.Y * vm[None, :]
    SY = Sm.T @ Ym
    Dv = jnp.diagonal(SY)
    if constrained:
        SS = Sm.T @ Sm
        Lm = jnp.tril(SY, -1)
    else:
        SS = Ym.T @ Ym
        Lm = jnp.triu(SY)
        # pin invalid diagonal of R to 1 so triangular solves stay well-posed
        Lm = Lm + jnp.diag((~valid).astype(Sm.dtype))
    return Sm, Ym, SS, Lm, Dv, valid


def _padded_middle(SS, Lm, Dv, valid, zeta):
    """Minv = [[zeta*SS, L],[L^T, -D]] with invalid rows/cols pinned to the
    identity (reference builds it at the true size, pyipm.py:1086-1089)."""
    m = valid.shape[0]
    top = jnp.concatenate([zeta * SS, Lm], axis=1)
    bot = jnp.concatenate([Lm.T, -jnp.diag(Dv)], axis=1)
    Minv = jnp.concatenate([top, bot], axis=0)
    pad = jnp.concatenate([~valid, ~valid]).astype(SS.dtype)
    return Minv + jnp.diag(pad)


def lbfgs_direction(problem: Problem, cfg, state: LBFGSState,
                    x, s, lda, g, mu):
    """Search direction dz for the current memory (reference lbfgs_builder,
    pyipm.py:1007-1182, and lbfgs_dir, pyipm.py:1184-1246).

    ``g`` is the NEGATED composite gradient (the reference passes
    g = -grad, pyipm.py:1637, 1717)."""
    D, M, N = problem.nvar, problem.neq, problem.nineq
    dtype = x.dtype
    constrained = problem.ncon > 0
    zeta = state.zeta

    if not constrained:
        # classic compact inverse-Hessian application (pyipm.py:1149-1175)
        Sm, Ym, YY, R, Dv, valid = _masked_mem(state, constrained=False)
        Hg = zeta * g
        W = jnp.concatenate([Sm, zeta * Ym], axis=1)          # (D, 2m)
        WT_g = W.T @ g
        m = Sm.shape[1]
        B = -jnp.linalg.solve(R, WT_g[:m])
        A = (-jnp.linalg.solve(R.T, (jnp.diag(Dv) + zeta * YY) @ B)
             - jnp.linalg.solve(R.T, WT_g[m:]))
        return Hg + W @ jnp.concatenate([A, B])

    # constrained: block inverse of Z + Woodbury correction (pyipm.py:1099-1148)
    eps_ = jnp.asarray(cfg.eps, dtype)
    guard = jnp.sqrt(jnp.finfo(dtype).tiny)   # see kkt._eps_of
    Sm, Ym, SS, Lm, Dv, valid = _masked_mem(state, constrained=True)
    sigma = lda[M:] / (s + guard) if N else jnp.zeros((0,), dtype)
    Adiag = jnp.concatenate([zeta * jnp.ones((D,), dtype), sigma])  # (D+N,)
    B = K.jaco(problem, x)                                   # (D+N, M+N)
    g1 = g[:D + N]
    g2 = g[D + N:]

    BT_invA = B.T / Adiag[None, :]                           # (M+N, D+N)
    BT_invA_B = BT_invA @ B                                  # (M+N, M+N)

    if M:
        # regularize an ill-conditioned eq block (pyipm.py:1106-1113).
        # The reference's rcond test is a dense eigendecomposition EVERY
        # iteration; an unpivoted LDL^T gives the same min|.|/max|.| signal
        # from the pivots (Sylvester congruence — the block is
        # Je^T diag(1/Adiag) Je, PSD, so unpivoted is stable) at
        # factorization cost instead of eigensolver cost.
        from pyipm_jax.ops.linalg import ldlt_factor as _ldlt

        _, dpiv = _ldlt(BT_invA_B[:M, :M], block=cfg.ldlt_block)
        ad = jnp.abs(dpiv)
        rcond = jnp.min(ad) / jnp.maximum(jnp.max(ad), jnp.finfo(dtype).tiny)
        finite = jnp.all(jnp.isfinite(dpiv))
        reg = _eq_reg_term(mu, cfg.reg_coef, cfg.eta, cfg.beta, dtype)
        bump = jnp.where((rcond <= eps_) | (~finite), reg,
                         jnp.zeros((), dtype))
        BT_invA_B = BT_invA_B.at[:M, :M].add(bump * jnp.eye(M, dtype=dtype))

    # factor the (M+N, M+N) block ONCE for the three solves below (the
    # reference re-solves from scratch each time, pyipm.py:1115-1148)
    _lu, _piv = jax.scipy.linalg.lu_factor(BT_invA_B)

    def _solve_mid(rhs):
        return jax.scipy.linalg.lu_solve((_lu, _piv), rhs)

    v00 = BT_invA @ g1
    v01 = _solve_mid(v00)
    v02 = g1 / Adiag - BT_invA.T @ v01
    v03 = -_solve_mid(g2)
    v04 = -BT_invA.T @ v03
    Zg = jnp.concatenate([v02 + v04, v01 + v03])             # (D+2N+M,)

    m = Sm.shape[1]
    W = jnp.concatenate([zeta * Sm, Ym], axis=1)             # (D, 2m)
    if N:
        W = jnp.concatenate([W, jnp.zeros((N, 2 * m), dtype)], axis=0)

    BT_gmaW = (B.T @ W) / zeta
    X00 = -_solve_mid(BT_gmaW)                               # (M+N, 2m)
    X01 = W / zeta + BT_invA.T @ X00                         # (D+N, 2m)
    X02 = W.T @ X01                                          # (2m, 2m)
    Minv = _padded_middle(SS, Lm, Dv, valid, zeta)
    v10 = W.T @ Zg[:D + N]
    v11 = jnp.linalg.solve(X02 - Minv, v10)
    X10 = jnp.concatenate([X01, -X00], axis=0)               # (D+2N+M, 2m)
    return Zg - X10 @ v11
