"""Distributed interior-point solve for block-separable NLPs — the
model-parallel (TP-analog) layer the reference entirely lacks
(SURVEY.md §2, absence table).

A single LARGE structured NLP with the FULL generality of the reference's
problem class (min f s.t. ce=0, ci>=0, reference pyipm.py:29-36) in
block-separable form:

    min   sum_k f_k(x_k)                    x_k in R^d,  k = 1..K
    s.t.  ce_k(x_k)  = 0                    (me nonlinear per-block eq)
          ci_k(x_k) >= 0                    (ni nonlinear per-block ineq —
                                             bounds lb <= x <= ub are the
                                             special case [x-lb; ub-x])
          cc( sum_k g_k(x_k) )  = 0         (mc nonlinear COUPLING eq over
                                             p pooled features u = sum g_k)
          cci( sum_k g_k(x_k) ) >= 0        (mci nonlinear COUPLING ineq —
                                             global caps/budgets — with
                                             REPLICATED slacks eliminated
                                             into the border Hessian)

partitioned block-by-block across the ``model`` axis of a device mesh.

**Iteration machinery is the single-device solver's, not a copy.**  The
state is the same :class:`~pyipm_jax.core.solver.SolverState` pytree
(x/s/delta hold per-block slabs, lda holds the (le, li, lc) multiplier
triple), the outer/inner loop, muTol exits, Ftol placement, signal
taxonomy, and mu schedule come from
:func:`~pyipm_jax.core.solver.make_loop_engine`, the line search is
:func:`~pyipm_jax.core.linesearch.merit_line_search`, the scalar updates
are core/updates.py, and the per-block factorization is
:func:`~pyipm_jax.ops.linalg.batched_reg_factor` — the batched form of
the condensed path's inertia-corrected LDL^T.  The only distributed-
specific code is the DIRECTION: a Schur complement over the coupling.

**The direction.**  Per iteration, each device eliminates its local
blocks' slacks exactly as ops/condensed.py does (Sigma = li/s into the
primal block, recover ds/dlambda elementwise), factors the per-block
(d+me)^2 condensed systems M_k with inertia-corrected LDL^T, and the
coupling is reduced to a replicated (p + mc) BORDER system assembled from
``psum``s of small per-block products:

    full Hessian = blockdiag(W_k) - G^T Hu G    (exact: the coupling term
        lc.cc(u) has the rank-p cross-block Hessian G^T Hu G with
        G = [dg_k/dx_k] and Hu = d2/du2 (lc.cc)(u); W_k carries the
        per-block part including (Jcc^T lc).g_k's Hessian)

    M_k u_k = rhs_k + Ghat_k^T (Hu v - Jcc^T dlc),   v = sum_k G_k dx_k

    [ I - P Hu    P Jcc^T ] [ v  ]   [ pv  ]      P  = psum_k G_k M_k^-1 G_k^T
    [ Jcc         0       ] [ dlc] = [ g3c ]      pv = psum_k G_k M_k^-1 rhs_k

solved replicated, then back-substituted locally.  For LINEAR coupling
(cc(u) = u - b, g_k = A_k x_k) this degenerates to the classic Schur
complement S = psum A_k M_k^-1 A_k^T over the coupling constraints.  Two
guarded refinement steps against the full (regularized) system reuse the
cached factors and border LU, mirroring ops/condensed.py.  The
second-order correction is the same-matrix constraint-only resolve
(Wächter–Biegler; the reference's always-lstsq min-norm SOC does not
distribute, see core/linesearch.py).

Everything runs inside one ``shard_map`` over the mesh; control flow is
replicated (every device sees identical psum-reduced scalars), so the
whole solve is a single compiled SPMD program with XLA collectives
between the devices.

Deviations from the single-device defaults (documented):
  - per-iteration debug printing is off (it would interleave across
    devices); the final signal/kkt/iter_count report everything.
  (The r3 multiplier-default deviation is GONE: default multipliers now
  come from the reference's least-squares initializer computed through
  the coupling border — ``ls_multiplier_init`` — matching the
  single-device default without hand-fed warm starts.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P

from pyipm_jax.config import IPMConfig
from pyipm_jax.core.lbfgs import (
    LBFGSState, _masked_mem, _padded_middle, lbfgs_init, lbfgs_update,
)
from pyipm_jax.core.linesearch import max_step_ftb, merit_line_search
from pyipm_jax.core.solver import (
    MetricsHistory, SolverState, make_loop_engine,
)
from pyipm_jax.core.updates import nu_threshold
from pyipm_jax.ops.linalg import _eq_reg_term, batched_reg_factor


# ----------------------------------------------------------------------
# problem specification
@dataclasses.dataclass(frozen=True, eq=False)
class BlockNLP:
    """Static description of a general block-separable NLP.

    Every callable takes ``(x_k (d,), theta_k)`` with ``theta_k`` the
    per-block slice of the data pytree; ``cc`` takes ``(u (p,), ccdata)``
    with ``ccdata`` the replicated coupling data pytree.  Counts are
    static.  ``hess_blk`` optionally overrides the per-block Lagrangian
    Hessian ``(x_k, theta_k, le_k, li_k, w) -> (d, d)`` with
    ``w = Jcc(u)^T lc`` (the analog of the single-device derivative
    overrides, reference pyipm.py:223-225).

    **Large-d-per-block boundary** (benchmarks/bench_schur_scaling.py
    --mode dsweep; not yet measured on the H100): the per-block
    direction cost is the dense inertia-corrected (d+me)^3/3
    factorization, whose batched form loses efficiency as d grows.
    Practical guidance: keep d moderate per block and PARTITION a
    larger subsystem into more blocks (the
    coupling border handles the extra block count at negligible cost);
    the reference's own escape hatch for huge dense Hessians is L-BFGS
    (reference README.md:196-207), available in the single-device solver
    for unpartitionable problems."""
    f_blk: Callable
    d: int
    ce_blk: Optional[Callable] = None
    me: int = 0
    ci_blk: Optional[Callable] = None
    ni: int = 0
    g_blk: Optional[Callable] = None
    cc: Optional[Callable] = None
    p: int = 0
    mc: int = 0
    # coupling INEQUALITY constraints cci(sum_k g_k(x_k), ccdata) >= 0
    # (e.g. global resource caps) — handled with REPLICATED slacks and
    # multipliers through the same bordered Schur complement
    cci: Optional[Callable] = None
    mci: int = 0
    hess_blk: Optional[Callable] = None
    # declare ci_blk's Jacobian to be the IDENTITY (lower bounds
    # ci = x - lb): the direction then adds Sigma to the diagonal and
    # recovers slacks elementwise instead of paying d^3-sized identity
    # einsums per block — a factorization-sized saving at large d
    ci_identity: bool = False
    # RAGGED per-block constraint counts (me_k <= me, ni_k <= ni): name a
    # theta key holding a (K, me) / (K, ni) {0,1} validity mask.  ``me``/
    # ``ni`` become static MAXIMA; inactive rows are masked out of every
    # residual/Jacobian/reduction and their KKT rows are identity-pinned
    # (diagonal -1, preserving the per-block inertia target), the same
    # static-maxima + validity-mask trick as core/lbfgs.py's fixed-size
    # memory.  One compiled SPMD program then solves fleets of UNEQUAL
    # blocks — the distributed analog of the reference's per-problem
    # shape generality (reference pyipm.py:442-467).  Inactive rows'
    # multipliers/slacks are pinned (le=0, li=0, s=1) and never move.
    ce_mask_key: Optional[str] = None
    ci_mask_key: Optional[str] = None
    # declare the coupling constraints AFFINE in u (cc(u) = A u - b):
    # their Jacobians are then constant, the border Hessian is zero, and
    # the solver FUSES the pooled-feature reduction, the Schur-border
    # formation, and the first bordered solve into ONE collective per
    # iteration (and drops the coupling psum from the KKT residual) —
    # the d=16-per-block weak-scaling configs are collective-latency
    # bound (benchmarks/collective_census.py).  Wrong declarations are
    # on the caller: a nonlinear cc declared linear solves with a stale
    # Jacobian/Hessian model (like any misdeclared derivative override,
    # reference pyipm.py:223-225).
    linear_coupling: bool = False

    def __post_init__(self):
        assert (self.me > 0) == (self.ce_blk is not None)
        assert (self.ni > 0) == (self.ci_blk is not None)
        assert (self.mc > 0) == (self.cc is not None)
        assert (self.mci > 0) == (self.cci is not None)
        if self.mc or self.mci:
            assert self.g_blk is not None and self.p > 0
        if self.ci_identity:
            assert self.ni == self.d, "ci_identity needs ci = x - lb"
        assert self.ce_mask_key is None or self.me > 0
        assert self.ci_mask_key is None or self.ni > 0


class BlockResult(NamedTuple):
    x: jnp.ndarray           # (K, d)
    s: jnp.ndarray           # (K, ni) slacks
    le: jnp.ndarray          # (K, me) per-block equality multipliers
    li: jnp.ndarray          # (K, ni) per-block inequality multipliers
    lc: jnp.ndarray          # (mc,) coupling eq multipliers (replicated)
    sc: jnp.ndarray          # (mci,) coupling-inequality slacks
    lci: jnp.ndarray         # (mci,) coupling-inequality multipliers
    fval: jnp.ndarray
    kkt: jnp.ndarray         # (4,) global KKT norms
    signal: jnp.ndarray
    iter_count: jnp.ndarray
    mu: jnp.ndarray
    nu: jnp.ndarray
    hist: "MetricsHistory"   # per-iteration traces (T=0 unless
    #                          IPMConfig.trace_metrics)


def box_ci(lb_key: str = "lb", ub_key: Optional[str] = None):
    """Convenience per-block inequality for bounds: ci_k = [x - lb] or
    [x - lb; ub - x], reading the bound arrays from theta_k."""
    if ub_key is None:
        return lambda xk, th: xk - th[lb_key]
    return lambda xk, th: jnp.concatenate(
        [xk - th[lb_key], th[ub_key] - xk])


# ----------------------------------------------------------------------
def make_block_solver(spec: BlockNLP, mesh,
                      config: Optional[IPMConfig] = None,
                      axis: str = "model"):
    """Build the sharded general block-NLP solve function.

    Returns ``fn(x0 (K, d), theta, ccdata=None, s0=None, le0=None,
    li0=None, lc0=None) -> BlockResult`` jitted over ``mesh`` with
    block-sharded inputs/outputs and replicated coupling state.  K must be
    divisible by the mesh's ``axis`` size.
    """
    cfg = config if config is not None else IPMConfig(float_dtype="float32")
    cfg = cfg.resolve_mu_strategy(spec.ni + spec.mci)  # 'auto' resolution
    if cfg.verbosity > 0:
        # per-iteration debug printing inside shard_map would emit one
        # interleaved line PER DEVICE (the documented deviation above);
        # the final BlockResult reports signal/kkt/iter_count instead
        cfg = cfg.replace(verbosity=0)
    dtype = cfg.np_dtype
    d, me, ni, p, mc = spec.d, spec.me, spec.ni, spec.p, spec.mc
    mci = spec.mci
    has_barrier = ni > 0 or mci > 0
    use_mehrotra = cfg.mu_strategy == "mehrotra" and has_barrier
    # per-block compact L-BFGS mode (cfg.lbfgs > 0): the reference's
    # answer to "Hessian too big" (README.md:196-207), distributed — the
    # d^3 per-block factorization is replaced by a Woodbury solve whose
    # cost is O(d * (2m + ni)) per application, so d >> 4096 blocks
    # become viable (benchmarks/bench_schur_scaling.py --mode dsweep
    # sweeps the dense boundary)
    use_lbfgs = cfg.lbfgs > 0
    iid = bool(spec.ci_identity) and ni == d  # Ji == I: elementwise paths
    n = d + me
    eps = float(np.finfo(dtype).eps)
    tiny = float(np.finfo(dtype).tiny)
    guard = float(np.sqrt(np.finfo(dtype).tiny))  # see core.kkt._eps_of
    has_cc = mc > 0 or mci > 0     # any coupling (pooled u exists)
    # linear-coupling collective fusion (see BlockNLP.linear_coupling);
    # restricted to mci == 0: coupling-inequality residuals are needed
    # BEFORE the bordered solve whose psum would carry u
    lin_cc = has_cc and bool(spec.linear_coupling) and mci == 0
    nglob = int(np.prod([s_ for nm, s_ in
                         zip(mesh.axis_names, mesh.devices.shape)
                         if nm == axis]))

    # vmapped per-block primitives (the L1 derivative layer of
    # core/problem.py, per block).  With ragged masks declared
    # (spec.ce_mask_key / ci_mask_key), the vmapped constraint values and
    # Jacobian ROWS are multiplied by the per-block validity mask right
    # here, so every downstream consumer (residuals, merit, direction,
    # SOC, LS init) sees exact zeros for inactive rows.
    emk, imk = spec.ce_mask_key, spec.ci_mask_key

    def _em(th):                     # (Kl, me) {0,1} mask as dtype
        return th[emk].astype(dtype)

    def _im(th):                     # (Kl, ni)
        return th[imk].astype(dtype)

    f_v = jax.vmap(spec.f_blk)
    gradf_v = jax.vmap(jax.grad(spec.f_blk))
    if me:
        _ce_raw = jax.vmap(spec.ce_blk)
        _Je_raw = jax.vmap(jax.jacfwd(spec.ce_blk))      # (Kl, me, d)
        if emk:
            ce_v = lambda x, th: _ce_raw(x, th) * _em(th)   # noqa: E731
            Je_v = lambda x, th: (_Je_raw(x, th)            # noqa: E731
                                  * _em(th)[..., None])
        else:
            ce_v, Je_v = _ce_raw, _Je_raw
    if ni:
        _ci_raw = jax.vmap(spec.ci_blk)
        _Ji_raw = jax.vmap(jax.jacfwd(spec.ci_blk))      # (Kl, ni, d)
        if imk:
            ci_v = lambda x, th: _ci_raw(x, th) * _im(th)   # noqa: E731
            Ji_v = lambda x, th: (_Ji_raw(x, th)            # noqa: E731
                                  * _im(th)[..., None])
        else:
            ci_v, Ji_v = _ci_raw, _Ji_raw
    if has_cc:
        g_v = jax.vmap(spec.g_blk)
        G_v = jax.vmap(jax.jacfwd(spec.g_blk))           # (Kl, p, d)

    def lag_blk(xk, th, lek, lik, w):
        """Per-block Lagrangian with the coupling contracted through
        w = Jcc(u)^T lc held constant — its Hessian is the per-block part
        W_k of the full Hessian (the rank-p cross term G^T Hu G is
        handled by the border; see module docstring)."""
        v = spec.f_blk(xk, th)
        if me:
            v = v - lek @ spec.ce_blk(xk, th)
        if ni:
            v = v - lik @ spec.ci_blk(xk, th)
        if has_cc:
            v = v - w @ spec.g_blk(xk, th)
        return v

    if spec.hess_blk is not None:
        W_v = jax.vmap(spec.hess_blk, in_axes=(0, 0, 0, 0, None))
    else:
        W_v = jax.vmap(jax.hessian(lag_blk), in_axes=(0, 0, 0, 0, None))

    def _psum(v):
        return lax.psum(v, axis_name=axis)

    def _psum_pack(*vals):
        """Fuse several small psums into ONE collective: flatten,
        concatenate, psum once, split back to the input shapes.  The
        per-element reduction is unchanged (all-reduce is elementwise),
        so fused and unfused programs produce identical values — but the
        d=16-per-block weak-scaling config is collective-LATENCY bound,
        and this turns ~5 dependent-free
        scalar reductions per phase into one."""
        flat = [jnp.reshape(v, (-1,)) for v in vals]
        tot = _psum(jnp.concatenate(flat) if len(flat) > 1 else flat[0])
        out, off = [], 0
        for v, f in zip(vals, flat):
            out.append(jnp.reshape(tot[off:off + f.shape[0]],
                                   jnp.shape(v)))
            off += f.shape[0]
        return out

    # ------------------------------------------------------------------
    # residuals / merit on LOCAL (Kl, ...) slabs; psum for global scalars.
    # Layouts mirror core/kkt.py (reference pyipm.py:609-694) with the
    # coupling appended to the equality class.
    def coupling_state(x, th, ccdata, lc, lci, defer_u=False):
        """u (p,) replicated; eq coupling (cc(u), Jcc (mc,p)); ineq
        coupling (cci(u), Jcci (mci,p)); w = Jcc^T lc + Jcci^T lci.

        With ``defer_u`` (linear coupling only): skip the u collective —
        the u slot returns the LOCAL pooled-feature sum for the caller
        to ride on a later psum, the constraint VALUES return None, and
        the (constant) Jacobians are evaluated at u = 0."""
        if defer_u:
            assert lin_cc
            u = jnp.sum(g_v(x, th), axis=0)       # LOCAL part
            u_jac = jnp.zeros((p,), dtype)        # affine: Jac is const
            cc_val = cci_val = None
        else:
            u = _psum(jnp.sum(g_v(x, th), axis=0))
            u_jac = u
        if mc:
            Jcc = jax.jacfwd(lambda u_: spec.cc(u_, ccdata))(u_jac)
            w = Jcc.T @ lc
            if not defer_u:
                cc_val = spec.cc(u, ccdata)
        else:
            cc_val = None if defer_u else jnp.zeros((0,), dtype)
            Jcc = jnp.zeros((0, p), dtype)
            w = jnp.zeros((p,), dtype)
        if mci:
            Jcci = jax.jacfwd(lambda u_: spec.cci(u_, ccdata))(u_jac)
            w = w + Jcci.T @ lci
            if not defer_u:
                cci_val = spec.cci(u, ccdata)
        else:
            if not defer_u:
                cci_val = jnp.zeros((0,), dtype)
            Jcci = jnp.zeros((0, p), dtype)
        return u, cc_val, Jcc, cci_val, Jcci, w

    def fval_g(x, th):
        return _psum(jnp.sum(f_v(x, th)))

    def residual_blocks(x, s, sc, le, li, lc, lci, th, ccdata, mu,
                        defer_u=False):
        """(rx (Kl,d), rs (Kl,ni), rce (Kl,me), rcc (mc,), rci (Kl,ni),
        rsc (mci,), rcci (mci,), plus (u, Jcc, Jcci, w) coupling aux).
        With ``defer_u`` (linear coupling): rcc is None and the u slot
        holds the LOCAL pooled-feature sum (see coupling_state)."""
        Kl = x.shape[0]
        rx = gradf_v(x, th)
        if me:
            rx = rx - jnp.einsum("kmd,km->kd", Je_v(x, th), le)
        if ni:
            rx = rx - ((li * _im(th) if imk else li) if iid
                       else jnp.einsum("knd,kn->kd", Ji_v(x, th), li))
            rs = li - mu / (s + guard)
            rci = ci_v(x, th) - s
            if imk:
                rs = rs * _im(th)
                rci = rci * _im(th)
        else:
            rs = jnp.zeros((Kl, 0), dtype)
            rci = jnp.zeros((Kl, 0), dtype)
        rce = ce_v(x, th) if me else jnp.zeros((Kl, 0), dtype)
        if has_cc:
            u, cc_val, Jcc, cci_val, Jcci, w = coupling_state(
                x, th, ccdata, lc, lci, defer_u=defer_u)
            rx = rx - jnp.einsum("kpd,p->kd", G_v(x, th), w)
            rcc = cc_val
        else:
            u = jnp.zeros((0,), dtype)
            Jcc = jnp.zeros((0, 0), dtype)
            Jcci = jnp.zeros((0, 0), dtype)
            cci_val = jnp.zeros((0,), dtype)
            w = jnp.zeros((0,), dtype)
            rcc = jnp.zeros((0,), dtype)
        if mci:
            rsc = lci - mu / (sc + guard)
            rcci = cci_val - sc
        else:
            rsc = jnp.zeros((0,), dtype)
            rcci = jnp.zeros((0,), dtype)
        return rx, rs, rce, rcc, rci, rsc, rcci, (u, Jcc, Jcci, w)

    def kkt_norms_g(x, s, sc, le, li, lc, lci, th, ccdata, mu,
                    extras=()):
        """Global KKT norms with the four residual reductions FUSED into
        one psum.  With nonlinear coupling the coupling-state u psum is
        serially required to even evaluate the residuals (2 collectives);
        with ``linear_coupling`` declared, the pooled-feature sum rides
        the SAME psum as the norms and the coupling residual values are
        assembled from the reduced u afterward (1 collective).
        ``extras``: additional local scalars to ride the same collective
        (returns (kkt, reduced_extras) when given)."""
        rx, rs, rce, rcc, rci, rsc, rcci, aux = residual_blocks(
            x, s, sc, le, li, lc, lci, th, ccdata, mu, defer_u=lin_cc)
        zero = jnp.zeros((), dtype)
        parts = [jnp.sum(rx ** 2),
                 jnp.sum((rs * s) ** 2) if ni else zero,
                 jnp.sum(rce ** 2) if me else zero,
                 jnp.sum(rci ** 2) if ni else zero]
        stacked = jnp.stack(
            parts + [jnp.asarray(e, dtype) for e in extras])
        if lin_cc:
            red, u_g = _psum_pack(stacked, aux[0])
            rcc = (spec.cc(u_g, ccdata) if mc
                   else jnp.zeros((0,), dtype))
            rcci = jnp.zeros((0,), dtype)           # lin_cc => mci == 0
        else:
            red = _psum(stacked)
        k1 = jnp.sqrt(red[0])
        k2 = (jnp.sqrt(red[1] + jnp.sum((rsc * sc) ** 2))
              if has_barrier else zero)
        k3 = (jnp.sqrt(red[2] + jnp.sum(rcc ** 2))
              if (me or mc) else zero)
        k4 = (jnp.sqrt(red[3] + jnp.sum(rcci ** 2))
              if has_barrier else zero)
        kkt = jnp.stack([k1, k2, k3, k4])
        if extras:
            return kkt, red[4:]
        return kkt

    def _con_l1_parts(x, s, th):
        """Local (pre-psum) l1 infeasibility parts + the local pooled-
        feature sum: everything con_l1/phi need from ONE collective."""
        zero = jnp.zeros((), dtype)
        ce_l1 = jnp.sum(jnp.abs(ce_v(x, th))) if me else zero
        if ni:
            dev = ci_v(x, th) - s
            if imk:
                dev = dev * _im(th)
            ci_l1 = jnp.sum(jnp.abs(dev))
        else:
            ci_l1 = zero
        gsum = (jnp.sum(g_v(x, th), axis=0) if has_cc
                else jnp.zeros((0,), dtype))
        return ce_l1, ci_l1, gsum

    def _con_l1_from(ce_l1, ci_l1, u, sc, ccdata):
        """Assemble the global l1 infeasibility from psum-reduced
        parts (u already global)."""
        v = ce_l1 + ci_l1
        if mc:
            v = v + jnp.sum(jnp.abs(spec.cc(u, ccdata)))
        if mci:
            v = v + jnp.sum(jnp.abs(spec.cci(u, ccdata) - sc))
        return v

    def _phi_parts(x, s, th):
        """Local (pre-psum) merit ingredients: (f, |ce|_1, |ci-s|_1,
        sum log s, pooled features)."""
        ce_l1, ci_l1, gsum = _con_l1_parts(x, s, th)
        floc = jnp.sum(f_v(x, th))
        if ni:
            logs = jnp.log(s)
            if imk:
                logs = logs * _im(th)    # inactive slacks pinned at 1
            logloc = jnp.sum(logs)
        else:
            logloc = jnp.zeros((), dtype)
        return floc, ce_l1, ci_l1, logloc, gsum

    def _phi_from_reduced(fg, ce_g, ci_g, logg, u, sc, ccdata, mu, nu):
        val = fg + nu * _con_l1_from(ce_g, ci_g, u, sc, ccdata)
        if ni:
            val = val - mu * logg
        if mci:
            val = val - mu * jnp.sum(jnp.log(sc))
        return val

    def phi_g(x, s, sc, th, ccdata, mu, nu, with_parts=False):
        """l1 merit (reference pyipm.py:670-694), globally reduced —
        objective, l1 parts, barrier sum, and pooled features ride ONE
        fused psum (the line search pays this per trial chunk).  With
        ``with_parts`` additionally returns the reduced (ce_l1, ci_l1,
        u) so downstream consumers (the SOC's infeasibility test at the
        same point) pay no second collective."""
        fg, ce_g, ci_g, logg, u = _psum_pack(*_phi_parts(x, s, th))
        val = _phi_from_reduced(fg, ce_g, ci_g, logg, u, sc, ccdata,
                                mu, nu)
        if with_parts:
            return val, (ce_g, ci_g, u)
        return val

    def phi_g_pair(pt1, pt2, th, ccdata, mu, nu):
        """Merit at TWO trial points through ONE fused psum (census: the
        SOC's two acceptance tests used to pay one collective each).
        Each point is (x, s, sc)."""
        p1 = _phi_parts(pt1[0], pt1[1], th)
        p2 = _phi_parts(pt2[0], pt2[1], th)
        red = _psum_pack(*p1, *p2)
        v1 = _phi_from_reduced(red[0], red[1], red[2], red[3], red[4],
                               pt1[2], ccdata, mu, nu)
        v2 = _phi_from_reduced(red[5], red[6], red[7], red[8], red[9],
                               pt2[2], ccdata, mu, nu)
        return v1, v2

    # ------------------------------------------------------------------
    def ls_multiplier_init(x, th, ccdata):
        """Distributed form of the reference's least-squares multiplier
        initializer lda0 = pinv(J^T) grad f (reference pyipm.py:723-730;
        single-device: core/kkt.py init_lambda via ops/linalg.py
        lstsq_minnorm's regularized normal equations).

        The assembled Jacobian-transpose J (rows = all K*d primal
        variables, columns = all multipliers) is block-structured:
        per-block columns B_k = [Je_k^T, Ji_k^T] touch only block k's
        rows, while the q = mc + mci coupling columns C_k = G_k^T Jc^T
        (Jc = [Jcc; Jcci]) run through every block.  Both lstsq_minnorm
        branches therefore reduce to per-block small SPD solves plus one
        replicated q x q border system assembled from psums:

          * underdetermined (K*d <= #multipliers): Woodbury on
            J J^T = blockdiag(B_k B_k^T) + C C^T;
          * overdetermined: Schur complement over the coupling columns of
            the normal matrix J^T J.

        Both use lstsq_minnorm's Tikhonov term (reg * scale with the
        GLOBAL trace) and its guarded refinement against the
        unregularized normal operator, so the result matches the
        single-device assembled init to roundoff.  Returns
        (le, li, lc, lci) pre-clamp."""
        Kl = x.shape[0]
        q = mc + mci
        nloc = me + ni
        b = gradf_v(x, th)                           # (Kl, d)
        # With identity inequality Jacobians (iid: bounds ci = x - lb)
        # the identity block is handled STRUCTURALLY — materializing it
        # as (Kl, d, d) would allocate d^2 per block, which is exactly
        # what the large-d L-BFGS mode exists to avoid.  ``Bs`` then
        # holds only the non-identity columns.
        big_iid = bool(ni and iid)
        cols = []
        if me:
            cols.append(jnp.swapaxes(Je_v(x, th), 1, 2))
        if ni and not iid:
            cols.append(jnp.swapaxes(Ji_v(x, th), 1, 2))
        Bs = (jnp.concatenate(cols, axis=2) if cols
              else jnp.zeros((Kl, d, 0), dtype))     # (Kl, d, me[+ni])
        imask = ((_im(th) if imk else jnp.ones((Kl, d), dtype))
                 if big_iid else None)
        B = Bs                                       # legacy name below
        if has_cc:
            u, _, Jcc_, _, Jcci_, _ = coupling_state(
                x, th, ccdata, jnp.zeros((mc,), dtype),
                jnp.zeros((mci,), dtype))
            Jc = jnp.concatenate([Jcc_, Jcci_], axis=0)   # (q, p)
            G = G_v(x, th)
            C = jnp.einsum("kpd,qp->kdq", G, Jc)     # (Kl, d, q)
        else:
            C = jnp.zeros((Kl, d, 0), dtype)
        mtot = nglob * Kl * d
        ntot = nglob * Kl * nloc + q     # static MAXIMUM column count
        # the Tikhonov scale divides by the ACTIVE column count under
        # ragged masks (matches an assembled problem with only the
        # active rows); the under/over-determined BRANCH choice stays on
        # the static maxima (documented: with masks dropping the active
        # count below mtot the Woodbury branch still computes a valid
        # regularized LS init, just not the assembled-branch bit pattern)
        ntot_act = ntot
        if (me and emk) or (ni and imk):
            ntot_act = q + _psum(
                (jnp.sum(_em(th)) if (me and emk)
                 else jnp.asarray(nglob * Kl * me, dtype))
                + (jnp.sum(_im(th)) if (ni and imk)
                   else jnp.asarray(nglob * Kl * ni, dtype)))
        reg = jnp.sqrt(jnp.asarray(eps, dtype))
        tr = _psum(jnp.sum(B ** 2) + jnp.sum(C ** 2)
                   + (jnp.sum(imask) if big_iid
                      else jnp.zeros((), dtype)))
        eye_q = jnp.eye(q, dtype=dtype)

        def refine(y, apply_G, solve_fn, rhs):
            """lstsq_minnorm's guarded refinement against the
            UNregularized operator, with globally psum-reduced residual
            norms and the same carried-residual / stall-exit logic."""
            r = jax.tree.map(lambda a_, b_: a_ - b_, rhs, apply_G(y))

            def gnorm(r_):
                loc, repl = r_
                return jnp.sqrt(_psum(jnp.sum(loc ** 2))
                                + jnp.sum(repl ** 2))

            rn = gnorm(r)

            def cond_fn(c):
                i, _, _, _, stalled = c
                return (i < 3) & ~stalled

            def body_fn(c):
                i, y_, r_, rn_, _ = c
                y1 = jax.tree.map(lambda a_, b_: a_ + b_, y_,
                                  solve_fn(r_))
                r1 = jax.tree.map(lambda a_, b_: a_ - b_, rhs,
                                  apply_G(y1))
                rn1 = gnorm(r1)
                better = rn1 < rn_
                y_ = jax.tree.map(
                    lambda a_, b_: jnp.where(better, b_, a_), y_, y1)
                r_ = jax.tree.map(
                    lambda a_, b_: jnp.where(better, b_, a_), r_, r1)
                rn_ = jnp.where(better, rn1, rn_)
                return i + 1, y_, r_, rn_, ~better

            _, y, _, _, _ = lax.while_loop(
                cond_fn, body_fn,
                (jnp.zeros((), jnp.int32), y, r, rn,
                 jnp.zeros((), jnp.bool_)))
            return y

        if mtot <= ntot:
            # underdetermined: lda = J^T (J J^T + reg*s*I)^{-1} b with
            # J J^T = blockdiag(B_k B_k^T [+ diag(imask)]) + C C^T
            # (Woodbury border); big_iid always lands here (the masked
            # identity alone gives ntot >= mtot)
            scale = jnp.maximum(tr / mtot, jnp.ones((), dtype))
            nb_cols = B.shape[2]
            if big_iid:
                # diagonal base + rank-(me) correction — never builds a
                # (d, d) matrix (large-d L-BFGS blocks)
                base = imask + reg * scale           # (Kl, d)
                t1 = B / base[..., None]             # (Kl, d, me)
                if nb_cols:
                    core_e = (jnp.eye(nb_cols, dtype=dtype)[None]
                              + jnp.einsum("kdm,kdn->kmn", B, t1))
                    che = jax.vmap(
                        lambda A_: jax.scipy.linalg.cho_factor(
                            A_, lower=True)[0])(core_e)

                def dinv_fn(R):                      # (Kl, d, r)
                    t = R / base[..., None]
                    if nb_cols:
                        u = jnp.einsum("kdm,kdr->kmr", B, t)
                        v = jax.vmap(
                            lambda c_, b_: jax.scipy.linalg.cho_solve(
                                (c_, True), b_))(che, u)
                        t = t - jnp.einsum("kdm,kmr->kdr", t1, v)
                    return t

                def bbT_mv(yb):                      # unregularized
                    out = imask * yb
                    if nb_cols:
                        out = out + jnp.einsum(
                            "kdm,km->kd", B,
                            jnp.einsum("kdm,kd->km", B, yb))
                    return out
            else:
                Dk = (jnp.einsum("kdm,kem->kde", B, B)
                      + (reg * scale) * jnp.eye(d, dtype=dtype)[None])
                ch = jax.vmap(lambda A_: jax.scipy.linalg.cho_factor(
                    A_, lower=True)[0])(Dk)

                def dinv_fn(R):
                    return jax.vmap(
                        lambda c_, r_: jax.scipy.linalg.cho_solve(
                            (c_, True), r_))(ch, R)

                def bbT_mv(yb):
                    return jnp.einsum(
                        "kdm,km->kd", B,
                        jnp.einsum("kdm,kd->km", B, yb))

            def solve_reg(rhs):
                rb, _ = rhs                          # ((Kl,d), (0,))
                y0 = dinv_fn(rb[..., None])[..., 0]
                if q:
                    T = dinv_fn(C.reshape(Kl, d, q))
                    S = eye_q + _psum(jnp.einsum("kdq,kdr->qr", C, T))
                    zq = jnp.linalg.solve(
                        S, _psum(jnp.einsum("kdq,kd->q", C, y0)))
                    y0 = y0 - jnp.einsum("kdq,q->kd", T, zq)
                return (y0, jnp.zeros((0,), dtype))

            def apply_unreg(y):
                yb, _ = y
                out = bbT_mv(yb)
                if q:
                    cz = _psum(jnp.einsum("kdq,kd->q", C, yb))
                    out = out + jnp.einsum("kdq,q->kd", C, cz)
                return (out, jnp.zeros((0,), dtype))

            rhs = (b, jnp.zeros((0,), dtype))
            y = refine(solve_reg(rhs), apply_unreg, solve_reg, rhs)
            yb = y[0]
            zc = (_psum(jnp.einsum("kdq,kd->q", C, yb)) if q
                  else jnp.zeros((0,), dtype))
            if big_iid:
                le0 = jnp.einsum("kdm,kd->km", B, yb)    # Je columns
                li0 = imask * yb
                return le0, li0, zc[:mc], zc[mc:]
            lda_blk = jnp.einsum("kdm,kd->km", B, yb)    # (Kl, me+ni)
        else:
            # overdetermined: normal equations (J^T J + reg*s*I) lda =
            # J^T b, Schur complement over the coupling columns
            scale = jnp.maximum(tr / ntot_act, jnp.ones((), dtype))
            Dk = (jnp.einsum("kdm,kdn->kmn", B, B)
                  + (reg * scale) * jnp.eye(nloc, dtype=dtype)[None])
            BC = jnp.einsum("kdm,kdq->kmq", B, C)    # (Kl, nloc, q)
            ch = jax.vmap(lambda A_: jax.scipy.linalg.cho_factor(
                A_, lower=True)[0])(Dk)
            dinv = jax.vmap(lambda c_, r_: jax.scipy.linalg.cho_solve(
                (c_, True), r_))

            def solve_reg(rhs):
                rb, rq = rhs                         # (Kl,nloc), (q,)
                y0 = dinv(ch, rb)
                if q:
                    T = dinv(ch, BC)
                    S = (_psum(jnp.einsum("kdq,kdr->qr", C, C))
                         + (reg * scale) * eye_q
                         - _psum(jnp.einsum("kmq,kmr->qr", BC, T)))
                    zq = jnp.linalg.solve(
                        S, rq - _psum(jnp.einsum("kmq,km->q", BC, y0)))
                    yk = y0 - jnp.einsum("kmq,q->km", T, zq)
                else:
                    zq = jnp.zeros((0,), dtype)
                    yk = y0
                return (yk, zq)

            def apply_unreg(y):
                yk, zq = y
                Byk = jnp.einsum("kdm,km->kd", B, yk)
                if q:
                    Byk = Byk + jnp.einsum("kdq,q->kd", C, zq)
                out_b = jnp.einsum("kdm,kd->km", B, Byk)
                out_q = (_psum(jnp.einsum("kdq,kd->q", C, Byk)) if q
                         else zq)
                return (out_b, out_q)

            rhs = (jnp.einsum("kdm,kd->km", B, b),
                   (_psum(jnp.einsum("kdq,kd->q", C, b)) if q
                    else jnp.zeros((0,), dtype)))
            lda_blk, zc = refine(solve_reg(rhs), apply_unreg, solve_reg,
                                 rhs)

        le0 = lda_blk[:, :me]
        li0 = lda_blk[:, me:]
        return le0, li0, zc[:mc], zc[mc:]

    # ------------------------------------------------------------------
    # per-block L-BFGS machinery (use_lbfgs mode)
    def _rx_at(x_, th, ccdata, le, li, lc, lci):
        """Per-block Lagrangian x-gradient at an arbitrary iterate under
        the CURRENT multipliers (the single-device update re-evaluates
        both secant ends the same way, core/solver.py direction_lbfgs)."""
        rx = gradf_v(x_, th)
        if me:
            rx = rx - jnp.einsum("kmd,km->kd", Je_v(x_, th), le)
        if ni:
            rx = rx - ((li * _im(th) if imk else li) if iid
                       else jnp.einsum("knd,kn->kd", Ji_v(x_, th), li))
        if has_cc:
            _, _, _, _, _, w_o = coupling_state(x_, th, ccdata, lc, lci)
            rx = rx - jnp.einsum("kpd,p->kd", G_v(x_, th), w_o)
        return rx

    def _lbfgs_mem_update(mem, x, x_old, rx_cur, le, li, lc, lci, th,
                          ccdata, not_first):
        """Vmapped curvature update dx = x - x_old, dg = rx(x) - rx(x_old)
        (both ends at current multipliers), gated off on the very first
        inner body (reference pyipm.py:1705)."""
        rx_old = _rx_at(x_old, th, ccdata, le, li, lc, lci)
        dx = x - x_old
        dg = rx_cur - rx_old
        constrained = (me + ni + mc + mci) > 0

        def upd(m_):
            return jax.vmap(
                lambda mm, dxx, dgg: lbfgs_update(
                    mm, dxx, dgg, constrained=constrained, eps=eps,
                    zeta0=cfg.zeta0,
                    fail_max=cfg.lbfgs_fail_max))(m_, dx, dg)

        return lax.cond(not_first, upd, lambda m_: m_, mem)

    def _lbfgs_prep(mem, sig, Ji, JiT, Je, JeT, th, mu):
        """Operator-form condensed solve from the per-block compact
        memory: B_k = zeta I - W M^{-1} W^T (BNS direct form, the same
        middle matrix as core/lbfgs.py), A_k = B_k + Ji^T Sigma Ji solved
        by Sherman-Morrison-Woodbury over a DIAGONAL base, equality rows
        by a per-block (me x me) Schur complement.  Returns
        (solve_blk, hess_mv, eq_app)."""
        Kl = mem.S.shape[0]
        zeta = mem.zeta                                  # (Kl,)
        Sm, Ym, SS, Lm, Dv, valid = jax.vmap(
            lambda st_: _masked_mem(st_, True))(mem)
        Mmid = jax.vmap(_padded_middle)(SS, Lm, Dv, valid, zeta)
        Wlb = jnp.concatenate([zeta[:, None, None] * Sm, Ym], axis=2)
        m2 = Wlb.shape[2]
        Mlu = jax.vmap(jax.scipy.linalg.lu_factor)(Mmid)

        def _lusolve(f_, b_):
            return jax.vmap(jax.scipy.linalg.lu_solve)(f_, b_)

        def hess_mv(dx_):                                # B @ dx
            t = jnp.einsum("kdm,kd->km", Wlb, dx_)
            return zeta[:, None] * dx_ - jnp.einsum(
                "kdm,km->kd", Wlb, _lusolve(Mlu, t[..., None])[..., 0])

        # A = diag(D0) + V Lam V^T with Lam = blockdiag(-M^{-1}, I)
        if ni and iid:
            D0 = zeta[:, None] + sig                     # Sigma folded
            V = Wlb
            Lam_inv = -Mmid
        elif ni:
            D0 = jnp.broadcast_to(zeta[:, None], (Kl, d))
            U2 = JiT * jnp.sqrt(sig)[:, None, :]         # (Kl, d, ni)
            V = jnp.concatenate([Wlb, U2], axis=2)
            q2 = m2 + ni
            Lam_inv = jnp.zeros((Kl, q2, q2), dtype)
            Lam_inv = Lam_inv.at[:, :m2, :m2].set(-Mmid)
            Lam_inv = Lam_inv.at[:, m2:, m2:].set(
                jnp.eye(ni, dtype=dtype)[None])
        else:
            D0 = jnp.broadcast_to(zeta[:, None], (Kl, d))
            V = Wlb
            Lam_inv = -Mmid
        core = Lam_inv + jnp.einsum("kdp,kd,kdq->kpq", V, 1.0 / D0, V)
        Clu = jax.vmap(jax.scipy.linalg.lu_factor)(core)

        def a_inv(R):                                    # (Kl, d, r)
            t = R / D0[..., None]
            u = jnp.einsum("kdp,kdr->kpr", V, t)
            v = _lusolve(Clu, u)
            return t - jnp.einsum("kdp,kpr->kdr", V, v) / D0[..., None]

        if me:
            T = a_inv(JeT)                               # (Kl, d, me)
            Se = jnp.einsum("kmd,kdn->kmn", Je, T)
            ev = jnp.abs(jax.vmap(jnp.linalg.eigvalsh)(Se))
            rcond = (jnp.min(ev, axis=-1)
                     / jnp.maximum(jnp.max(ev, axis=-1), tiny))
            finite = jnp.all(jnp.isfinite(ev), axis=-1)
            reg = _eq_reg_term(mu, cfg.reg_coef, cfg.eta, cfg.beta,
                               dtype)
            eq_app = jnp.where((rcond <= eps) | (~finite), reg,
                               jnp.zeros((Kl,), dtype))
            Se = Se + eq_app[:, None, None] * jnp.eye(me, dtype=dtype)
            if emk:
                # identity-pin inactive (masked) equality rows
                Se = Se + jax.vmap(jnp.diag)(1.0 - _em(th))
            ch = jax.vmap(lambda A_: jax.scipy.linalg.cho_factor(
                A_, lower=True)[0])(Se)

            def solve_blk(rhs):                          # (Kl, n, r)
                r1, r2 = rhs[:, :d, :], rhs[:, d:, :]
                t = a_inv(r1)
                rhs_y = jnp.einsum("kmd,kdr->kmr", Je, t) - r2
                y = jax.vmap(lambda c_, b_: jax.scipy.linalg.cho_solve(
                    (c_, True), b_))(ch, rhs_y)
                xsol = t - jnp.einsum("kdm,kmr->kdr", T, y)
                return jnp.concatenate([xsol, y], axis=1)
        else:
            eq_app = jnp.zeros((Kl,), dtype)

            def solve_blk(rhs):
                return a_inv(rhs)

        return solve_blk, hess_mv, eq_app

    def direction(x, s, sc, le, li, lc, lci, th, ccdata, mu, delta,
                  lbfgs_st=None, x_old=None, not_first=None):
        """Distributed condensed-KKT Newton step via the coupling border.

        Returns (dx, ds, dsc, dae, db, dbc, dac, resolve, delta_new,
        retries, mu_new) with the PRE-FLIP sign convention of
        ops/condensed.py (the caller negates the multiplier steps,
        reference pyipm.py:1723-1725); ``resolve`` is the same-matrix SOC.

        Coupling INEQUALITIES enter exactly like per-block ones, but in
        u-space: their slacks are eliminated into the border Hessian as
        +G^T Jcci^T Sigc Jcci G, i.e. the border uses
        Hhat = Hu - Jcci^T Sigc Jcci, and dsc/dbc are recovered
        elementwise from v = sum_k G_k dx_k."""
        Kl = x.shape[0]
        rx, rs, rce, rcc, rci, rsc, rcci, (u, Jcc, Jcci, w) = \
            residual_blocks(x, s, sc, le, li, lc, lci, th, ccdata, mu,
                            defer_u=lin_cc)
        g1, g2, g3e, g4 = -rx, -rs, -rce, -rci
        if lin_cc:
            # u holds the LOCAL pooled-feature sum; it rides the first
            # bordered solve's collective, after which the coupling rhs
            # is assembled from the reduced value (callable sentinel)
            gsum_dir = u
            g3c = ((lambda u_: -spec.cc(u_, ccdata)) if mc
                   else jnp.zeros((0,), dtype))
        else:
            gsum_dir = None
            g3c = -rcc
        g2c, g4c = -rsc, -rcci
        sigc = (lci / (sc + guard) if mci else jnp.zeros((0,), dtype))

        if ni:
            sig = li / (s + guard)                       # (Kl, ni)
            if iid and imk:
                sig = sig * _im(th)      # inactive rows contribute 0
            if iid:
                Ji = JiT = None                          # never built
            else:
                Ji = Ji_v(x, th)                         # (Kl, ni, d)
                JiT = jnp.swapaxes(Ji, 1, 2)
        else:
            Ji = jnp.zeros((Kl, 0, d), dtype)
            JiT = jnp.zeros((Kl, d, 0), dtype)
            sig = jnp.zeros((Kl, 0), dtype)

        def ji_mv(v):      # Ji @ v per block: (Kl, d) -> (Kl, ni)
            if iid:
                return v * _im(th) if imk else v
            return jnp.einsum("knd,kd->kn", Ji, v)

        def jiT_mv(w):     # Ji^T @ w per block: (Kl, ni) -> (Kl, d)
            if iid:
                return w * _im(th) if imk else w
            return jnp.einsum("kdn,kn->kd", JiT, w)
        if me:
            Je = Je_v(x, th)                             # (Kl, me, d)
            JeT = jnp.swapaxes(Je, 1, 2)
        else:
            Je = jnp.zeros((Kl, 0, d), dtype)
            JeT = jnp.zeros((Kl, d, 0), dtype)

        if use_lbfgs:
            # --- per-block compact L-BFGS condensed solve (no d^3) ----
            mem_new = _lbfgs_mem_update(lbfgs_st, x, x_old, rx, le, li,
                                        lc, lci, th, ccdata, not_first)
            solve_blk, hess_mv, eq_app = _lbfgs_prep(
                mem_new, sig, Ji, JiT, Je, JeT, th, mu)
            # B is PD by the curvature guard (+ PSD slack term), so no
            # inertia-correction retries and no delta shift exist here
            delta_new = delta
            retries = jnp.zeros((), jnp.int32)
        else:
            W = W_v(x, th, le, li, w)                    # (Kl, d, d)
            if ni:
                if iid:
                    A = W.at[:, jnp.arange(d), jnp.arange(d)].add(sig)
                else:
                    A = W + jnp.einsum("kdn,kn,kne->kde", JiT, sig, Ji)
            else:
                A = W
            if me:
                M = jnp.zeros((Kl, n, n), dtype)
                M = M.at[:, :d, :d].set(A)
                M = M.at[:, :d, d:].set(JeT)
                M = M.at[:, d:, :d].set(Je)
                if emk:
                    # identity-pin inactive equality rows: diagonal -1
                    # keeps the per-block inertia target at ``me``
                    # negative pivots uniformly, and with the (masked)
                    # zero rhs pins dae = 0
                    em_pin = _em(th) - 1.0       # 0 active, -1 inactive
                    M = M.at[:, jnp.arange(d, n),
                             jnp.arange(d, n)].add(em_pin)
            else:
                M = A
            M = (M + jnp.swapaxes(M, 1, 2)) * jnp.asarray(0.5, dtype)

            # per-block inertia-corrected factorization — the batched
            # form of the condensed path's reg_solve_kkt (ops/linalg.py)
            solve_blk, delta_new, retries, (delta_app, eq_app) = \
                batched_reg_factor(
                    M, delta, mu, neq=me, eps=eps, reg_coef=cfg.reg_coef,
                    eta=cfg.eta, beta=cfg.beta, delta0=cfg.delta0,
                    max_retries=cfg.max_reg_retries, block=cfg.ldlt_block)

            def hess_mv(dx_):
                return (jnp.einsum("kde,ke->kd", W, dx_)
                        + delta_app[:, None] * dx_)
            mem_new = lbfgs_st

        border_state = {}      # lin_cc: filled at the first bordered solve
        if has_cc:
            G = G_v(x, th)                               # (Kl, p, d)

            def lag_u(u_):
                t = jnp.zeros((), dtype)
                if mc:
                    t = t + lc @ spec.cc(u_, ccdata)
                if mci:
                    t = t + lci @ spec.cci(u_, ccdata)
                return t

            if lin_cc:
                Hu = jnp.zeros((p, p), dtype)            # affine coupling
            else:
                Hu = jax.hessian(lag_u)(u)               # (p, p)
            # slack-eliminated coupling-inequality Sigma folds into the
            # border Hessian (sign: the condensed system SUBTRACTS
            # G^T Hhat G, so Sigc enters with a minus inside Hhat)
            Hhat = (Hu - (Jcci.T * sigc[None, :]) @ Jcci
                    if mci else Hu)
            Ghat = jnp.zeros((Kl, n, p), dtype)
            Ghat = Ghat.at[:, :d, :].set(jnp.swapaxes(G, 1, 2))
            X = solve_blk(Ghat)                          # (Kl, n, p)

            def build_border(Pm_):
                Bm = jnp.zeros((p + mc, p + mc), dtype)
                Bm = Bm.at[:p, :p].set(
                    jnp.eye(p, dtype=dtype) - Pm_ @ Hhat)
                if mc:
                    Bm = Bm.at[:p, p:].set(Pm_ @ Jcc.T)
                    Bm = Bm.at[p:, :p].set(Jcc)
                    # tiny Tikhonov on the zero block for rank-deficient
                    # coupling; the refinement below corrects toward the
                    # unregularized system (the lstsq_minnorm pattern)
                    Bm = Bm.at[p:, p:].set(
                        cfg.reg_coef * jnp.eye(mc, dtype=dtype))
                return jax.scipy.linalg.lu_factor(Bm)

            Pm_loc = jnp.einsum("kpd,kdq->pq", G, X[:, :d, :])
            if lin_cc:
                # the Schur-border psum, the pooled-feature sum, and the
                # first bordered solve's pv share ONE collective (see
                # solve_full_multi); until then the border is pending
                Pm = blu = None
            else:
                # the psums between devices (SURVEY.md §5)
                Pm = _psum(Pm_loc)
                blu = build_border(Pm)
        else:
            G = jnp.zeros((Kl, 0, d), dtype)
            Hu = jnp.zeros((0, 0), dtype)
            Hhat = Hu
            X = jnp.zeros((Kl, n, 0), dtype)
            blu = None

        def solve_full_multi(rhs0s, g3cs, extras=()):
            """Solve the bordered system for R block rhs columns at once
            (list of (Kl, n)) with coupling rhs list g3cs; ``extras`` are
            local scalars that RIDE the border psum (collective-census:
            residual-norm reductions cost no extra all-reduce).  Returns
            (list of (U, dac, v, vv), reduced_extras) where vv is the
            globally-reduced coupling image psum(G @ U[:, :d]) computed
            ANALYTICALLY as pv + Pm @ y — no second collective."""
            R = len(rhs0s)
            U0s = solve_blk(jnp.stack(rhs0s, axis=-1))      # (Kl, n, R)
            if not has_cc:
                red = _psum_pack(*extras) if extras else ()
                zc_ = jnp.zeros((0,), dtype)
                outs = [(U0s[..., r], zc_, zc_, zc_) for r in range(R)]
                return outs, tuple(red)
            pv_loc = jnp.einsum("kpd,kdr->pr", G, U0s[:, :d, :])
            if lin_cc and "blu" not in border_state:
                # FIRST bordered solve: the pooled-feature sum and the
                # Schur-border matrix ride the pv collective (the
                # linear-coupling fusion — 3 all-reduces become 1)
                packed = _psum_pack(pv_loc, Pm_loc, gsum_dir, *extras)
                pv, red = packed[0], tuple(packed[3:])
                border_state["Pm"] = packed[1]
                border_state["u"] = packed[2]
                border_state["blu"] = build_border(packed[1])
            else:
                packed = _psum_pack(pv_loc, *extras)
                pv, red = packed[0], tuple(packed[1:])
            blu_l = border_state["blu"] if lin_cc else blu
            Pm_l = border_state["Pm"] if lin_cc else Pm
            outs = []
            for r in range(R):
                g3c_r = g3cs[r]
                if callable(g3c_r):
                    g3c_r = g3c_r(border_state["u"])
                vdac = jax.scipy.linalg.lu_solve(
                    blu_l, jnp.concatenate([pv[:, r], g3c_r]))
                v, dac = vdac[:p], vdac[p:]
                y = Hhat @ v - (Jcc.T @ dac if mc else 0.0)
                U = U0s[..., r] + jnp.einsum("knp,p->kn", X, y)
                vv = pv[:, r] + Pm_l @ y
                outs.append((U, dac, v, vv))
            return outs, red

        def solve_full(rhs0_, g3c_, extras=()):
            outs, red = solve_full_multi([rhs0_], [g3c_], extras)
            return outs[0] + (red,)

        def recover(U, dac, v, g2_, g4_, g2c_, g4c_):
            dx = U[:, :d]
            dae = U[:, d:]
            if ni:
                ds = ji_mv(dx) - g4_
                db = sig * ds - g2_
            else:
                ds = jnp.zeros((Kl, 0), dtype)
                db = jnp.zeros((Kl, 0), dtype)
            if mci:
                dsc = Jcci @ v - g4c_
                dbc = sigc * dsc - g2c_
            else:
                dsc = jnp.zeros((0,), dtype)
                dbc = jnp.zeros((0,), dtype)
            return dx, ds, dsc, dae, db, dbc, dac

        def full_residual(dx, ds, dsc, dae, db, dbc, dac, g2_, g2c_,
                          vv=None):
            """Residual of the REGULARIZED full Newton system via block
            matvecs — same contract as ops/condensed.py's refinement
            (the applied delta/eq shifts are part of the system; the
            border Tikhonov is NOT, so refinement pulls toward the
            unregularized coupling row).  ``g2_``/``g2c_`` are the
            complementarity rhs of the system being refined (they differ
            between the Mehrotra predictor and corrector).  ``vv`` is
            the globally-reduced coupling image psum(G dx): every dx
            this refinement sees is a sum of solve_full outputs, whose
            vv comes back analytically from the border psum — passing it
            in makes the residual COLLECTIVE-FREE (census item; the r4
            form psummed here every step)."""
            r1 = g1 - hess_mv(dx)
            if me:
                r1 = r1 - jnp.einsum("kmd,km->kd", Je, dae)
                row = (jnp.einsum("kmd,kd->km", Je, dx)
                       - eq_app[:, None] * dae)
                if emk:
                    # the identity-pinned inactive rows are part of the
                    # factored system being refined
                    row = row + (_em(th) - 1.0) * dae
                r3e = g3e - row
            else:
                r3e = g3e
            if ni:
                r1 = r1 - jiT_mv(db)
                r2 = g2_ - (sig * ds - db)
                r4 = g4 - (ji_mv(dx) - ds)
            else:
                r2, r4 = g2_, g4
            if has_cc:
                wrow = -Hu @ vv
                if mc:
                    wrow = wrow + Jcc.T @ dac
                if mci:
                    wrow = wrow + Jcci.T @ dbc
                r1 = r1 - jnp.einsum("kpd,p->kd", G, wrow)
                # lin_cc defers g3c behind the first bordered solve's
                # collective; by residual time the border is built
                g3c_a = (g3c(border_state["u"]) if callable(g3c)
                         else g3c)
                r3c = g3c_a - (Jcc @ vv if mc else g3c_a * 0)
                if mci:
                    r2c = g2c_ - (sigc * dsc - dbc)
                    r4c = g4c - (Jcci @ vv - dsc)
                else:
                    r2c, r4c = g2c_, g4c
            else:
                r3c = g3c
                r2c, r4c = g2c_, g4c
            return r1, r2, r3e, r3c, r4, r2c, r4c

        def res_norm2_parts(r):
            """(local, replicated) split of the squared residual norm —
            the local part rides a later collective instead of paying
            its own psum."""
            r1, r2, r3e, r3c, r4, r2c, r4c = r
            loc = (jnp.sum(r1 ** 2) + jnp.sum(r2 ** 2)
                   + jnp.sum(r3e ** 2) + jnp.sum(r4 ** 2))
            rep = (jnp.sum(r3c ** 2) + jnp.sum(r2c ** 2)
                   + jnp.sum(r4c ** 2))
            return loc, rep

        def _ineq_coupling_pull(r2c_, r4c_):
            """x-row contribution of the eliminated coupling-inequality
            rows: + G^T Jcci^T (Sigc r4c + r2c), the u-space analog of
            the per-block JiT(sig g4 + g2)."""
            wc = Jcci.T @ (sigc * r4c_ + r2c_)
            return jnp.einsum("kpd,p->kd", G, wc)

        def _condensed_rhs(r):
            r1, r2, r3e, r3c, r4, r2c, r4c = r
            rr1 = r1 + (jiT_mv(sig * r4 + r2) if ni else 0.0)
            if mci:
                rr1 = rr1 + _ineq_coupling_pull(r2c, r4c)
            rr0 = jnp.concatenate([rr1, r3e], axis=1) if me else rr1
            return rr0, r3c

        def condensed_apply_multi(rs, extras=()):
            """Bordered solves of several residual systems against the
            CACHED factors (no refactorization) — ops/condensed.py's
            condensed_apply, distributed, multi-rhs so correction
            candidates share ONE border collective; ``extras`` ride it.
            Returns ([(correction steps, vv)], reduced_extras)."""
            rhs = [_condensed_rhs(r) for r in rs]
            outs, red = solve_full_multi([a for a, _ in rhs],
                                         [b for _, b in rhs], extras)
            res = []
            for r, (Ue, eac, ev, vvc) in zip(rs, outs):
                _, r2, _, _, r4, r2c, r4c = r
                res.append((recover(Ue, eac, ev, r2, r4, r2c, r4c), vvc))
            return res, red

        def assemble_rhs0(g2_, g2c_):
            rr1 = (g1 + jiT_mv(sig * g4 + g2_) if ni else g1)
            if mci:
                rr1 = rr1 + _ineq_coupling_pull(g2c_, g4c)
            return jnp.concatenate([rr1, g3e], axis=1) if me else rr1

        def solve_refined(g2_, g2c_, defer_final_guard=False):
            """Bordered solve + guarded refinement steps for the system
            with complementarity rhs g2_/g2c_ (ops/condensed.py
            pattern).  Collective cost (census): the r4 form paid ~5
            psums per guarded step; now the residual is collective-free
            (analytic vv), the residual-norm reductions ride the
            correction solves' border psum, and rejected-candidate
            re-corrections are computed as a second rhs column of the
            SAME solve — 1 collective per step plus one final guard
            reduction (which ``defer_final_guard`` hands to the caller's
            next fused collective, making it free too).

            With ``defer_final_guard`` returns ``(steps_accepted,
            pending)`` where pending = (steps_candidate, local_norm_part,
            replicated_norm_part, rn_accepted) or None; the caller
            reduces the local part and keeps the candidate iff its norm
            is smaller."""
            U, dac_, v, vv, _ = solve_full(assemble_rhs0(g2_, g2c_), g3c)
            steps = recover(U, dac_, v, g2_, g4, g2c_, g4c)
            nsteps = max(int(cfg.schur_refine_steps), 0)
            if nsteps == 0:
                return (steps, None) if defer_final_guard else steps
            if not cfg.schur_refine_guard:
                for _ in range(nsteps):
                    r = full_residual(*steps, g2_, g2c_, vv=vv)
                    out, _ = condensed_apply_multi([r])
                    (corr, vvc), = out
                    steps = tuple(a + b for a, b in zip(steps, corr))
                    vv = vv + vvc
                return (steps, None) if defer_final_guard else steps
            steps_acc, vv_acc = steps, vv
            r_acc = full_residual(*steps_acc, g2_, g2c_, vv=vv_acc)
            loc_acc, rep_acc = res_norm2_parts(r_acc)
            rn_acc = None
            cand = None          # (steps, vv, r, loc, rep) pending guard
            for _ in range(nsteps):
                if cand is None:
                    out, red = condensed_apply_multi([r_acc],
                                                     extras=(loc_acc,))
                    (corr, vvc), = out
                    rn_acc = red[0] + rep_acc
                else:
                    # resolve the pending candidate with the norm that
                    # rode THIS solve's psum; corrections for both
                    # outcomes are two rhs columns of one bordered solve
                    sC, vC, rC, locC, repC = cand
                    out, red = condensed_apply_multi([rC, r_acc],
                                                     extras=(locC,))
                    (corrA, vvA), (corrB, vvB) = out
                    rnC = red[0] + repC
                    better = rnC < rn_acc
                    steps_acc = tuple(jnp.where(better, a, b)
                                      for a, b in zip(sC, steps_acc))
                    vv_acc = jnp.where(better, vC, vv_acc)
                    r_acc = tuple(jnp.where(better, a, b)
                                  for a, b in zip(rC, r_acc))
                    rn_acc = jnp.minimum(rnC, rn_acc)
                    corr = tuple(jnp.where(better, a, b)
                                 for a, b in zip(corrA, corrB))
                    vvc = jnp.where(better, vvA, vvB)
                new_steps = tuple(a + b for a, b in zip(steps_acc, corr))
                new_vv = vv_acc + vvc
                new_r = full_residual(*new_steps, g2_, g2c_, vv=new_vv)
                cand = (new_steps, new_vv, new_r,
                        *res_norm2_parts(new_r))
            sC, vC, rC, locC, repC = cand
            if defer_final_guard:
                return steps_acc, (sC, locC, repC, rn_acc)
            rnC = _psum(locC) + repC
            better = rnC < rn_acc
            return tuple(jnp.where(better, a, b)
                         for a, b in zip(sC, steps_acc))

        if use_mehrotra:
            # Mehrotra predictor-corrector through the SAME factorization
            # and border (the distributed form of ops/condensed.py's
            # condensed_direction_mehrotra): affine step at mu=0, global
            # boundary steps via pmin, centering sigma over ALL barrier
            # pairs (block slacks + replicated coupling slacks), corrector
            # with the second-order complementarity terms.
            one = jnp.ones((), dtype)
            msk = _im(th) if (ni and imk) else None
            g2_aff = -(li * msk) if msk is not None else -li
            g2c_aff = -lci
            (dx_a, ds_a, dsc_a, dae_a, db_a, dbc_a,
             dac_a) = solve_refined(g2_aff, g2c_aff)
            dli_a = -db_a                 # post-flip multiplier steps
            dlci_a = -dbc_a
            if ni:
                # affine boundary steps: one fused pmin for both minima
                a_sl = lax.pmin(jnp.stack([
                    max_step_ftb(s, ds_a, one),
                    max_step_ftb(li, dli_a, one)]), axis_name=axis)
                a_s, a_l = a_sl[0], a_sl[1]
            else:
                a_s = a_l = one
            if mci:
                a_s = jnp.minimum(a_s, max_step_ftb(sc, dsc_a, one))
                a_l = jnp.minimum(a_l, max_step_ftb(lci, dlci_a, one))
            if msk is not None:
                # centering statistics over ACTIVE barrier pairs only;
                # the pair sums and the active count share ONE psum
                sl_pairs = msk * s * li
                aff_pairs = msk * ((s + a_s * ds_a)
                                   * (li + a_l * dli_a))
                sl_g, aff_g, cnt_g = _psum_pack(
                    jnp.sum(sl_pairs), jnp.sum(aff_pairs),
                    jnp.sum(msk))
                ntot_g = cnt_g + mci
            else:
                sl_g, aff_g = _psum_pack(jnp.sum(s * li),
                                         jnp.sum((s + a_s * ds_a)
                                                 * (li + a_l * dli_a)))
                # the global pair count is static — no collective needed
                ntot_g = jnp.asarray(nglob * s.size + mci, dtype)
            mu_mean = (sl_g + jnp.sum(sc * lci)) / ntot_g
            mu_aff = (aff_g + jnp.sum((sc + a_s * dsc_a)
                                      * (lci + a_l * dlci_a))) / ntot_g
            sigma_c = jnp.clip((mu_aff / (mu_mean + guard)) ** 3, 0.0, 1.0)
            mu_new = jnp.maximum(sigma_c * mu_mean,
                                 jnp.asarray(cfg.mu_floor, dtype))
            corr = (mu_new - ds_a * dli_a) / (s + guard)
            g2_m = g2_aff + (corr * msk if msk is not None else corr)
            g2c_m = (g2c_aff + (mu_new - dsc_a * dlci_a) / (sc + guard)
                     if mci else g2c_aff)
            steps_main, pending = solve_refined(g2_m, g2c_m,
                                                defer_final_guard=True)
        else:
            mu_new = mu
            steps_main, pending = solve_refined(g2, g2c,
                                                defer_final_guard=True)

        def resolve(rce_n, rcc_n, rci_n, rcci_n):
            """Same-matrix SOC: constraint-only residuals through the
            SAME factorization (zero gradient rows)."""
            g4n = -rci_n
            g4cn = -rcci_n
            rr1 = (jiT_mv(sig * g4n)
                   if ni else jnp.zeros((Kl, d), dtype))
            if mci:
                rr1 = rr1 + _ineq_coupling_pull(jnp.zeros((mci,), dtype),
                                                g4cn)
            rr0 = (jnp.concatenate([rr1, -rce_n], axis=1) if me else rr1)
            Up, _, vp, _, _ = solve_full(rr0, -rcc_n)
            dx_p = Up[:, :d]
            ds_p = (ji_mv(dx_p) - g4n
                    if ni else jnp.zeros((Kl, 0), dtype))
            dsc_p = (Jcci @ vp - g4cn if mci
                     else jnp.zeros((0,), dtype))
            return dx_p, ds_p, dsc_p

        return (steps_main, pending, resolve, delta_new,
                retries, mu_new, mem_new)

    # ------------------------------------------------------------------
    # one primal-dual iteration on the SolverState carry (the distributed
    # instantiation of core/solver.py's inner_iter)
    def make_inner_iter(th, ccdata):
        def inner_iter(st: SolverState) -> SolverState:
            le, li, lc, lci = st.lda
            s_blk, sc = st.s
            not_first = (st.outer > 0) | (st.inner > 0)
            with jax.named_scope("ipm-direction"):
                (steps_main, pending, resolve, delta_new,
                 retries, mu_new, mem_new) = direction(
                     st.x, s_blk, sc, le, li, lc, lci, th, ccdata,
                     st.mu, st.delta, lbfgs_st=st.lbfgs,
                     x_old=st.x_old, not_first=not_first)
            if use_lbfgs:
                # memory was updated inside the direction; x_old follows
                # the single-device convention (advances only when the
                # update ran, core/solver.py direction_lbfgs)
                st = st._replace(
                    lbfgs=mem_new,
                    x_old=jnp.where(not_first, st.x, st.x_old))

            # fused post-direction reductions (collective-census item):
            # the reg-retry count (reg_retries is declared REPLICATED in
            # the state specs while each device's escalation loop trips
            # independently), the merit-penalty l1 parts, the pooled
            # features, the merit entry value's ingredients, the step-
            # norm parts, the dphi dot products, AND the deferred final
            # refinement-guard norm all ride ONE psum — the formulas
            # (pyipm.py:1727-1735) are unchanged.  Direction-dependent
            # lanes are computed for BOTH refinement-guard candidates
            # and selected after the reduction.
            ce_l1, ci_l1, gsum = _con_l1_parts(st.x, s_blk, th)
            floc = jnp.sum(f_v(st.x, th))
            if ni:
                logs0 = jnp.log(s_blk)
                if imk:
                    logs0 = logs0 * _im(th)
                logloc = jnp.sum(logs0)
            else:
                logloc = jnp.zeros((), dtype)

            def dir_lanes(stp):
                dx_, ds_ = stp[0], stp[1]
                gdot = jnp.sum(gradf_v(st.x, th) * dx_)
                bdot_s = (jnp.sum(-mu_new / (s_blk + guard) * ds_) if ni
                          else jnp.zeros((), dtype))
                sdx2 = jnp.sum(dx_ ** 2)
                sds2 = (jnp.sum(ds_ ** 2) if ni
                        else jnp.zeros((), dtype))
                return (gdot, bdot_s, sdx2, sds2)

            lanesA = dir_lanes(steps_main)
            fixed = (jnp.asarray(retries, dtype), ce_l1, ci_l1, floc,
                     logloc, gsum)
            if pending is not None:
                sC, locC, repC, rn_acc = pending
                lanesB = dir_lanes(sC)
                red = _psum_pack(*fixed, *lanesA, *lanesB, locC)
                retr_g, ce_g, ci_g, f_g, log_g, u_g = red[:6]
                better = (red[14] + repC) < rn_acc
                steps = tuple(jnp.where(better, a, b)
                              for a, b in zip(sC, steps_main))
                gdot_g, bds_g, sdx2_g, sds2_g = (
                    jnp.where(better, b_, a_)
                    for a_, b_ in zip(red[6:10], red[10:14]))
            else:
                red = _psum_pack(*fixed, *lanesA)
                retr_g, ce_g, ci_g, f_g, log_g, u_g = red[:6]
                gdot_g, bds_g, sdx2_g, sds2_g = red[6:10]
                steps = steps_main
            dx, ds, dsc, dae, db, dbc, dac = steps
            # multiplier sign flip (reference pyipm.py:1723-1725)
            dle, dli, dlc, dlci = -dae, -db, -dac, -dbc
            st = st._replace(
                mu=mu_new, delta=delta_new,
                reg_retries=st.reg_retries + retr_g.astype(jnp.int32))
            cl1 = _con_l1_from(ce_g, ci_g, u_g, sc, ccdata)
            bdot = gdot_g + bds_g
            if mci:
                bdot = bdot + jnp.sum(-st.mu / (sc + guard) * dsc)
            nu = jnp.maximum(st.nu,
                             nu_threshold(bdot, cl1, cfg.rho, tiny))

            # global fraction-to-the-boundary (closed form; the slack and
            # multiplier minima share ONE fused pmin)
            one = jnp.ones((), dtype)
            if ni:
                a_sl = lax.pmin(jnp.stack([
                    max_step_ftb(s_blk, ds, cfg.tau),
                    max_step_ftb(li, dli, cfg.tau)]), axis_name=axis)
                a_s, a_l = a_sl[0], a_sl[1]
            else:
                a_s = a_l = one
            if mci:
                a_s = jnp.minimum(a_s, max_step_ftb(sc, dsc, cfg.tau))
                a_l = jnp.minimum(a_l, max_step_ftb(lci, dlci, cfg.tau))

            # merit entry value from the fused lanes — no second psum
            phi0 = _phi_from_reduced(f_g, ce_g, ci_g, log_g, u_g, sc,
                                     ccdata, st.mu, nu)
            dphi0 = bdot - nu * cl1
            # roundoff-aware Armijo slack (see core/linesearch.py)
            slack = 10.0 * eps * (1.0 + jnp.abs(phi0))

            def armijo_rhs(a):
                return phi0 + a * cfg.eta * dphi0 + slack

            # the ENTRY trial's reduced l1 parts are stashed for the SOC
            # (same point => its infeasibility test and coupling pool
            # need no collectives of their own)
            entry_parts = []

            def phi_at(a):
                val, parts = phi_g(
                    st.x + a * dx, s_blk + a * ds, sc + a * dsc,
                    th, ccdata, st.mu, nu, with_parts=True)
                if not entry_parts:
                    entry_parts.append(parts)
                return val

            # a_s/a_l are replicated scalars, so the step-norm psum
            # factors into the already-reduced sum-of-squares lanes
            base = jnp.sqrt(a_s ** 2 * sdx2_g + a_l ** 2 * sds2_g
                            + jnp.sum((a_l * dsc) ** 2))

            payload_zero = (jnp.zeros_like(dx), jnp.zeros_like(ds),
                            jnp.zeros_like(dsc), jnp.ones((), dtype))

            def try_soc(a):
                """Second-order correction when infeasibility increased
                (reference pyipm.py:1464-1489) via the same-matrix
                resolve.  Census: the infeasibility test and the pooled
                features at the trial point come from the ENTRY phi
                evaluation's fused lanes (same point — zero extra
                collectives), the two acceptance phis share one psum,
                and the corrected boundary pmin precedes them."""
                xa = st.x + a * dx
                sa = s_blk + a * ds
                sca = sc + a * dsc
                ce_ga, ci_ga, u_ga = entry_parts[0]
                new_l1 = _con_l1_from(ce_ga, ci_ga, u_ga, sca, ccdata)

                def do(_):
                    Kl = xa.shape[0]
                    rce_n = (ce_v(xa, th) if me
                             else jnp.zeros((Kl, 0), dtype))
                    if ni:
                        rci_n = ci_v(xa, th) - sa
                        if imk:
                            rci_n = rci_n * _im(th)
                    else:
                        rci_n = jnp.zeros((Kl, 0), dtype)
                    if has_cc:
                        un = u_ga          # pooled features at xa, reduced
                        rcc_n = (spec.cc(un, ccdata) if mc
                                 else jnp.zeros((0,), dtype))
                        rcci_n = (spec.cci(un, ccdata) - sca if mci
                                  else jnp.zeros((0,), dtype))
                    else:
                        rcc_n = jnp.zeros((0,), dtype)
                        rcci_n = jnp.zeros((0,), dtype)
                    dx_p, ds_p, dsc_p = resolve(rce_n, rcc_n, rci_n,
                                                rcci_n)
                    rhs = armijo_rhs(a)
                    if has_barrier:
                        a_corr = one
                        if ni:
                            a_corr = max_step_ftb(s_blk, a * ds + ds_p,
                                                  cfg.tau, axis=axis)
                        if mci:
                            a_corr = jnp.minimum(a_corr, max_step_ftb(
                                sc, a * dsc + dsc_p, cfg.tau))
                        phi1, phi2 = phi_g_pair(
                            (xa + dx_p, sa + ds_p, sca + dsc_p),
                            (st.x + a_corr * (a * dx + dx_p),
                             s_blk + a_corr * (a * ds + ds_p),
                             sc + a_corr * (a * dsc + dsc_p)),
                            th, ccdata, st.mu, nu)
                        ok = (phi1 <= rhs) & (phi2 <= rhs)
                        return ok, (dx_p, ds_p, dsc_p, a_corr)
                    ok1 = phi_g(xa + dx_p, sa + ds_p, sca + dsc_p,
                                th, ccdata, st.mu, nu) <= rhs
                    return ok1, (dx_p, ds_p, dsc_p, one)

                def dont(_):
                    return jnp.zeros((), jnp.bool_), payload_zero

                return lax.cond(new_l1 > cl1, do, dont, None)

            def apply(a_sf, a_lf, soc, payload):
                dx_p, ds_p, dsc_p, a_corr = payload
                corr = jnp.where(soc, a_corr, one)
                gate = jnp.where(soc, one, jnp.zeros((), dtype))
                x = st.x + corr * (a_sf * dx + gate * dx_p)
                s_n = (s_blk + corr * (a_sf * ds + gate * ds_p)
                       if ni else s_blk)
                sc_n = (sc + corr * (a_sf * dsc + gate * dsc_p)
                        if mci else sc)
                lda = (le + a_lf * dle, li + a_lf * dli,
                       lc + a_lf * dlc, lci + a_lf * dlci)
                return st._replace(x=x, s=(s_n, sc_n), lda=lda, nu=nu,
                                   alpha=a_sf)

            def abort():
                return st._replace(signal=jnp.asarray(-2, jnp.int32),
                                   nu=nu, alpha=jnp.zeros((), dtype))

            with jax.named_scope("ipm-line-search"):
                sn = merit_line_search(
                    phi_at, armijo_rhs, base, a_s, a_l,
                    try_soc, payload_zero, apply, abort,
                    tau=cfg.tau, eps=eps, chunk=cfg.backtrack_chunk,
                    max_backtrack=cfg.max_backtrack)
            sn = sn._replace(iter_count=sn.iter_count + 1)
            len_, lin_, lcn_, lcin_ = sn.lda
            sbn_, scn_ = sn.s
            # post-step reductions fused onto the KKT-residual psum: the
            # nan-guard non-finite count and (eq-only Ftol) the local
            # objective sum ride the same collective as the four norms
            extras = []
            if cfg.nan_guard:
                bad_local = (jnp.sum(~jnp.isfinite(sn.x))
                             + jnp.sum(~jnp.isfinite(sbn_))
                             + jnp.sum(~jnp.isfinite(len_))
                             + jnp.sum(~jnp.isfinite(lin_)))
                # non-finite residual sums must not poison the packed
                # lanes' interpretation — the count lane itself is exact
                extras.append(bad_local.astype(dtype))
            want_f = cfg.Ftol is not None and not has_barrier
            if want_f:
                i_f = len(extras)
                extras.append(jnp.sum(f_v(sn.x, th)))
            # centrality ingredients for the adaptive barrier update ride
            # the same collective; the outer epilogue's centrality_stats
            # reads them from the carried state (census: the epilogue
            # previously paid its own sl psum + masked-count psum)
            want_cent = has_barrier and cfg.mu_strategy != "mehrotra"
            if want_cent:
                i_sl = len(extras)
                msk_c = _im(th) if (ni and imk) else None
                if ni:
                    pairs_c = ((msk_c * sbn_ * lin_) if msk_c is not None
                               else sbn_ * lin_)
                    extras.append(jnp.sum(pairs_c))
                else:
                    extras.append(jnp.zeros((), dtype))
                if msk_c is not None:
                    extras.append(jnp.sum(msk_c))
            with jax.named_scope("ipm-kkt-residual"):
                if extras:
                    kktv, ext_g = kkt_norms_g(
                        sn.x, sbn_, scn_, len_, lin_, lcn_, lcin_, th,
                        ccdata, sn.mu, extras=tuple(extras))
                else:
                    kktv = kkt_norms_g(
                        sn.x, sbn_, scn_, len_, lin_, lcn_, lcin_, th,
                        ccdata, sn.mu)
                    ext_g = ()
                sn = sn._replace(kkt=kktv)

            if cfg.nan_guard:
                # in-loop sanitizer (SURVEY.md §5): OR-reduced across
                # devices via the fused psum of non-finite counts
                finite = ((ext_g[0] == 0)
                          & jnp.all(jnp.isfinite(lcn_))
                          & jnp.all(jnp.isfinite(scn_))
                          & jnp.all(jnp.isfinite(lcin_))
                          & jnp.all(jnp.isfinite(sn.kkt)))
                sn = sn._replace(signal=jnp.where(
                    (sn.signal >= 0) & ~finite,
                    jnp.asarray(-3, jnp.int32), sn.signal))

            if cfg.trace_metrics:
                # per-iteration history buffers (replicated scalars; the
                # per-block delta is summarized by its max — the binding
                # shift, pmax-reduced so the 'replicated' value really is
                # replicated across devices); same contract as
                # core/solver.py
                t = sn.iter_count - 1
                h = sn.hist
                dmax = (lax.pmax(jnp.max(sn.delta), axis_name=axis)
                        if sn.delta.ndim else sn.delta)
                sn = sn._replace(hist=MetricsHistory(
                    kkt=h.kkt.at[t].set(sn.kkt),
                    mu=h.mu.at[t].set(sn.mu),
                    nu=h.nu.at[t].set(sn.nu),
                    alpha=h.alpha.at[t].set(sn.alpha),
                    delta=h.delta.at[t].set(dmax)))

            if want_f:
                # per-inner-iteration Ftol, eq-only (pyipm.py:1756-1766);
                # f_new came back on the fused KKT collective
                f_new = ext_g[i_f]
                live = sn.signal != -2
                hit = live & (jnp.abs(sn.f_past - f_new)
                              <= abs(cfg.Ftol))
                sn = sn._replace(
                    signal=jnp.where(hit, jnp.asarray(2, jnp.int32),
                                     sn.signal),
                    f_past=jnp.where(live, f_new, sn.f_past))
            if want_cent:
                sl_g = ext_g[i_sl] + (jnp.sum(scn_ * lcin_) if mci
                                      else jnp.zeros((), dtype))
                ntot_g = (ext_g[i_sl + 1] + mci
                          if (ni and imk)
                          else jnp.asarray(
                              sn.x.shape[0] * nglob * ni + mci, dtype))
                sn = sn._replace(g=jnp.stack([sl_g, ntot_g]))
            return sn

        return inner_iter

    # ------------------------------------------------------------------
    def make_engine(th, ccdata, Kl):
        def centrality_stats(st):
            """Only the global pair MINIMUM pays a collective here (one
            pmin); the pair SUM and the active-pair count rode the
            preceding KKT-residual psum and are carried in ``st.g`` —
            exact, because the state is unchanged between that reduction
            and this outer epilogue (a muTol exit without a fresh inner
            step leaves x/s/lda exactly as the last stepped state, whose
            stats st.g holds; the init state seeds st.g the same way)."""
            _, li_, _, lci_ = st.lda
            s_, sc_ = st.s
            msk = _im(th) if (ni and imk) else None
            pairs = ((msk * s_ * li_) if msk is not None else s_ * li_) \
                if ni else None
            if ni:
                pmin_in = (jnp.where(msk > 0, pairs, jnp.inf)
                           if msk is not None else pairs)
                smin = lax.pmin(jnp.min(pmin_in), axis_name=axis)
                if mci:
                    smin = jnp.minimum(smin, jnp.min(sc_ * lci_))
            else:
                smin = jnp.min(sc_ * lci_)
            sl = st.g[0]
            ntot = st.g[1]
            # Ragged edge case: a fleet declaring ni > 0 whose ci_mask is
            # all-zero in EVERY block (and mci == 0) yields ntot == 0 and
            # smin == inf, which would drive centrality_mu to NaN and kill
            # the solve with signal -3 instead of just skipping the
            # barrier update.  Neutralize: ntot >= 1 and smin -> 0 make
            # the update return mu_floor (benign; there is no barrier to
            # schedule when no inequality row is active).
            ntot = jnp.maximum(ntot, 1) if msk is not None else ntot
            smin = jnp.where(jnp.isfinite(smin), smin,
                             jnp.zeros((), dtype))
            return sl, smin, ntot

        return make_loop_engine(
            cfg, inner_iter=make_inner_iter(th, ccdata),
            f_val=lambda st: fval_g(st.x, th),
            centrality_stats=centrality_stats,
            has_ineq=has_barrier,
            unconstrained=(me + ni + mc + mci) == 0,
            dtype=dtype)

    def local_init(x0, th, ccdata, s0, le0, li0, lc0,
                   lci0=None) -> SolverState:
        Kl = x0.shape[0]
        x = x0.astype(dtype)
        if ni:
            s = (jnp.maximum(ci_v(x, th), cfg.Ktol).astype(dtype)
                 if s0 is None else s0.astype(dtype))
            if imk:
                # inactive slacks pinned at 1 (log s = 0, never stepped)
                s = jnp.where(_im(th) > 0, s, jnp.ones((), dtype))
        else:
            s = jnp.zeros((Kl, 0), dtype)
        if mci:
            u0 = _psum(jnp.sum(g_v(x, th), axis=0))
            sc = jnp.maximum(spec.cci(u0, ccdata),
                             cfg.Ktol).astype(dtype)
        else:
            sc = jnp.zeros((0,), dtype)
        mu0 = jnp.asarray(cfg.mu if has_barrier else cfg.Ktol,
                          dtype)                  # pyipm.py:1606
        # default multipliers: the reference's global least-squares
        # initializer, computed THROUGH the coupling border (negative
        # inequality multipliers clamped to Ktol, pyipm.py:1612-1621) —
        # same contract as the single-device default.  LS runs only when
        # no multiplier warm start is given at all; with a partial warm
        # start the unsupplied slots fall back to 0 (eq) / Ktol (ineq).
        Kt = jnp.asarray(cfg.Ktol, dtype)
        if (le0 is None and li0 is None and lc0 is None and lci0 is None
                and (me + ni + mc + mci) > 0):
            le, li, lc, lci = ls_multiplier_init(x, th, ccdata)
            li = jnp.where(li < 0, Kt, li) if ni else li
            lci = jnp.where(lci < 0, Kt, lci) if mci else lci
        else:
            le = (jnp.zeros((Kl, me), dtype) if le0 is None
                  else le0.astype(dtype))
            li = (jnp.full((Kl, ni), cfg.Ktol, dtype) if li0 is None
                  else li0.astype(dtype))
            lc = (jnp.zeros((mc,), dtype) if lc0 is None
                  else lc0.astype(dtype))
            lci = (jnp.full((mci,), cfg.Ktol, dtype) if lci0 is None
                   else lci0.astype(dtype))
        # ragged: inactive rows' multipliers pinned at exactly 0 (their
        # masked residuals/steps then keep them there forever)
        if me and emk:
            le = le * _em(th)
        if ni and imk:
            li = li * _im(th)

        # centrality ingredients for the adaptive barrier update ride the
        # initial KKT collective (the epilogue reads them from st.g —
        # see centrality_stats); needed at init for the edge case where
        # the very first inner check exits at muTol without any step
        want_cent = has_barrier and cfg.mu_strategy != "mehrotra"
        init_extras = []
        if want_cent:
            msk_c = _im(th) if (ni and imk) else None
            if ni:
                pr0 = (msk_c * s * li) if msk_c is not None else s * li
                init_extras.append(jnp.sum(pr0))
            else:
                init_extras.append(jnp.zeros((), dtype))
            if msk_c is not None:
                init_extras.append(jnp.sum(msk_c))
        if init_extras:
            kkt0, ext0 = kkt_norms_g(x, s, sc, le, li, lc, lci, th,
                                     ccdata, mu0,
                                     extras=tuple(init_extras))
            sl0 = ext0[0] + (jnp.sum(sc * lci) if mci
                             else jnp.zeros((), dtype))
            ntot0 = (ext0[1] + mci if (ni and imk)
                     else jnp.asarray(Kl * nglob * ni + mci, dtype))
            g0 = jnp.stack([sl0, ntot0])
        else:
            kkt0 = kkt_norms_g(x, s, sc, le, li, lc, lci, th, ccdata,
                               mu0)
            g0 = jnp.zeros((0,), dtype)
        f_past = (fval_g(x, th) if cfg.Ftol is not None
                  else jnp.zeros((), dtype))
        i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
        if use_lbfgs:
            # per-block compact memory: every field carries a leading
            # block axis (sharded with the blocks); x_old seeds the first
            # secant pair
            mems = cfg.lbfgs_mem
            lbfgs0 = LBFGSState(
                zeta=jnp.full((Kl,), cfg.zeta0, dtype),
                S=jnp.zeros((Kl, d, mems), dtype),
                Y=jnp.zeros((Kl, d, mems), dtype),
                count=jnp.zeros((Kl,), jnp.int32),
                fail=jnp.zeros((Kl,), jnp.int32))
            x_old0 = x
        else:
            lbfgs0 = lbfgs_init(0, 0, cfg.zeta0, dtype)
            x_old0 = jnp.zeros((0,), dtype)
        return SolverState(
            x=x, s=(s, sc), lda=(le, li, lc, lci),
            mu=mu0, nu=jnp.asarray(cfg.nu, dtype),
            delta=jnp.zeros((Kl,), dtype), kkt=kkt0,
            signal=i32(0), iter_count=i32(0), outer=i32(0),
            inner=i32(0), inner_done=jnp.zeros((), jnp.bool_),
            in_inner=jnp.zeros((), jnp.bool_),
            f_past=f_past, alpha=jnp.zeros((), dtype),
            reg_retries=i32(0),
            lbfgs=lbfgs0,
            x_old=x_old0, g=g0,
            hist=(lambda T: MetricsHistory(
                kkt=jnp.zeros((T, 4), dtype), mu=jnp.zeros((T,), dtype),
                nu=jnp.zeros((T,), dtype), alpha=jnp.zeros((T,), dtype),
                delta=jnp.zeros((T,), dtype)))(
                    cfg.niter * cfg.miter if cfg.trace_metrics else 0),
        )

    def local_finalize(st: SolverState, th, ccdata) -> BlockResult:
        le_f, li_f, lc_f, lci_f = st.lda
        s_f, sc_f = st.s
        return BlockResult(
            x=st.x, s=s_f, le=le_f, li=li_f, lc=lc_f, sc=sc_f,
            lci=lci_f,
            fval=fval_g(st.x, th), kkt=st.kkt, signal=st.signal,
            iter_count=st.iter_count, mu=st.mu, nu=st.nu, hist=st.hist)

    # ------------------------------------------------------------------
    blk = P(axis)            # leading K axis sharded over blocks
    rep = P()
    out_specs = BlockResult(
        x=blk, s=blk, le=blk, li=blk, lc=rep, sc=rep, lci=rep,
        fval=rep, kkt=rep,
        signal=rep, iter_count=rep, mu=rep, nu=rep,
        hist=MetricsHistory(kkt=rep, mu=rep, nu=rep, alpha=rep,
                            delta=rep))
    # SolverState sharding: per-block slabs on x/s/delta and the block
    # multipliers; everything else replicated (the checkpoint/pause unit
    # of the distributed solve)
    state_specs = SolverState(
        x=blk, s=(blk, rep), lda=(blk, blk, rep, rep), mu=rep, nu=rep,
        delta=blk,
        kkt=rep, signal=rep, iter_count=rep, outer=rep, inner=rep,
        inner_done=rep, in_inner=rep, f_past=rep, alpha=rep,
        reg_retries=rep,
        # in L-BFGS mode the per-block memory and x_old are block-sharded
        # slabs; otherwise they are empty replicated dummies
        lbfgs=jax.tree.map(lambda _: (blk if use_lbfgs else rep),
                           lbfgs_init(0, 0, 1.0, np.float32)),
        x_old=(blk if use_lbfgs else rep), g=rep,
        hist=MetricsHistory(kkt=rep, mu=rep, nu=rep, alpha=rep,
                            delta=rep))

    def _data_specs(theta_, ccdata_):
        return (jax.tree.map(lambda _: blk, theta_),
                jax.tree.map(lambda _: rep, ccdata_))

    def _prec(f):
        def wrapped(*a):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return f(*a)
        return wrapped

    _cache = {}

    def fn(x0, theta, ccdata=None, s0=None, le0=None, li0=None, lc0=None,
           lci0=None):
        # one compiled SPMD program per combination of supplied warm-start
        # arguments (None cannot cross the shard_map boundary as an array)
        opts = {"s0": s0, "le0": le0, "li0": li0, "lc0": lc0,
                "lci0": lci0}
        names = tuple(k for k, v in opts.items() if v is not None)
        if names not in _cache:
            def local(x0_, th_, ccd_, opt_):
                kw = {k: None for k in ("s0", "le0", "li0", "lc0",
                                        "lci0")}
                kw.update(opt_)
                # full-f32 matmuls (see IPMConfig.matmul_precision)
                with jax.default_matmul_precision(cfg.matmul_precision):
                    st = local_init(x0_, th_, ccd_, kw["s0"], kw["le0"],
                                    kw["li0"], kw["lc0"], kw["lci0"])
                    st = make_engine(th_, ccd_, x0_.shape[0]).run(st)
                    return local_finalize(st, th_, ccd_)

            def run(x0_, theta_, ccdata_, opt_):
                th_sp, cc_sp = _data_specs(theta_, ccdata_)
                opt_sp = {k: (rep if k in ("lc0", "lci0") else blk)
                          for k in opt_}
                sharded = jax.shard_map(
                    local, mesh=mesh,
                    in_specs=(blk, th_sp, cc_sp, opt_sp),
                    out_specs=out_specs, check_vma=False)
                return sharded(x0_, theta_, ccdata_, opt_)

            _cache[names] = jax.jit(run)
        opt = {k: v for k, v in opts.items() if v is not None}
        return _cache[names](x0, theta, ccdata, opt)

    # ---- pause/resume surface (the SolverState is the carry AND the
    # checkpoint unit, exactly as in the single-device solver core).
    # Each method builds its shard_map inside ONE cached jit wrapper so
    # repeated budgeted calls hit the compiled program.
    def _surface(name, local, in_specs_of, out_sp):
        if name not in _cache:
            def outer(*args):
                sharded = jax.shard_map(
                    _prec(local), mesh=mesh, in_specs=in_specs_of(*args),
                    out_specs=out_sp, check_vma=False)
                return sharded(*args)

            _cache[name] = jax.jit(outer)
        return _cache[name]

    def init_state(x0, theta, ccdata=None):
        return _surface(
            "init",
            lambda x0_, th_, ccd_: local_init(
                x0_, th_, ccd_, None, None, None, None),
            lambda x0_, th_, ccd_: (blk, *_data_specs(th_, ccd_)),
            state_specs)(x0, theta, ccdata)

    def run_budget(state, theta, ccdata=None, max_new_iters=1):
        return _surface(
            "run_budget",
            lambda st_, th_, ccd_, b_: make_engine(
                th_, ccd_, st_.x.shape[0]).run_budget(st_, b_),
            lambda st_, th_, ccd_, b_: (state_specs,
                                        *_data_specs(th_, ccd_), rep),
            state_specs)(state, theta, ccdata,
                         jnp.asarray(max_new_iters, jnp.int32))

    def run_state(state, theta, ccdata=None):
        return _surface(
            "run",
            lambda st_, th_, ccd_: make_engine(
                th_, ccd_, st_.x.shape[0]).run(st_),
            lambda st_, th_, ccd_: (state_specs,
                                    *_data_specs(th_, ccd_)),
            state_specs)(state, theta, ccdata)

    def finalize(state, theta, ccdata=None):
        return _surface(
            "finalize",
            lambda st_, th_, ccd_: local_finalize(st_, th_, ccd_),
            lambda st_, th_, ccd_: (state_specs,
                                    *_data_specs(th_, ccd_)),
            out_specs)(state, theta, ccdata)

    fn.init_state = init_state
    fn.run_budget = run_budget
    fn.run = run_state
    fn.finalize = finalize
    fn.config = cfg
    # the PartitionSpec tree of the SolverState carry — multi-host
    # checkpoint/restore needs it to rebuild sharded state arrays from
    # host-local (or replicated-host) data (tests/schur_worker.py)
    fn.state_specs = state_specs
    fn.mesh = mesh
    return fn


# ----------------------------------------------------------------------
# Backward-compatible specialized interface (box bounds + per-block eq +
# LINEAR coupling), now a thin adapter over the general solver.
@dataclasses.dataclass(frozen=True, eq=False)
class SeparableNLP:
    """Static description of a box/linear-coupling block-separable NLP
    (the round-2 interface, retained as a convenience constructor; the
    general class is :class:`BlockNLP`)."""
    f_blk: Callable          # (x_k (d,), theta_k) -> scalar
    d: int                   # per-block variable count
    mc: int                  # coupling equality constraints
    has_box: bool = True     # x_k >= lb_k bounds
    ce_blk: Optional[Callable] = None   # (x_k, theta_k) -> (me,)
    me: int = 0


class SeparableData(NamedTuple):
    """Per-instance data; leading axis K = number of blocks (sharded over
    the ``model`` mesh axis)."""
    theta: jnp.ndarray       # (K, ...) per-block objective params
    A: jnp.ndarray           # (K, mc, d) coupling Jacobian blocks
    b: jnp.ndarray           # (mc,) coupling rhs (replicated)
    lb: jnp.ndarray          # (K, d) lower bounds


class SeparableResult(NamedTuple):
    x: jnp.ndarray           # (K, d)
    s: jnp.ndarray           # (K, d) slacks (zeros if no box)
    z: jnp.ndarray           # (K, d) bound multipliers
    le: jnp.ndarray          # (K, me) per-block equality multipliers
    lc: jnp.ndarray          # (mc,) coupling multipliers
    fval: jnp.ndarray
    kkt: jnp.ndarray         # (4,) global KKT norms
    signal: jnp.ndarray
    iter_count: jnp.ndarray
    mu: jnp.ndarray
    nu: jnp.ndarray


def make_separable_solver(spec: SeparableNLP, mesh,
                          config: Optional[IPMConfig] = None,
                          axis: str = "model"):
    """Build the sharded solve for the box/linear-coupling special case.

    Returns ``fn(x0 (K, d), data: SeparableData) -> SeparableResult``.
    Adapter over :func:`make_block_solver` (bounds become ci_k = x - lb,
    the linear coupling becomes g_k = A_k x_k with cc(u) = u - b)."""
    ni = spec.d if spec.has_box else 0
    gspec = BlockNLP(
        f_blk=lambda xk, th: spec.f_blk(xk, th["user"]),
        d=spec.d,
        ce_blk=((lambda xk, th: spec.ce_blk(xk, th["user"]))
                if spec.me else None),
        me=spec.me,
        ci_blk=((lambda xk, th: xk - th["lb"]) if spec.has_box else None),
        ci_identity=spec.has_box,
        ni=ni,
        g_blk=lambda xk, th: th["A"] @ xk,
        cc=lambda u, ccd: u - ccd["b"],
        p=spec.mc, mc=spec.mc,
    )
    solve = make_block_solver(gspec, mesh, config, axis=axis)

    def fn(x0, data: SeparableData) -> SeparableResult:
        theta = {"user": data.theta, "A": data.A, "lb": data.lb}
        res = solve(x0, theta, ccdata={"b": data.b})
        z = res.li if spec.has_box else jnp.zeros_like(res.x)
        s = res.s if spec.has_box else jnp.zeros_like(res.x)
        return SeparableResult(
            x=res.x, s=s, z=z, le=res.le, lc=res.lc, fval=res.fval,
            kkt=res.kkt, signal=res.signal, iter_count=res.iter_count,
            mu=res.mu, nu=res.nu)

    return fn


# ----------------------------------------------------------------------
def sample_separable(key, K: int, d: int, mc: int, dtype=jnp.float32):
    """Random block-separable test instance: convex quadratic blocks +
    random coupling, x=lb+1 strictly feasible for the bounds and the
    coupling rhs chosen from a feasible point."""
    kq, kc, ka, kx = jax.random.split(key, 4)
    G = jax.random.normal(kq, (K, d, d), dtype) / float(np.sqrt(d))
    Q = jnp.einsum("kij,klj->kil", G, G) + jnp.eye(d, dtype=dtype)[None]
    c = jax.random.normal(kc, (K, d), dtype)
    A = jax.random.normal(ka, (K, mc, d), dtype) / float(np.sqrt(K * d))
    lb = jnp.full((K, d), -2.0, dtype)
    xfeas = jax.random.normal(kx, (K, d), dtype) * 0.1
    b = jnp.einsum("kcd,kd->c", A, xfeas)
    theta = {"Q": Q, "c": c}

    def f_blk(xk, th):
        return 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk

    spec = SeparableNLP(f_blk=f_blk, d=d, mc=mc, has_box=True)
    data = SeparableData(theta=theta, A=A, b=b, lb=lb)
    x0 = jnp.zeros((K, d), dtype)
    return spec, data, x0


def sample_separable_eq(key, K: int, d: int, mc: int, me: int = 1,
                        dtype=jnp.float32, has_box: bool = True):
    """Block-separable instance WITH per-block equality constraints
    (linear: Ck x_k = ek, chosen feasible at a reference point) on top of
    coupling + optional bounds — the eq-beyond-box structure."""
    kq, kc, ka, kx, ke = jax.random.split(key, 5)
    G = jax.random.normal(kq, (K, d, d), dtype) / float(np.sqrt(d))
    Q = jnp.einsum("kij,klj->kil", G, G) + jnp.eye(d, dtype=dtype)[None]
    c = jax.random.normal(kc, (K, d), dtype)
    A = jax.random.normal(ka, (K, mc, d), dtype) / float(np.sqrt(K * d))
    Ck = jax.random.normal(ke, (K, me, d), dtype) / float(np.sqrt(d))
    lb = jnp.full((K, d), -3.0, dtype)
    xfeas = jax.random.normal(kx, (K, d), dtype) * 0.1
    b = jnp.einsum("kcd,kd->c", A, xfeas)
    ek = jnp.einsum("kmd,kd->km", Ck, xfeas)
    theta = {"Q": Q, "c": c, "C": Ck, "e": ek}

    def f_blk(xk, th):
        return 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk

    def ce_blk(xk, th):
        return th["C"] @ xk - th["e"]

    spec = SeparableNLP(f_blk=f_blk, d=d, mc=mc, has_box=has_box,
                        ce_blk=ce_blk, me=me)
    data = SeparableData(theta=theta, A=A, b=b, lb=lb)
    x0 = jnp.zeros((K, d), dtype)
    return spec, data, x0


def sample_block_ragged(key, K: int, d: int = 4, me: int = 2, ni: int = 3,
                        p: int = 2, mc: int = 1, dtype=jnp.float64,
                        seed: int = 0):
    """Random RAGGED block NLP: per-block equality/inequality counts
    me_k in {1..me}, ni_k in {ni-1, ni} under static maxima (me, ni) with
    validity masks in theta ('ce_mask'/'ci_mask') — the mixed-shape fleet
    one compiled program must solve (reference pyipm.py:442-467 solves
    arbitrary per-problem shapes; here they coexist in ONE instance).
    Inactive rows of the generated constraint data are filled with junk
    on purpose: masking must make them invisible.  Returns
    (spec, theta, ccdata, x0, me_counts, ni_counts)."""
    kq, kc, ke, ki, kg, kx, km = jax.random.split(key, 7)
    rng = np.random.default_rng(seed)
    me_counts = rng.integers(1, me + 1, size=K)
    ni_counts = rng.integers(max(ni - 1, 1), ni + 1, size=K)
    ce_mask = (np.arange(me)[None, :] < me_counts[:, None]).astype(
        np.float64)
    ci_mask = (np.arange(ni)[None, :] < ni_counts[:, None]).astype(
        np.float64)

    Gq = jax.random.normal(kq, (K, d, d), dtype) / float(np.sqrt(d))
    Q = jnp.einsum("kij,klj->kil", Gq, Gq) + jnp.eye(d, dtype=dtype)[None]
    c = jax.random.normal(kc, (K, d), dtype)
    Ce = jax.random.normal(ke, (K, me, d), dtype) / float(np.sqrt(d))
    Ciq = jax.random.normal(ki, (K, ni, d), dtype) / float(np.sqrt(d))
    Gl = jax.random.normal(kg, (K, p, d), dtype) / float(np.sqrt(K * d))
    xfeas = jax.random.normal(kx, (K, d), dtype) * 0.1
    ee = jnp.einsum("kmd,kd->km", Ce, xfeas)
    di = 1.0 - jnp.einsum("knd,kd->kn", Ciq, xfeas)
    # junk in the inactive rows (rhs shifted so they'd be violated if
    # the masking ever leaked them into the solve)
    junk = 37.0
    ee = jnp.where(jnp.asarray(ce_mask) > 0, ee, junk)
    di = jnp.where(jnp.asarray(ci_mask) > 0, di, -junk)
    theta = {"Q": Q, "c": c, "Ce": Ce, "e": ee, "Ci": Ciq, "di": di,
             "G": Gl, "ce_mask": jnp.asarray(ce_mask, dtype),
             "ci_mask": jnp.asarray(ci_mask, dtype)}

    def f_blk(xk, th):
        return 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk

    def ce_blk(xk, th):
        return th["Ce"] @ xk - th["e"]

    def ci_blk(xk, th):
        return th["Ci"] @ xk + th["di"]

    def g_blk(xk, th):
        return th["G"] @ xk

    ufeas = jnp.sum(jax.vmap(g_blk)(xfeas, theta), axis=0)

    def cc(u, ccd):
        return (u - ccd["u0"])[:mc]

    ccdata = {"u0": ufeas}
    spec = BlockNLP(f_blk=f_blk, d=d, ce_blk=ce_blk, me=me,
                    ci_blk=ci_blk, ni=ni, g_blk=g_blk, cc=cc, p=p, mc=mc,
                    ce_mask_key="ce_mask", ci_mask_key="ci_mask")
    x0 = jnp.zeros((K, d), dtype)
    return spec, theta, ccdata, x0, me_counts, ni_counts


def sample_block_general(key, K: int, d: int, me: int = 1, ni: int = 2,
                         p: int = 2, mc: int = 1, mci: int = 0,
                         dtype=jnp.float64,
                         nonlinear_cc: bool = True):
    """Random GENERAL block NLP exercising every constraint class the
    reference supports (pyipm.py:29-36), block-separable: convex quadratic
    objectives, linear per-block equalities, general linear per-block
    inequalities (not bounds), and a coupling constraint cc(sum_k g_k(x_k))
    with quadratic pooled features and (optionally) nonlinear cc —
    constructed feasible at a reference point.  Returns
    (spec, theta, ccdata, x0)."""
    kq, kc, ke, ki, kg, kx = jax.random.split(key, 6)
    Gq = jax.random.normal(kq, (K, d, d), dtype) / float(np.sqrt(d))
    Q = jnp.einsum("kij,klj->kil", Gq, Gq) + jnp.eye(d, dtype=dtype)[None]
    c = jax.random.normal(kc, (K, d), dtype)
    Ce = jax.random.normal(ke, (K, me, d), dtype) / float(np.sqrt(d))
    Ciq = jax.random.normal(ki, (K, ni, d), dtype) / float(np.sqrt(d))
    Gl = jax.random.normal(kg, (K, p, d), dtype) / float(np.sqrt(K * d))
    xfeas = jax.random.normal(kx, (K, d), dtype) * 0.1
    ee = jnp.einsum("kmd,kd->km", Ce, xfeas)
    # ci(xfeas) = 1 > 0 strictly feasible
    di = 1.0 - jnp.einsum("knd,kd->kn", Ciq, xfeas)
    theta = {"Q": Q, "c": c, "Ce": Ce, "e": ee, "Ci": Ciq, "di": di,
             "G": Gl}

    def f_blk(xk, th):
        return 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk

    def ce_blk(xk, th):
        return th["Ce"] @ xk - th["e"]

    def ci_blk(xk, th):
        return th["Ci"] @ xk + th["di"]

    def g_blk(xk, th):
        # quadratic pooled features -> nonzero per-block coupling Hessian
        base = th["G"] @ xk
        return base + 0.05 * base ** 2

    ufeas = jnp.sum(jax.vmap(g_blk)(xfeas, theta), axis=0)

    if nonlinear_cc:
        def cc(u, ccd):
            # nonlinear coupling with nonzero Hu once lc != 0
            v = u - ccd["u0"]
            return (v[:mc] + 0.1 * jnp.sum(v ** 2)
                    * jnp.ones((mc,), v.dtype))
    else:
        def cc(u, ccd):
            return (u - ccd["u0"])[:mc]

    ccdata = {"u0": ufeas}
    if mci:
        def cci(u, ccd):
            # nonlinear global caps, strictly feasible at xfeas (=0.5)
            v = u - ccd["u0"]
            return 0.5 - (v[:mci] + 0.05 * jnp.sum(v ** 2)
                          * jnp.ones((mci,), v.dtype))
    else:
        cci = None
    # zero-count classes: drop the corresponding callables so every
    # constraint-class combination (incl. eq-only, ineq-only, no-eq-
    # coupling) is generatable for the combo-fuzz tests
    spec = BlockNLP(f_blk=f_blk, d=d,
                    ce_blk=ce_blk if me else None, me=me,
                    ci_blk=ci_blk if ni else None, ni=ni,
                    g_blk=g_blk if (mc or mci) else None,
                    cc=cc if mc else None, p=p if (mc or mci) else 0,
                    mc=mc, cci=cci, mci=mci,
                    linear_coupling=not nonlinear_cc)
    x0 = jnp.zeros((K, d), dtype)
    return spec, theta, ccdata, x0
