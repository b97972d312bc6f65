"""Heterogeneous fleet solving: bucket-by-shape dispatch (the EP analog).

The reference solves arbitrary per-problem shapes one at a time (a fresh
host loop per problem; reference pyipm.py:1567-1590 re-derives nvar each
solve).  SURVEY.md §2 defines the expert-parallelism analog as
heterogeneous per-instance problem dispatch in batched mode — bucketing by
(D, M, N) and padding within buckets.  This module implements it:

:func:`solve_fleet` takes a list of :class:`Problem` instances (arbitrary
mixed shapes and callables) plus per-instance starts and solves the whole
fleet, batching everything batchable:

1. **Closure lifting.**  Two different Problem objects produced by the
   same code path (e.g. a family builder closing over per-instance arrays)
   have different Python closures — not directly vmappable.  Each callable
   is traced once to a jaxpr; the closed-over arrays pop out as jaxpr
   *consts* (instance data), and the jaxpr text becomes a structural
   fingerprint.  Instances whose callables share jaxprs and const/problem
   shapes are provably the same computation on different data.
2. **Bucketing.**  Instances are grouped by that fingerprint — which
   subsumes (D, M, N) — so each bucket is one compiled program.
3. **Batched dispatch.**  Multi-instance buckets run through the
   wave-compacted batch solver (parallel/batch.py) with the stacked consts
   as the per-instance data, padded up to a power-of-two batch so distinct
   compiled shapes stay few and cached (pad slots replicate an existing
   instance and are dropped on reassembly).  Singleton buckets use the
   plain single-instance solver.
4. **Reassembly.**  Results come back as a list of per-instance
   :class:`SolverResult` in the original order, exactly what a loop of
   single solves would produce.

Because grouping keys on traced structure, fleets mixing many shapes and
many families "just work": same-family/same-shape instances fuse into
vmapped buckets; everything else degrades gracefully to single solves.
Instance data must be closed over as jax/numpy arrays to be lifted —
Python scalars are baked into the jaxpr as literals and split buckets.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.core import eval_jaxpr

from pyipm_jax.config import IPMConfig
from pyipm_jax.core.problem import Problem
from pyipm_jax.core.solver import SolverResult, make_solver
from pyipm_jax.parallel.batch import make_wave_batch_solver

# Problem callables that take x only vs (x, lda).
_X_FIELDS = ("f", "ce", "ci", "df", "d2f", "dce", "dci")
_XL_FIELDS = ("d2ce", "d2ci")


def _lift(fn, avals):
    """Trace ``fn`` at ``avals``; return (fingerprint, consts, jaxpr)."""
    closed = jax.make_jaxpr(fn)(*avals)
    fp = (str(closed.jaxpr),
          tuple((tuple(np.shape(c)), np.result_type(c).name)
                for c in closed.consts))
    return fp, [jnp.asarray(c) for c in closed.consts], closed.jaxpr


def _rebind(jaxpr):
    """Callable (consts, *args) evaluating ``jaxpr`` with the given consts
    (vmappable: consts may be tracers)."""
    def call(consts, *args):
        out = eval_jaxpr(jaxpr, consts, *args)
        return out[0] if len(out) == 1 else out
    return call


class _LiftedInstance:
    """One problem reduced to (structural fingerprint, data consts)."""

    def __init__(self, prob: Problem, dtype):
        x_aval = jax.ShapeDtypeStruct((prob.nvar,), dtype)
        l_aval = jax.ShapeDtypeStruct((prob.ncon,), dtype)
        self.shape = (prob.nvar, prob.neq, prob.nineq)
        fps, self.consts, self.jaxprs, self.fields = [], [], [], []
        for name in _X_FIELDS + _XL_FIELDS:
            fn = getattr(prob, name)
            if fn is None:
                continue
            avals = (x_aval,) if name in _X_FIELDS else (x_aval, l_aval)
            fp, consts, jaxpr = _lift(fn, avals)
            fps.append((name, fp))
            self.consts.append(tuple(consts))
            self.jaxprs.append(jaxpr)
            self.fields.append(name)
        self.key = (self.shape, tuple(fps))
        self.data = tuple(self.consts)   # pytree of per-instance arrays


def _bucket_problem(inst: _LiftedInstance, data) -> Problem:
    """Rebuild a Problem from a bucket's shared jaxprs + (possibly traced)
    per-instance data."""
    D, M, N = inst.shape
    kw = {}
    for name, jaxpr, consts in zip(inst.fields, inst.jaxprs, data):
        call = _rebind(jaxpr)
        if name in _X_FIELDS:
            kw[name] = (lambda x, c=consts, cl=call: cl(list(c), x))
        else:
            kw[name] = (lambda x, l, c=consts, cl=call: cl(list(c), x, l))
    return Problem(nvar=D, neq=M, nineq=N, **kw)


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _slice_result(res: SolverResult, i) -> SolverResult:
    return jax.tree.map(lambda a: a[i], res)


def solve_fleet(problems: Sequence[Problem], x0s: Sequence,
                config: Optional[IPMConfig] = None, *,
                first_wave: int = 16, wave: int = 32,
                min_batch: int = 2) -> List[SolverResult]:
    """Solve a heterogeneous fleet of NLPs, batching all batchable work.

    Args:
      problems: one :class:`Problem` per instance; shapes (D, M, N) and
        callables may differ arbitrarily across instances.
      x0s: per-instance initial points, ``x0s[i].shape == (problems[i].nvar,)``.
      config: shared solver configuration (one config for the whole fleet).
      first_wave / wave: wave-compaction budgets for batched buckets
        (see :func:`pyipm_jax.parallel.batch.make_wave_batch_solver`).
      min_batch: buckets smaller than this run as single solves.

    Bucketing contract: instances batch together only when their LIFTED
    JAXPRS match textually (``str(jaxpr)`` fingerprint) — i.e. the same
    f/ce/ci computation traced at the same shapes/dtypes.  The
    fingerprint is ALPHA-CANONICAL: jaxpr printing assigns variable
    names at print time in order of appearance, so structurally
    identical problems built through different code paths (different
    lambdas, different intermediate naming) produce identical
    fingerprints and share a bucket (pinned by
    tests/test_fleet.py::test_cross_code_path_bucketing).  Problems that
    genuinely differ in operations, literals baked from Python scalars,
    or shapes split buckets — which splits work but never changes
    results; worst case is a lockstep batch of 1.

    Returns:
      ``list[SolverResult]`` in the original instance order, matching what
      a loop of single-instance solves would produce.
    """
    cfg = config if config is not None else IPMConfig()
    cfg = cfg.replace(verbosity=min(cfg.verbosity, 0))
    dtype = np.dtype(cfg.float_dtype)
    if dtype == np.float64 and not jax.config.jax_enable_x64:
        # f64 requires the x64 flag (same policy as make_solver); lifting
        # traces user callables before make_solver would flip it.
        jax.config.update("jax_enable_x64", True)
    n = len(problems)
    assert len(x0s) == n, "one x0 per problem"

    lifted = [_LiftedInstance(p, dtype) for p in problems]
    buckets = {}
    for i, li in enumerate(lifted):
        buckets.setdefault(li.key, []).append(i)

    results: List[Optional[SolverResult]] = [None] * n
    for idx in buckets.values():
        rep = lifted[idx[0]]
        if len(idx) < min_batch:
            fn = make_solver(problems[idx[0]], cfg)
            for i in idx:
                results[i] = fn(jnp.asarray(x0s[i], dtype))
            continue

        B = len(idx)
        P = _next_pow2(B)
        # pad with replicas of the first instance; dropped on reassembly
        pad_idx = idx + [idx[0]] * (P - B)
        data = jax.tree.map(lambda *a: jnp.stack(a),
                            *[lifted[i].data for i in pad_idx])
        x0b = jnp.stack([jnp.asarray(x0s[i], dtype) for i in pad_idx])
        solver = make_wave_batch_solver(
            config=cfg, family=lambda d, rep=rep: _bucket_problem(rep, d),
            first_wave=first_wave, wave=wave,
            min_pad=min(P, 64))
        res = solver(x0b, data)
        for k, i in enumerate(idx):
            results[i] = _slice_result(res, k)
    return results
