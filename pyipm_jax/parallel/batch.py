"""Scenario batching: many independent NLP instances solved in lockstep,
plus wave-compacted batching that retires converged instances early.

The reference has no batching story at all (single host loop, reference
pyipm.py:1658); this is the DP-analog layer of the design
(SURVEY.md §2): one jitted solver, ``vmap`` over a leading instance axis,
optionally sharded over the ``batch`` axis of a device mesh so XLA splits
instances across chips with zero collectives (embarrassingly parallel).

Because the solver core is a fixed-bound ``lax.while_loop``, vmap handles
per-instance convergence automatically: finished instances are masked while
stragglers iterate, and the batch retires when the last instance exits.
Per-instance status (``signal``) and iteration counts come back in the
batched :class:`SolverResult`.

**The straggler tax and wave compaction.**  Under plain vmap the lockstep
while_loop makes every instance pay for every iteration until the LAST
straggler exits: on a 10k-instance fleet with mean ~11 iterations but a
max of ~200, only ~5% of the paid iteration slots are useful work.  The
wave-compacted solver (:func:`make_wave_batch_solver`) exploits the solver
core's pause/resume support (core/solver.py ``run_budget``): run everyone
for a bounded first wave, then repeatedly gather the still-active
instances into a small compact batch (padded to a bucketed size so
compilations are cached) and resume only those.  Converged instances stop
paying immediately; results are bit-reproducible per wave partition and
match straight-through solves to float roundoff.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyipm_jax.config import IPMConfig
from pyipm_jax.core.problem import Problem
from pyipm_jax.core.solver import SolverResult, make_solver


def make_batch_solver(problem: Problem, config: Optional[IPMConfig] = None,
                      *, with_s0: bool = False, with_lda0: bool = False,
                      mesh: Optional[jax.sharding.Mesh] = None,
                      batch_axis: str = "batch"):
    """vmapped (and optionally mesh-sharded) solver.

    Returns ``fn(x0_batch[, s0_batch][, lda0_batch]) -> SolverResult`` with a
    leading batch axis on every output.  With ``mesh``, inputs/outputs are
    sharded over ``batch_axis`` via NamedSharding so instances parallelize
    across devices.
    """
    cfg = config if config is not None else IPMConfig()
    if cfg.verbosity > 0:
        # per-iteration debug prints are meaningless interleaved across a
        # batch; silence them (final reporting happens host-side).
        cfg = cfg.replace(verbosity=0)
    base = make_solver(problem, cfg, with_s0=with_s0, with_lda0=with_lda0,
                       jit=False)
    vmapped = jax.vmap(base)
    if mesh is None:
        return jax.jit(vmapped)
    batch_sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(batch_axis))
    replicated = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec())

    nargs = 1 + int(with_s0) + int(with_lda0)
    jitted = jax.jit(vmapped, in_shardings=(batch_sharding,) * nargs)

    def fn(*args):
        args = tuple(jax.device_put(a, batch_sharding) for a in args)
        return jitted(*args)

    return fn


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def make_wave_batch_solver(problem: Optional[Problem] = None,
                           config: Optional[IPMConfig] = None, *,
                           family: Optional[Callable] = None,
                           first_wave: int = 16, wave: int = 32,
                           wave_growth: float = 1.0,
                           max_wave: int = 512,
                           min_pad: int = 64, max_waves: int = 1000):
    """Batched solver that retires converged instances in waves.

    Exactly one of ``problem`` (every instance shares one Problem) or
    ``family`` (``data -> Problem``; per-instance data pytrees batched on
    axis 0) must be given.

    Returns ``fn(x0_batch[, data_batch]) -> SolverResult`` (``data_batch``
    present iff ``family`` is used).  Algorithmically identical to the
    lockstep :func:`make_batch_solver` — the solver core's flattened loop
    pauses after ``first_wave`` iterations and resumes only still-active
    instances in compact waves of ``wave`` further iterations, so finished
    instances stop consuming device slots.  Active sets are compacted with
    a stable argsort on ``signal`` and padded up to a power-of-two bucket
    (≥ ``min_pad``) so each distinct compiled shape is hit once and cached;
    pad slots hold already-converged instances, for which the resumed
    while_loop is a no-op and the scatter writes back unchanged state.

    Compaction runs ON DEVICE: each wave is one jitted
    argsort+gather+resume+scatter program (one compilation per pow-2
    bucket size), and the only per-wave host sync is a scalar
    active-count fetch that sizes the next bucket and decides loop exit.
    """
    assert (problem is None) != (family is None), \
        "give exactly one of problem= or family="
    cfg = config if config is not None else IPMConfig()
    if cfg.verbosity > 0:
        cfg = cfg.replace(verbosity=0)
    with_data = family is not None
    if not with_data:
        def family(_):                      # noqa: F811 — unify the paths
            return problem

    def _base(data):
        return make_solver(family(data), cfg, jit=False)

    def init_one(x0, data):
        return _base(data).init_state(x0)

    def runb_one(st, data, budget):
        return _base(data).run_budget(st, budget)

    def fin_one(st, data):
        return _base(data).finalize(st)

    runb_v = jax.vmap(runb_one, in_axes=(0, 0, None))
    fin_raw = jax.vmap(fin_one)
    fin_v = jax.jit(fin_raw)

    # Every wave dispatch returns (state, active-count, OPTIMISTIC
    # result): finalize is a handful of elementwise reads, so computing
    # it unconditionally inside the same program means the common case —
    # the whole fleet converged in this wave — needs NO further device
    # round-trip or finalize dispatch.
    @jax.jit
    def init_and_first(x0_batch, data_batch, budget):
        st = jax.vmap(init_one)(x0_batch, data_batch)
        st = runb_v(st, data_batch, budget)
        return st, jnp.sum(st.signal == 0), fin_raw(st, data_batch)

    # ON-DEVICE wave compaction: the whole wave —
    # stable argsort on signal, gather of the P-instance active set,
    # budgeted resume, scatter back — is ONE jitted program per bucket
    # size P, and the only per-wave host traffic is the returned
    # active-count scalar (which both sizes the next bucket and decides
    # loop exit).  The previous host-driven form fetched the full (B,)
    # signal vector, argsorted on host, and dispatched gather/run/scatter
    # as three separate calls per wave.
    _wave_steps = {}

    def _wave_step(P):
        if P not in _wave_steps:
            @jax.jit
            def step(st, data_batch, budget):
                # actives first (original order — argsort is stable);
                # tail padded with converged instances for which the
                # resumed while_loop is a no-op and the scatter writes
                # back unchanged state
                idx = jnp.argsort(st.signal != 0)[:P].astype(jnp.int32)
                g = lambda a: jnp.take(a, idx, axis=0)      # noqa: E731
                sub = runb_v(jax.tree.map(g, st),
                             jax.tree.map(g, data_batch), budget)
                st = jax.tree.map(lambda a, b: a.at[idx].set(b), st, sub)
                return (st, jnp.sum(st.signal == 0),
                        fin_raw(st, data_batch))

            _wave_steps[P] = step
        return _wave_steps[P]

    def fn(x0_batch, data_batch=None):
        B = x0_batch.shape[0]
        if data_batch is None:
            assert not with_data, "this solver requires a data_batch"
            data_batch = jnp.zeros((B, 0), x0_batch.dtype)
        def _prefetch(r):
            # start the result scalars' device->host copies BEFORE
            # blocking on the active count: the caller's first fetch
            # (signal/iter_count stats) then overlaps the count's
            # round-trip instead of paying its own
            for leaf in (r.signal, r.iter_count):
                try:
                    leaf.copy_to_host_async()
                except AttributeError:
                    pass

        st, n_act_dev, res = init_and_first(
            x0_batch, data_batch, jnp.asarray(first_wave, jnp.int32))
        wv = float(wave)
        for _ in range(max_waves):
            _prefetch(res)
            n_act = int(n_act_dev)             # the one host sync per wave
            if n_act == 0:
                return res                     # finalized on device already
            P = min(B, max(min_pad, _next_pow2(n_act)))
            st, n_act_dev, res = _wave_step(P)(
                st, data_batch, jnp.asarray(int(wv), jnp.int32))
            # optional geometric growth: the straggler tail is a few % of
            # instances, so later waves trade wasted slots for fewer
            # host syncs/dispatches (budget is a runtime arg — no new
            # compile per size).  The cap bounds only the GROWN value —
            # a caller-tuned wave larger than max_wave is never shrunk.
            wv = min(wv * wave_growth, float(max(max_wave, wave)))
        # defensive: finish any remainder unbudgeted (unreachable for
        # sane wave sizes — every wave makes progress toward the niter
        # bound, at which the solver core always sets a signal)
        run_v = jax.jit(jax.vmap(
            lambda st_, d_: _base(d_).run(st_)))
        st = run_v(st, data_batch)
        return fin_v(st, data_batch)

    return fn


def solve_batch(problem: Problem, x0_batch, config: Optional[IPMConfig] = None,
                s0=None, lda0=None,
                mesh: Optional[jax.sharding.Mesh] = None) -> SolverResult:
    """One-shot batched solve over a leading instance axis of ``x0_batch``."""
    fn = make_batch_solver(problem, config, with_s0=s0 is not None,
                           with_lda0=lda0 is not None, mesh=mesh)
    args = [jnp.asarray(x0_batch)]
    if s0 is not None:
        args.append(jnp.asarray(s0))
    if lda0 is not None:
        args.append(jnp.asarray(lda0))
    return fn(*args)


# Bounded jitted-rescue-solver cache (insertion-ordered dict as LRU).
# Keyed on (family, config, shapes): ``family`` must be a STABLE callable —
# callers constructing a fresh lambda per call never hit the cache, pay the
# multi-second trace every rescue, and (before the bound) leaked one jitted
# vmapped solver + its executables per miss.  The bound evicts the
# least-recently-used entry past 16 distinct (family, config, shape)
# combinations — far above any realistic serving mix, tiny if exceeded.
_rescue_solver_cache = {}
_RESCUE_CACHE_MAX = 16


def rescue_failures(result: SolverResult, x0_batch, config: IPMConfig,
                    family: Callable, data_batch,
                    rescue_config: Optional[IPMConfig] = None):
    """Re-solve the instances a batched run did NOT converge (signal not
    in {1, 2}) under a fresh, stronger configuration and scatter the
    successes back.

    The r03 failure-tail analysis (benchmarks/results/r03/
    bench_headline.json) found every straggler of the 10k-QP fleet —
    line-search aborts (-2) and budget-outs (-1) alike — recovers under a
    fresh Mehrotra solve with a raised outer budget; this helper makes
    that rescue a one-call library pattern (hit rate 1.0000 there).

    Args:
      result: the batched SolverResult to repair.
      x0_batch: the original starts (rescues restart cold by default).
      config: the config the batch ran under (basis for the default
        rescue config).
      family: ``data -> Problem`` (same contract as
        :func:`make_wave_batch_solver`).  Must be a STABLE callable
        (module-level function or a lambda hoisted outside the call
        site): the warm-rescue cache keys on its identity, so a fresh
        lambda per call re-traces the solver every rescue (~seconds).
      data_batch: per-instance data pytree, leading axis = instance.
      rescue_config: override; default = ``config`` with
        mu_strategy='auto' and a 3x outer budget.

    Returns ``(merged_result, n_failed, n_rescued)``.
    """
    sigs = np.asarray(result.signal)
    fail_idx = np.flatnonzero(~np.isin(sigs, (1, 2)))
    if fail_idx.size == 0:
        return result, 0, 0
    rcfg = (rescue_config if rescue_config is not None
            else config.replace(mu_strategy="auto",
                                niter=3 * config.niter))
    idx = jnp.asarray(fail_idx, jnp.int32)
    # pad the fail set up to a power-of-two bucket (>= 32) by REPEATING
    # the last failure, exactly the wave solver's shape-bucketing trick:
    # rescue fleets of 9, 11, or 13 stragglers all compile (and hit the
    # persistent compilation cache as) ONE shape, so repeated rescues are
    # a cached sub-second call instead of a fresh multi-second compile
    # per distinct fail count (r03 measured 8-22 s to rescue 11).  The
    # padded solve result is sliced back to the true fail count before
    # merging — duplicates never touch the scatter.
    nf = int(fail_idx.size)
    P = min(sigs.size, max(32, _next_pow2(nf)))
    pad_idx = np.concatenate(
        [fail_idx, np.full(max(P - nf, 0), fail_idx[-1], fail_idx.dtype)])
    # gather ON DEVICE: np.asarray(full_batch)[pad_idx] would pull the
    # whole 10k-instance data pytree through the host transfer
    # just to select a few rows
    pj = jnp.asarray(pad_idx, jnp.int32)
    sub_data = jax.tree.map(
        lambda a: jnp.take(jnp.asarray(a), pj, axis=0), data_batch)
    sub_x0 = jnp.take(jnp.asarray(x0_batch), pj, axis=0)

    # jitted-rescue-solver cache: re-tracing the vmapped solver costs
    # seconds; with the pow-2 shape bucketing above, repeat rescues with
    # the same family/config hit this cache and run warm (the XLA binary
    # additionally persists via the compilation cache across processes).
    # Shape key from metadata only — no device->host materialization.
    shape_key = tuple(
        (tuple(jnp.shape(a)), np.dtype(a.dtype).name)
        for a in jax.tree.leaves((sub_x0, sub_data)))
    cache_key = (family, rcfg, shape_key)
    solver = _rescue_solver_cache.pop(cache_key, None)
    if solver is None:
        def rescue_one(x0_i, data_i):
            return make_solver(family(data_i), rcfg.replace(verbosity=0),
                               jit=False)(x0_i)

        solver = jax.jit(jax.vmap(rescue_one))
        while len(_rescue_solver_cache) >= _RESCUE_CACHE_MAX:
            _rescue_solver_cache.pop(next(iter(_rescue_solver_cache)))
    _rescue_solver_cache[cache_key] = solver   # (re)insert most-recent

    rres = solver(sub_x0, sub_data)
    rres = jax.tree.map(lambda a: a[:nf], rres)
    rsig = np.asarray(rres.signal)
    ok = np.isin(rsig, (1, 2))
    # scatter back only the successes (failed rescues keep the original
    # diagnostic signal)
    okj = jnp.asarray(ok)

    def merge(a, b):
        if a.shape[1:] != b.shape[1:]:
            # unmergeable under differing budgets (metric histories):
            # keep the original buffers
            return a
        sel = okj.reshape((-1,) + (1,) * (b.ndim - 1))
        patched = jnp.where(sel, b, jnp.take(a, idx, axis=0))
        return a.at[idx].set(patched)

    merged = jax.tree.map(merge, result, rres)
    return merged, int(fail_idx.size), int(np.sum(ok))
