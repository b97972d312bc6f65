"""Profiling and observability.

The reference has no instrumentation at all (SURVEY.md §5: no timers, no
trace hooks).  Subsystem:

  - :func:`trace` — context manager around ``jax.profiler.trace`` dumping a
    TensorBoard/Perfetto trace directory;
  - :func:`annotate` — ``jax.named_scope`` wrapper so factorize/solve/line-
    search phases are labeled in traces;
  - :func:`profile_solve` — structured timing/cost report for any jittable
    solve: compile wall vs steady-state execute wall, XLA-estimated FLOPs
    and HBM bytes (and the derived achieved GFLOP/s and arithmetic
    intensity), iteration throughput from the result's ``iter_count``;
  - :func:`iteration_report` — per-iteration table (KKT norms, mu, nu,
    alpha, delta) from a ``trace_metrics=True`` solve's history buffers;
  - :func:`enable_nan_debugging` — process-wide ``jax_debug_nans``.  The
    cheap ALWAYS-ON guard is in the solver itself: a per-iteration
    finiteness check on the iterate that terminates with signal -3
    (see ``IPMConfig.nan_guard``) instead of silently iterating on NaNs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    with jax.profiler.trace(logdir):
        yield


def annotate(name: str):
    """Named scope for trace readability: with annotate('kkt-factor'): ..."""
    return jax.named_scope(name)


def enable_nan_debugging(enable: bool = True):
    jax.config.update("jax_debug_nans", enable)


# ----------------------------------------------------------------------
@dataclasses.dataclass
class SolveProfile:
    """Structured result of :func:`profile_solve`."""
    compile_s: float            # first-call wall (trace + compile + run)
    execute_s: float            # median steady-state wall
    reps: int
    flops: Optional[float]      # XLA cost-analysis estimate (per call)
    hbm_bytes: Optional[float]  # XLA cost-analysis bytes accessed
    gflops_per_s: Optional[float]
    arithmetic_intensity: Optional[float]   # flops / byte
    total_iters: Optional[int]  # summed iter_count if the result has one
    iters_per_s: Optional[float]
    backend: str

    def __str__(self):
        lines = [
            f"compile {self.compile_s:.3f}s | execute {self.execute_s * 1e3:.2f}ms"
            f" (median of {self.reps}) on {self.backend}",
        ]
        if self.flops is not None:
            lines.append(
                f"XLA cost: {self.flops / 1e9:.3f} GFLOP, "
                f"{(self.hbm_bytes or 0) / 1e6:.2f} MB accessed"
                + (f" -> {self.gflops_per_s:.1f} GFLOP/s, "
                   f"AI {self.arithmetic_intensity:.2f} flop/B"
                   if self.gflops_per_s is not None else ""))
        if self.total_iters is not None:
            lines.append(f"{self.total_iters} solver iterations"
                         + (f" -> {self.iters_per_s:.1f} iters/s"
                            if self.iters_per_s else ""))
        return "\n".join(lines)


def profile_solve(fn: Callable, *args, reps: int = 5) -> SolveProfile:
    """Profile one jitted solve end-to-end.

    ``fn`` is jitted if it is not already; ``args`` are passed through.
    Returns compile wall, median execute wall, XLA's static FLOP/byte
    estimates for the compiled executable (when the backend reports them),
    and iteration throughput if the result carries an ``iter_count``.
    """
    jfn = fn if hasattr(fn, "lower") else jax.jit(fn)

    t0 = time.perf_counter()
    out = jax.block_until_ready(jfn(*args))
    compile_s = time.perf_counter() - t0

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(jfn(*args))
        walls.append(time.perf_counter() - t0)
    execute_s = float(np.median(walls))

    flops = hbm = None
    try:
        cost = jfn.lower(*args).compile().cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        if cost:
            flops = float(cost.get("flops", 0.0)) or None
            hbm = float(cost.get("bytes accessed", 0.0)) or None
    except Exception:
        pass

    total_iters = None
    iters_per_s = None
    ic = getattr(out, "iter_count", None)
    if ic is not None:
        total_iters = int(np.sum(np.asarray(ic)))
        iters_per_s = total_iters / execute_s if execute_s > 0 else None

    return SolveProfile(
        compile_s=compile_s, execute_s=execute_s, reps=reps,
        flops=flops, hbm_bytes=hbm,
        gflops_per_s=(flops / execute_s / 1e9
                      if flops and execute_s > 0 else None),
        arithmetic_intensity=(flops / hbm if flops and hbm else None),
        total_iters=total_iters, iters_per_s=iters_per_s,
        backend=jax.default_backend(),
    )


def iteration_report(result) -> str:
    """Per-iteration table from a ``trace_metrics=True`` solve.

    ``result`` is a SolverResult whose ``hist`` buffers were recorded
    (IPMConfig(trace_metrics=True)); returns a formatted table of the
    recorded iterations."""
    hist = result.hist
    n = int(result.iter_count)
    if hist.kkt.shape[0] == 0:
        return ("no metrics recorded — solve with "
                "IPMConfig(trace_metrics=True)")
    kkt = np.asarray(hist.kkt)[:n]
    mu = np.asarray(hist.mu)[:n]
    nu = np.asarray(hist.nu)[:n]
    alpha = np.asarray(hist.alpha)[:n]
    delta = np.asarray(hist.delta)[:n]
    head = (f"{'it':>4} {'|dLdx|':>10} {'|dLds|':>10} {'|ce|':>10} "
            f"{'|ci-s|':>10} {'mu':>10} {'nu':>10} {'alpha':>8} "
            f"{'delta':>8}")
    rows = [head, "-" * len(head)]
    for t in range(n):
        rows.append(
            f"{t + 1:>4} {kkt[t, 0]:>10.3e} {kkt[t, 1]:>10.3e} "
            f"{kkt[t, 2]:>10.3e} {kkt[t, 3]:>10.3e} {mu[t]:>10.3e} "
            f"{nu[t]:>10.3e} {alpha[t]:>8.3f} {delta[t]:>8.1e}")
    return "\n".join(rows)
