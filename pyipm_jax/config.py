"""Solver configuration.

Mirrors every constructor hyperparameter of the reference solver
(reference pyipm.py:311-376, docstring pyipm.py:83-212) as a frozen, hashable
dataclass so it can be a static argument under `jax.jit`.

Defaults match the reference bit-for-bit where meaningful:
mu=0.2, nu=10.0, rho=0.1, tau=0.995, eta=1e-4, beta=0.4, miter=20, niter=10,
Ktol=1e-4, Xtol=machine-eps, Ftol=None (off), lbfgs off, lbfgs_zeta=1.0,
float64, verbosity=1 (reference pyipm.py:311-314, 336-372).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """All solver knobs. Hashable ⇒ usable as a jit static argument.

    Additional knobs beyond the reference surface:
      - ``linear_solver``: 'lu' reproduces the reference's dense
        solve-after-eigendecomposition flow (pyipm.py:1373-1406, 1720);
        'ldlt' factors once per regularization retry with inertia read off
        the pivots (Sylvester's law) — the fast path.
      - ``max_reg_retries``: bound on the delta*=10 escalation loop
        (the reference loop at pyipm.py:1399-1403 is unbounded).
    """

    mu: float = 0.2            # barrier parameter init (pyipm.py:161-162)
    nu: float = 10.0           # merit penalty init (pyipm.py:163-164)
    rho: float = 0.1           # nu update factor (pyipm.py:165-167)
    tau: float = 0.995         # fraction-to-boundary / backtracking (pyipm.py:168-170)
    eta: float = 1.0e-4        # Armijo parameter (pyipm.py:171-173)
    beta: float = 0.4          # eq-block regularization power (pyipm.py:174-176)
    miter: int = 20            # inner iterations per outer (pyipm.py:177-179)
    niter: int = 10            # outer iterations (pyipm.py:180-182)
    Xtol: Optional[float] = None   # OBSOLETE, accepted for parity: the
    #   reference uses Xtol only as the golden-section tolerance of its
    #   fraction-to-the-boundary search (pyipm.py:183-186, 1429-1432);
    #   this framework computes the FTB step in closed form (exactly), so
    #   there is no approximation to tolerate.  Validated, never read.
    Ktol: float = 1.0e-4       # KKT tolerance (pyipm.py:187-189)
    Ftol: Optional[float] = None   # f-change tolerance, off by default (pyipm.py:190-194)
    lbfgs: int = 0             # L-BFGS memory; 0/False = exact Hessian (pyipm.py:195-199)
    lbfgs_zeta: Optional[float] = None  # initial Hessian scaling (pyipm.py:200-204)
    float_dtype: str = "float64"   # universal float precision (pyipm.py:205-209)
    verbosity: int = 1         # -1..3 (pyipm.py:210-212)

    # --- extensions (absent in the reference) ---
    matmul_precision: str = "highest"  # float32 matmul precision of the
    #                                    solver (see __post_init__)
    mu_min: Optional[float] = None  # barrier floor; default eps (f64) /
    #                                 eps**0.75 (f32) — see mu_floor
    mu_strategy: str = "adaptive"  # 'adaptive' = the reference's per-outer
    #   Fiacco-McCormick/centrality update (pyipm.py:1804-1814);
    #   'mehrotra' = per-iteration predictor-corrector barrier with a
    #   second-order complementarity correction (one factorization, two
    #   cached-factor solves; requires inequality constraints, the
    #   'condensed' linear solver, and exact-Hessian mode);
    #   'auto' = resolves per problem to 'mehrotra' whenever compatible,
    #   else 'adaptive'.  The default stays 'adaptive', which gives
    #   reference iteration-count parity; 'mehrotra' takes fewer,
    #   costlier steps.
    linear_solver: str = "condensed"  # 'condensed' (slack-eliminated, default) | 'ldlt' | 'lu'
    max_reg_retries: int = 40      # bound on the delta escalation loop
    max_backtrack: int = 10_000    # bound on the Armijo backtracking loop
    backtrack_chunk: int = 32      # trial step lengths evaluated per loop
    #                                step of the vectorized backtracking
    #                                scan (core/linesearch.py); set for
    #                                another accelerator, untuned on the
    #                                H100
    ldlt_block: int = 128          # blocked-factorization panel size (the
    #                                Triton panel kernel's width); untuned
    #                                on the H100
    schur_refine_steps: int = 2    # guarded refinement steps per bordered
    #                                Schur direction solve
    #                                (parallel/schur.py).  Each step costs
    #                                ~5 small collectives (see
    #                                benchmarks/collective_census.py); the
    #                                default 2 matches ops/condensed.py
    #                                for single-device parity.  Latency-
    #                                bound small-block meshes (d ~ 16,
    #                                sub-ms steps) can drop to 1 or 0.
    schur_refine_guard: bool = True  # keep a refinement step only when it
    #                                  reduces the globally-reduced
    #                                  residual (2 extra collectives per
    #                                  step); False applies the correction
    #                                  unguarded
    trace_metrics: bool = False    # record per-iteration metric arrays
    nan_guard: bool = True         # per-iteration finiteness check on the
    #                                iterate: terminate with signal -3
    #                                (numerical failure) instead of
    #                                silently iterating on NaN/Inf — the
    #                                in-loop sanitizer the reference lacks
    #                                (it relies on downstream NumPy
    #                                warnings only)
    inject_solve_fault: float = 0.0  # fault-injection: perturb dz by this
    #                                  relative magnitude (tests the
    #                                  line-search/signal recovery path)

    def __post_init__(self):
        # Reference validation (pyipm.py:385-408), evaluated eagerly at
        # construction time instead of at solve time.
        assert self.mu > 0.0, f"mu must be > 0, got {self.mu}"
        assert self.nu > 0.0, f"nu must be > 0, got {self.nu}"
        assert 0.0 < self.eta < 1.0, f"eta must be in (0, 1), got {self.eta}"
        assert 0.0 < self.rho < 1.0, f"rho must be in (0, 1), got {self.rho}"
        assert 0.0 < self.tau < 1.0, f"tau must be in (0, 1), got {self.tau}"
        assert self.beta < 1.0, f"beta must be < 1, got {self.beta}"
        assert self.miter >= 0 and int(self.miter) == self.miter, \
            f"miter must be a nonnegative integer, got {self.miter}"
        assert self.niter >= 0 and int(self.niter) == self.niter, \
            f"niter must be a nonnegative integer, got {self.niter}"
        eps = float(np.finfo(self.np_dtype).eps)
        assert self.Xtol is None or self.Xtol >= eps, \
            f"Xtol must be >= machine eps ({eps}), got {self.Xtol}"
        assert self.Ktol >= eps, \
            f"Ktol must be >= machine eps ({eps}), got {self.Ktol}"
        assert self.Ftol is None or self.Ftol >= 0.0, \
            f"Ftol must be >= 0 or None, got {self.Ftol}"
        assert self.lbfgs >= 0, \
            f"lbfgs memory must be >= 0, got {self.lbfgs}"
        assert self.lbfgs_zeta is None or self.lbfgs_zeta > 0.0, \
            f"lbfgs_zeta must be > 0 or None, got {self.lbfgs_zeta}"
        assert self.linear_solver in ("condensed", "ldlt", "lu"), \
            f"unknown linear_solver {self.linear_solver!r}"
        assert self.mu_strategy in ("adaptive", "mehrotra", "auto"), \
            f"unknown mu_strategy {self.mu_strategy!r}"
        if self.mu_strategy == "mehrotra":
            assert self.linear_solver == "condensed", \
                "mehrotra requires linear_solver='condensed' (factor reuse)"
            assert not self.lbfgs, "mehrotra requires exact-Hessian mode"
        # On the GPU, JAX's DEFAULT matmul precision runs float32 matmuls
        # in TF32 (10-bit mantissa, about 3 decimal digits), below the
        # accuracy the float32 robustness stack was built for: on the
        # 10k-QP fleet (H100) 'default' reaches a Ktol hit rate of 0.9987
        # with mean 8.31 / max 13 iterations, against 1.0000 and 8.22 / 12
        # for 'highest' (benchmarks/bench_kernels.py, precision).  The
        # backtracking line search amplifies any direction error, so the
        # default stays 'highest' (full float32).
        assert self.matmul_precision in ("default", "high", "highest"), \
            f"unknown matmul_precision {self.matmul_precision!r}"

    # ------------------------------------------------------------------
    @property
    def np_dtype(self):
        return np.dtype(self.float_dtype)

    @property
    def eps(self) -> float:
        """Machine epsilon of the working dtype (reference pyipm.py:336)."""
        return float(np.finfo(self.np_dtype).eps)

    @property
    def xtol(self) -> float:
        return self.Xtol if self.Xtol is not None else self.eps

    @property
    def reg_coef(self) -> float:
        """sqrt(eps), the eq-block regularization coefficient (pyipm.py:353)."""
        return float(np.sqrt(self.eps))

    @property
    def delta0(self) -> float:
        """Initial inertia-correction diagonal shift (pyipm.py:372)."""
        return self.reg_coef

    @property
    def mu_floor(self) -> float:
        """Lower bound on the adaptive barrier parameter.

        The reference clamps mu only at >= 0 (pyipm.py:1811-1812).  In
        float64 the default floor is machine eps — a no-op in practice,
        keeping reference-parity iteration counts bit-for-bit.  In
        float32 the floor is eps**0.75 (~6.4e-6): at mu ~ eps the
        active-constraint Sigma = lda/s entries grow like 1/mu ~ 1e7,
        the condensed matrix formation loses all its significant digits,
        and the Newton direction degrades into an oscillation the line
        search can only damp: deterministic stragglers of the random-QP
        fleet ended at signal -1/-2 after ~180 wasted iterations because
        of exactly this, and converge in 8-10 iterations at the
        eps**0.75 floor.  Complementarity at the floor (s*lda ~ 6e-6) is still
        well under the default Ktol=1e-4, so converged solutions are
        within O(mu) ~ 1e-5 of the true optimum — inside every oracle
        in the suite."""
        if self.mu_min is not None:
            return self.mu_min
        eps = self.eps
        # f64 (eps ~ 2.2e-16): parity-exact eps floor; f32 and below:
        # eps**0.75 keeps Sigma within the dtype's usable range
        return eps if eps < 1e-12 else float(eps ** 0.75)

    @property
    def zeta0(self) -> float:
        """Initial L-BFGS Hessian scaling (pyipm.py:356-359)."""
        return self.lbfgs_zeta if self.lbfgs_zeta is not None else 1.0

    @property
    def lbfgs_mem(self) -> int:
        """Fixed L-BFGS storage width.

        The reference grows S/Y dynamically and only FIFO-shifts once
        ``S.shape[1] > lbfgs`` (pyipm.py:1300), so its effective memory is
        lbfgs+1 columns; we allocate that statically.
        """
        return self.lbfgs + 1 if self.lbfgs else 0

    @property
    def lbfgs_fail_max(self) -> int:
        """Consecutive curvature failures before memory reset (pyipm.py:360)."""
        return self.lbfgs

    def replace(self, **kw) -> "IPMConfig":
        return dataclasses.replace(self, **kw)

    def resolve_mu_strategy(self, nineq: int) -> "IPMConfig":
        """Resolve ``mu_strategy='auto'`` for a concrete problem: Mehrotra
        whenever compatible (inequalities present, exact Hessian,
        condensed solver — it is measurably faster end-to-end at a better
        hit rate), else the reference's adaptive schedule.  No-op for the
        explicit strategies."""
        if self.mu_strategy != "auto":
            return self
        ok = (nineq > 0 and not self.lbfgs
              and self.linear_solver == "condensed")
        return self.replace(mu_strategy="mehrotra" if ok else "adaptive")
