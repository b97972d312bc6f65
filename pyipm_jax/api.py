"""Class facade matching the reference ``IPM`` contract.

Mirrors the reference constructor/solve/KKT surface (reference pyipm.py:23,
311-376, 1567, 958): same keyword names, same defaults, same 5-tuple return
``(x, s, lda, fval, kkt)``, same verbosity semantics for the final report.

Differences (all deliberate, documented):
  - ``f``/``ce``/``ci`` and the optional derivative overrides are plain JAX
    callables, not Aesara symbolic expressions; ``x_dev``/``lambda_dev`` are
    accepted and ignored (no symbolic graph exists to bind them to).
  - ``compile()`` jit-compiles the whole solver instead of per-expression
    Aesara functions; like the reference, ``solve()`` calls it lazily
    (pyipm.py:1593-1594).
  - mu/nu are reinitialized from the constructor values on every solve; the
    reference leaves the device copies in their final state across solves
    and warns users to reset them by hand (pyipm.py:273-275, 1603-1607).
    Users migrating reference warm-start loops can opt back into the
    stateful behavior explicitly: ``solve(..., mu0=prob.mu, nu0=prob.nu)``
    feeds the previous solve's final values forward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pyipm_jax.config import IPMConfig
from pyipm_jax.core import kkt as kkt_mod
from pyipm_jax.core.problem import Problem
from pyipm_jax.core.solver import make_solver


class IPM:
    """Solve nonlinear, nonconvex programs with a line-search primal-dual
    interior-point method:

        min f(x)  subject to  ce(x) = 0,  ci(x) >= 0

    where ``x`` is a length-D vector of optimization variables, ``ce`` maps
    x to M equality-constraint residuals and ``ci`` to N inequality-
    constraint values.  The algorithm follows Nocedal & Wright ch. 19:
    inequality constraints are converted to equalities with slack variables
    ``s`` (ci(x) - s = 0, s >= 0) and a log-barrier on s with weight ``mu``;
    each barrier subproblem is solved by Newton steps on the primal-dual
    KKT system with inertia correction, an l1-penalty merit function with
    Armijo backtracking plus second-order correction, and fraction-to-the-
    boundary steps; ``mu`` is decreased adaptively from the centrality of
    the iterates.  This keeps full behavioral parity with the reference
    implementation (reference pyipm.py:23-1863) while executing the entire
    solve as one compiled device program.

    Constructor parameters
    ----------------------
    All parameters are optional at construction; ``x0`` and ``f`` must be
    set (here or via :meth:`solve`) before solving.

    Problem definition:
      x0 : (D,) array — initial guess.  Also fixes D = number of variables.
      f : callable ``f(x) -> scalar`` — objective, a pure JAX function.
      ce : callable ``ce(x) -> (M,)`` or None — equality constraints,
          feasible iff ce(x) = 0.
      ci : callable ``ci(x) -> (N,)`` or None — inequality constraints,
          feasible iff ci(x) >= 0.
      x_dev, lambda_dev : accepted and IGNORED.  They are the reference's
          Aesara symbolic placeholders; JAX callables need no symbolic
          binding.  Pre-jitted callables are accepted anywhere a callable
          is (the analog of the reference's "precompiled function" inputs).

    Optional user-supplied derivatives (derived by autodiff when omitted;
    shape conventions match the reference, including the TRANSPOSED
    Jacobians — reference pyipm.py:223-225 note 2):
      df : ``df(x) -> (D,)`` — gradient of f.
      d2f : ``d2f(x) -> (D, D)`` — Hessian of f (exact-Hessian mode only).
      dce : ``dce(x) -> (D, M)`` — TRANSPOSED Jacobian of ce.
      d2ce : ``d2ce(x, lda) -> (D, D)`` — multiplier-contracted Hessian
          ``hessian_x(sum_j ce_j(x) * lda[j])`` where ``lda`` is the full
          (M+N,) multiplier vector.
      dci : ``dci(x) -> (D, N)`` — TRANSPOSED Jacobian of ci.
      d2ci : ``d2ci(x, lda) -> (D, D)`` — multiplier-contracted Hessian of
          ci against ``lda[M:]``.
      Supplying dce/d2ce without ce (or dci/d2ci without ci) is invalid.

    Warm starts:
      s0 : (N,) array or None — initial slacks; default max(ci(x0), Ktol).
      lda0 : (M+N,) array or None — initial multipliers; default is the
          least-squares estimate pinv(jaco)' df(x0) with negative
          inequality multipliers clamped to Ktol.

    Hyperparameters (defaults identical to the reference,
    pyipm.py:311-314):
      mu : float > 0, default 0.2 — initial barrier parameter.
      nu : float > 0, default 10.0 — initial merit penalty weight; raised
          automatically so the search direction stays a descent direction
          of the merit function.
      rho : 0 < float < 1, default 0.1 — margin in the nu update
          (larger rho -> larger nu).
      tau : 0 < float < 1, default 0.995 — fraction-to-the-boundary
          coefficient AND backtracking shrink factor per trial.
      eta : 0 < float < 1, default 1e-4 — Armijo sufficient-decrease
          coefficient.
      beta : float < 1, default 0.4 — exponent of the mu-dependent
          equality-block regularization used when the KKT matrix is
          singular/ill-conditioned.
      miter : int >= 0, default 20 — max inner iterations per barrier
          subproblem.
      niter : int >= 0, default 10 — max outer (barrier-update)
          iterations; the iteration budget is at most niter*miter.
      Ktol : float >= machine eps, default 1e-4 — convergence tolerance
          applied to all four KKT residual norms.
      Xtol : OBSOLETE, accepted for compatibility.  The reference uses it
          only as the tolerance of its golden-section fraction-to-the-
          boundary search (pyipm.py:1429-1432); this framework computes
          that step in closed form (exactly), so there is nothing to
          tolerate.  Validated (must be >= machine eps) and never read.
      Ftol : float or None, default None — optional secondary convergence
          test on the change of f between iterations (per inner iteration
          when N == 0, per outer iteration otherwise).
      lbfgs : False/0 or int > 0, default False — 0 uses the exact
          (inertia-corrected) Hessian; an integer m approximates the
          Hessian with compact-representation L-BFGS memory m (use for
          large D where the (D+2N+M)^2 KKT matrix is prohibitive).
      lbfgs_zeta : float > 0 or None — initial Hessian scaling zeta*I for
          L-BFGS mode; default 1.0, replaced by an adaptive value after
          the first update.
      float_dtype : numpy dtype, default np.float64 — working precision.
          float32 is fully supported (the f32 robustness stack: Ruiz
          scaling, mu floor, roundoff-aware Armijo); float64 is the
          parity-exact mode.
      verbosity : int in [-1, 3], default 1 —
          -1: silent; 0: final report only; 1: + iteration counter and
          mode banner; 2: + f(x) per iteration; 3: + the four KKT norms,
          line-search/SOC/L-BFGS-reset notices.
      linear_solver : 'condensed' | 'ldlt' | 'lu' | None — KKT solve
          method; None defers to the IPMConfig default ('condensed') so
          the class facade, the functional API, and the CLI share one hot
          path.  'lu' reproduces the reference's eigendecomposition-based
          inertia flow; 'ldlt' factors the full KKT matrix reading inertia
          off the pivots; 'condensed' solves the slack-eliminated (D+M)^2
          system (identical Newton step, fastest).

    solve(x0=None, s0=None, lda0=None, force_recompile=False)
    ---------------------------------------------------------
    Runs the solver and returns the 5-tuple ``(x, s, lda, fval, kkt)``:
      x : (D,) solution; s : (N,) slacks (empty if N == 0);
      lda : (M+N,) multipliers (equality first; empty if M+N == 0);
      fval : float f(x); kkt : the 4-element KKT block list (below).
    Arguments override the stored x0/s0/lda0 (warm starting).  Passing a
    new x0 of different size re-infers the problem shapes; compilation is
    otherwise cached (force_recompile rebuilds it).  After solve(), the
    fields ``self.x/s/lda/fval/kkt/signal`` hold the results; unlike the
    reference, mu/nu are reinitialized on every solve (the reference warns
    users to reset its device state by hand, pyipm.py:273-275).

    ``self.signal`` reports termination: 1 Ktol converged, 2 Ftol
    converged, -1 maximum iterations, -2 search direction unreliable to
    machine precision, -3 non-finite iterate (the in-loop NaN guard,
    IPMConfig.nan_guard — an extension).

    KKT(x, s, lda, mu=None)
    -----------------------
    Returns ``[kkt1, kkt2, kkt3, kkt4]``: the Lagrangian gradient (D,),
    the s-scaled complementarity s*(lda_i - mu/s) (N,), the equality
    residual ce (M,), and the inequality residual ci - s (N,).  Blocks
    absent from the problem are scalar 0, matching the reference
    (pyipm.py:958-991).

    Notes
    -----
    - Everything user-supplied must be a pure JAX-traceable function;
      side effects and data-dependent Python control flow are not
      supported (use ``jax.numpy`` / ``lax`` primitives).
    - For fleets of problems use :func:`pyipm_jax.solve_batch` (one
      problem, many starts / per-instance data) or
      :func:`pyipm_jax.parallel.fleet.solve_fleet` (mixed shapes).
    """

    def __init__(self, x0=None, x_dev=None, f=None, df=None, d2f=None,
                 ce=None, dce=None, d2ce=None, ci=None, dci=None, d2ci=None,
                 lda0=None, lambda_dev=None, s0=None, mu=0.2, nu=10.0,
                 rho=0.1, tau=0.995, eta=1.0E-4, beta=0.4, miter=20,
                 niter=10, Xtol=None, Ktol=1.0E-4, Ftol=None, lbfgs=False,
                 lbfgs_zeta=None, float_dtype=np.float64, verbosity=1,
                 linear_solver=None):
        del x_dev, lambda_dev  # symbolic placeholders; meaningless in JAX
        self.x0 = None if x0 is None else np.asarray(x0)
        self.lda0 = None if lda0 is None else np.asarray(lda0)
        self.s0 = None if s0 is None else np.asarray(s0)

        self.f = f
        self.df = df
        self.d2f = d2f
        self.ce = ce
        self.dce = dce
        self.d2ce = d2ce
        self.ci = ci
        self.dci = dci
        self.d2ci = d2ci

        # linear_solver=None defers to the IPMConfig default so the class
        # facade, the functional API, and the CLI all take the same hot path.
        solver_kw = ({} if linear_solver is None
                     else {"linear_solver": linear_solver})
        self.config = IPMConfig(
            mu=mu, nu=nu, rho=rho, tau=tau, eta=eta, beta=beta,
            miter=int(miter), niter=int(niter), Xtol=Xtol, Ktol=Ktol,
            Ftol=Ftol, lbfgs=int(lbfgs) if lbfgs else 0,
            lbfgs_zeta=lbfgs_zeta,
            float_dtype=np.dtype(float_dtype).name, verbosity=verbosity,
            **solver_kw,
        )
        self.float_dtype = np.dtype(float_dtype).type
        self.verbosity = verbosity

        self.nvar = None
        self.neq = None
        self.nineq = None
        self.problem: Optional[Problem] = None
        self.compiled = False
        self._solvers = {}

        # populated by solve() (reference pyipm.py:1816-1821)
        self.x = None
        self.s = None
        self.lda = None
        self.kkt = None
        self.fval = None
        self.signal = None
        self.mu = None           # final barrier value of the last solve
        self.nu = None           # final merit penalty of the last solve

    # ------------------------------------------------------------------
    def validate(self):
        """Input validation (reference pyipm.py:385-408); hyperparameter
        ranges are validated eagerly by IPMConfig."""
        assert self.f is not None, "an objective f must be supplied"
        assert (self.ce is not None) or (self.dce is None
                                         and self.d2ce is None), \
            "dce/d2ce supplied without ce"
        assert (self.ci is not None) or (self.dci is None
                                         and self.d2ci is None), \
            "dci/d2ci supplied without ci"

    def compile(self, nvar=None, neq=None, nineq=None):
        """Build the Problem (inferring constraint counts) and jit the
        solver (reference compile(), pyipm.py:410-956 — collapsed to ~10
        lines because jit/grad compose over plain callables)."""
        if nvar is not None:
            self.nvar = int(nvar)
        elif self.x0 is not None:
            self.nvar = int(self.x0.size)
        assert self.nvar is not None, "nvar unknown: supply x0 or nvar"
        self.validate()
        self.problem = Problem(
            f=self.f, nvar=self.nvar,
            neq=self._count(self.ce, neq), nineq=self._count(self.ci, nineq),
            ce=self.ce, ci=self.ci, df=self.df, d2f=self.d2f,
            dce=self.dce, d2ce=self.d2ce, dci=self.dci, d2ci=self.d2ci,
        )
        self.neq = self.problem.neq
        self.nineq = self.problem.nineq
        self._solvers = {}
        self.compiled = True

    def _count(self, fn, override):
        if fn is None:
            return 0
        if override is not None:
            return int(override)
        import jax
        probe = jax.ShapeDtypeStruct((self.nvar,), self.config.np_dtype)
        out = jax.eval_shape(fn, probe)
        return int(np.prod(out.shape)) if out.shape else 1

    # ------------------------------------------------------------------
    def _solver(self, with_s0, with_lda0):
        key = (with_s0, with_lda0)
        if key not in self._solvers:
            self._solvers[key] = make_solver(
                self.problem, self.config,
                with_s0=with_s0, with_lda0=with_lda0)
        return self._solvers[key]

    def _warm_solver(self, with_s0, with_lda0):
        """Jitted phased solve taking runtime mu0/nu0 as trailing args
        (see :meth:`solve`); cached like the plain solvers."""
        key = (with_s0, with_lda0, "warm")
        if key not in self._solvers:
            import jax
            base = make_solver(self.problem, self.config,
                               with_s0=with_s0, with_lda0=with_lda0)

            def warm(*args):
                *starts, mu0v, nu0v = args
                x0 = starts[0]
                s0 = starts[1] if with_s0 else None
                lda0 = (starts[1 + int(with_s0)] if with_lda0 else None)
                st = base.init_state(x0, s0, lda0, mu0=mu0v, nu0=nu0v)
                return base.finalize(base.run(st))

            self._solvers[key] = jax.jit(warm)
        return self._solvers[key]

    def solve(self, x0=None, s0=None, lda0=None, force_recompile=False,
              mu0=None, nu0=None):
        """Run the solver (reference IPM.solve, pyipm.py:1567-1863).

        Returns (x, s, lda, fval, kkt) with kkt = [kkt1, kkt2, kkt3, kkt4]
        (absent blocks are scalar 0, reference pyipm.py:958-991).

        ``mu0``/``nu0`` (optional floats) override the initial barrier /
        merit-penalty values for THIS solve only — the explicit opt-in
        for users migrating reference warm-start loops, where the device
        copies of mu/nu persist in their final state across solve()
        calls (reference pyipm.py:273-275; this class reinitializes them
        per solve by default).  ``self.mu``/``self.nu`` hold the final
        values of the last solve to feed back in.  Runtime values: no
        recompilation across different mu0/nu0.
        """
        if x0 is not None:
            self.x0 = np.asarray(x0)
        if s0 is not None:
            self.s0 = np.asarray(s0)
        if lda0 is not None:
            self.lda0 = np.asarray(lda0)
        assert self.x0 is not None and self.x0.size > 0
        assert self.x0.ndim == 1
        if (not self.compiled or force_recompile
                or self.nvar != self.x0.size):
            self.nvar = int(self.x0.size)
            self.compile()

        with_s0 = self.s0 is not None and self.problem.nineq > 0
        with_lda0 = self.lda0 is not None and self.problem.ncon > 0
        args = [self.x0.astype(self.config.np_dtype)]
        if with_s0:
            args.append(self.s0.astype(self.config.np_dtype))
        if with_lda0:
            args.append(self.lda0.astype(self.config.np_dtype))
        if mu0 is None and nu0 is None:
            res = self._solver(with_s0, with_lda0)(*args)
        else:
            fn = self._warm_solver(with_s0, with_lda0)
            dt = self.config.np_dtype
            res = fn(*args,
                     dt.type(self.config.mu if mu0 is None else mu0),
                     dt.type(self.config.nu if nu0 is None else nu0))

        self.x = np.asarray(res.x)
        self.s = np.asarray(res.s)
        self.lda = np.asarray(res.lda)
        self.fval = float(res.fval)
        self.signal = int(res.signal)
        self.mu = float(res.mu)
        self.nu = float(res.nu)
        self.kkt = self.KKT(self.x, self.s, self.lda)
        self._report(res)
        return self.x, self.s, self.lda, self.fval, self.kkt

    # ------------------------------------------------------------------
    def KKT(self, x, s, lda, mu=None):
        """First-order KKT conditions at (x, s, lda) (reference IPM.KKT,
        pyipm.py:958-991).  ``mu`` defaults to the CURRENT barrier value —
        the final mu of the last solve when one has run, else the
        configured initial value — matching the reference, which evaluates
        at the current device mu (pyipm.py:968)."""
        if self.problem is None:
            self.nvar = int(np.asarray(x).size)
            self.compile()
        if mu is None:
            if self.mu is not None:
                mu = self.mu
            else:
                mu = (self.config.mu if self.problem.nineq
                      else self.config.Ktol)
        import jax.numpy as jnp
        dtype = self.config.np_dtype
        blocks = kkt_mod.kkt_blocks(
            self.problem,
            jnp.asarray(x, dtype), jnp.asarray(s, dtype),
            jnp.asarray(lda, dtype), jnp.asarray(mu, dtype))
        return [np.asarray(b) for b in blocks]

    # ------------------------------------------------------------------
    def _report(self, res):
        """Final convergence report (reference pyipm.py:1823-1860)."""
        if self.verbosity < 0:
            return
        kktn = np.asarray(res.kkt)
        msg = []
        if self.signal == -2:
            msg.append('Terminated due to bad direction in backtracking '
                       'line search')
        elif self.signal == -3:
            msg.append('Terminated on non-finite iterate')
        elif np.all(kktn <= self.config.Ktol):
            msg.append('Converged to Ktol tolerance')
        elif self.signal == 2:
            msg.append('Converged to Ftol tolerance')
        else:
            msg.append('Maximum iterations reached')
        outer = int(res.outer)
        inner = int(res.inner)
        total = int(res.iter_count)
        if self.problem.nineq:
            if outer > 1:
                msg.append('after {} outer'.format(outer - 1))
                msg.append('iterations' if outer > 2 else 'iteration')
                msg.append('and')
            else:
                msg.append('after')
            msg.append('{} inner'.format(inner))
            msg.append('iterations' if inner > 1 else 'iteration')
            msg.append('({} total).'.format(total))
        else:
            msg.append('after {}'.format(total))
            msg.append('iterations.' if total > 1 else 'iteration.')
        print(' '.join(msg))
        if self.verbosity > 1:
            line = ['FINAL: f(x) = {}'.format(self.fval)]
            if self.verbosity > 2:
                line.append('|dL/dx| = {}'.format(kktn[0]))
                line.append('|dL/ds| = {}'.format(kktn[1]))
                line.append('|ce| = {}'.format(kktn[2]))
                line.append('|ci-s| = {}'.format(kktn[3]))
            print(', '.join(line))
