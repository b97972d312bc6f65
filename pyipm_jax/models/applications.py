"""Application model families: canonical constrained-optimization workloads.

The reference ships only toy CLI examples (reference pyipm.py:1866-2137);
a production solver framework needs realistic families users actually
deploy.  Each family follows the same pattern as models/random_nlp.py:
instance data is a NamedTuple pytree, ``make_*_problem`` builds a
:class:`Problem` whose callables close over (possibly traced) instance
data, and ``make_*_batch_solver`` returns a jitted vmapped fleet solver —
so every family composes with vmap scenario batching and mesh sharding
(parallel/batch.py) with no family-specific code.

Families:
  - **Markowitz portfolio**: min risk - return  s.t. budget simplex
    (eq + ineq; the classic finance QP).
  - **SVM dual**: box-constrained QP with one equality (the dual of the
    soft-margin support-vector machine).
  - **Maximum entropy**: max H(p) on the probability simplex under moment
    constraints — the scaled-up version of reference example 6
    (pyipm.py:2019-2042).
  - **MPC (model-predictive control)**: finite-horizon LQR tracking with
    input box constraints, condensed to the input sequence — the
    block-structured control workload.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pyipm_jax.config import IPMConfig
from pyipm_jax.core.problem import Problem
from pyipm_jax.core.solver import make_solver


def _batch_solver(make_problem_fn, config: IPMConfig, jit: bool = True):
    cfg = config.replace(verbosity=0)

    def solve_one(x0, data):
        fn = make_solver(make_problem_fn(data), cfg, jit=False)
        return fn(x0)

    fn = jax.vmap(solve_one)
    return jax.jit(fn) if jit else fn


# ----------------------------------------------------------------------
# Markowitz portfolio:  min x'Sx - gamma * m'x
#                       s.t. sum(x) = 1,  x >= 0,  x <= cap
class PortfolioData(NamedTuple):
    S: jnp.ndarray       # (D, D) covariance (PSD)
    m: jnp.ndarray       # (D,) expected returns
    gamma: jnp.ndarray   # scalar risk tolerance
    cap: jnp.ndarray     # (D,) per-asset weight cap


def sample_portfolio_batch(key, batch: int, nassets: int,
                           dtype=jnp.float32) -> PortfolioData:
    ks, km, kg = jax.random.split(key, 3)
    D = nassets
    # factor-model covariance: well-conditioned, realistic cross terms
    F = jax.random.normal(ks, (batch, D, max(D // 4, 2)), dtype)
    S = (jnp.einsum("bik,bjk->bij", F, F) / D
         + 0.05 * jnp.eye(D, dtype=dtype)[None])
    m = 0.1 * jax.random.normal(km, (batch, D), dtype)
    gamma = 0.5 + jnp.abs(jax.random.normal(kg, (batch,), dtype))
    cap = jnp.full((batch, D), 4.0 / D, dtype)
    return PortfolioData(S, m, gamma, cap)


def make_portfolio_problem(data: PortfolioData) -> Problem:
    D = data.m.shape[-1]

    def f(x):
        return x @ (data.S @ x) - data.gamma * (data.m @ x)

    def ce(x):
        return jnp.sum(x) - 1.0

    def ci(x):
        return jnp.concatenate([x, data.cap - x])

    return Problem(f=f, nvar=D, neq=1, nineq=2 * D, ce=ce, ci=ci)


def make_portfolio_batch_solver(config: IPMConfig, nassets: int,
                                jit: bool = True):
    return _batch_solver(make_portfolio_problem, config, jit)


def portfolio_x0(batch: int, nassets: int, dtype=jnp.float32):
    """Strictly feasible uniform start."""
    return jnp.full((batch, nassets), 1.0 / nassets, dtype)


# ----------------------------------------------------------------------
# SVM dual:  min 0.5 a'(YKY)a - 1'a   s.t.  y'a = 0,  0 <= a <= C
class SVMData(NamedTuple):
    Q: jnp.ndarray       # (n, n) = diag(y) K diag(y), PSD
    y: jnp.ndarray       # (n,) labels in {-1, +1}
    C: jnp.ndarray       # scalar box bound


def sample_svm_batch(key, batch: int, npoints: int, nfeat: int = 8,
                     dtype=jnp.float32) -> SVMData:
    kx, ky = jax.random.split(key)
    n = npoints
    X = jax.random.normal(kx, (batch, n, nfeat), dtype)
    y = jnp.where(jax.random.bernoulli(ky, 0.5, (batch, n)), 1.0, -1.0
                  ).astype(dtype)
    # separate the classes a bit so the dual has interior structure
    X = X + 0.5 * y[..., None]
    Km = jnp.einsum("bif,bjf->bij", X, X) / nfeat
    Km = Km + 1e-3 * jnp.eye(n, dtype=dtype)[None]
    Q = y[:, :, None] * Km * y[:, None, :]
    C = jnp.full((batch,), 1.0, dtype)
    return SVMData(Q, y, C)


def make_svm_problem(data: SVMData) -> Problem:
    n = data.y.shape[-1]

    def f(a):
        return 0.5 * a @ (data.Q @ a) - jnp.sum(a)

    def ce(a):
        return data.y @ a

    def ci(a):
        return jnp.concatenate([a, data.C - a])

    return Problem(f=f, nvar=n, neq=1, nineq=2 * n, ce=ce, ci=ci)


def make_svm_batch_solver(config: IPMConfig, npoints: int, jit: bool = True):
    return _batch_solver(make_svm_problem, config, jit)


def svm_x0(data: SVMData, dtype=jnp.float32):
    """Strictly feasible interior start: y'a = 0 with 0 < a < C, achieved
    by giving each class equal total mass spread uniformly within it."""
    y = data.y.astype(dtype)
    npos = jnp.maximum(jnp.sum(y > 0, axis=-1, keepdims=True), 1).astype(dtype)
    nneg = jnp.maximum(jnp.sum(y < 0, axis=-1, keepdims=True), 1).astype(dtype)
    w = jnp.where(y > 0, 1.0 / npos, 1.0 / nneg)
    return 0.1 * data.C[:, None] * w


# ----------------------------------------------------------------------
# Maximum entropy:  min sum(p log p)  s.t. 1'p = 1, Ap = b, p >= 0
# (reference example 6 at scale, pyipm.py:2019-2042)
class MaxEntData(NamedTuple):
    A: jnp.ndarray       # (m, D) moment functions
    b: jnp.ndarray       # (m,) target moments


def sample_maxent_batch(key, batch: int, nstates: int, nmoments: int = 2,
                        dtype=jnp.float32) -> MaxEntData:
    ka, kp = jax.random.split(key)
    D, m = nstates, nmoments
    A = jax.random.normal(ka, (batch, m, D), dtype)
    # targets from a random interior distribution => feasible
    logits = 0.5 * jax.random.normal(kp, (batch, D), dtype)
    p = jax.nn.softmax(logits, axis=-1)
    b = jnp.einsum("bmd,bd->bm", A, p)
    return MaxEntData(A, b)


def make_maxent_problem(data: MaxEntData) -> Problem:
    m, D = data.A.shape[-2], data.A.shape[-1]
    tiny = 1e-12

    def f(p):
        return jnp.sum(p * jnp.log(p + tiny))

    def ce(p):
        return jnp.concatenate([
            jnp.reshape(jnp.sum(p) - 1.0, (1,)),
            data.A @ p - data.b,
        ])

    def ci(p):
        return 1.0 * p

    return Problem(f=f, nvar=D, neq=1 + m, nineq=D, ce=ce, ci=ci)


def make_maxent_batch_solver(config: IPMConfig, nstates: int,
                             jit: bool = True):
    return _batch_solver(make_maxent_problem, config, jit)


def maxent_x0(batch: int, nstates: int, dtype=jnp.float32):
    return jnp.full((batch, nstates), 1.0 / nstates, dtype)


# ----------------------------------------------------------------------
# MPC: linear dynamics x_{t+1} = Ad x_t + Bd u_t, horizon T, input box.
# Condensed to the stacked input sequence u (nvar = T * nu): the state
# trajectory is rolled out with lax.scan inside the objective, so the
# Hessian the solver sees is the dense condensed (T nu)^2 control Hessian
# — dense matmul-shaped — rather than the banded sparse form a CPU solver
# would use.
class MPCData(NamedTuple):
    Ad: jnp.ndarray      # (nx, nx)
    Bd: jnp.ndarray      # (nx, nu)
    x_init: jnp.ndarray  # (nx,)
    x_ref: jnp.ndarray   # (nx,)
    umax: jnp.ndarray    # scalar input bound


def sample_mpc_batch(key, batch: int, nx: int = 4, nu: int = 2,
                     dtype=jnp.float32) -> MPCData:
    ka, kb, ki, kr = jax.random.split(key, 4)
    Ad = (jnp.eye(nx, dtype=dtype)[None]
          + 0.1 * jax.random.normal(ka, (batch, nx, nx), dtype))
    # normalize the spectral radius-ish scale so rollouts stay bounded
    Ad = Ad / (1.0 + 0.1 * jnp.abs(Ad).sum(-1, keepdims=True).max(-2, keepdims=True))
    # float() keeps the scalar weak-typed: a bare np.sqrt() float64 scalar
    # would promote the whole batch to f64 when jax_enable_x64 is on
    Bd = jax.random.normal(kb, (batch, nx, nu), dtype) / float(np.sqrt(nx))
    x_init = jax.random.normal(ki, (batch, nx), dtype)
    x_ref = 0.5 * jax.random.normal(kr, (batch, nx), dtype)
    umax = jnp.full((batch,), 1.0, dtype)
    return MPCData(Ad, Bd, x_init, x_ref, umax)


def make_mpc_problem(data: MPCData, horizon: int) -> Problem:
    nx = data.Ad.shape[-1]
    nu = data.Bd.shape[-1]
    T = horizon
    D = T * nu

    def rollout_cost(u_flat):
        u = u_flat.reshape(T, nu)

        def step(x, ut):
            xn = data.Ad @ x + data.Bd @ ut
            c = jnp.sum((xn - data.x_ref) ** 2) + 0.1 * jnp.sum(ut ** 2)
            return xn, c

        _, costs = jax.lax.scan(step, data.x_init, u)
        return jnp.sum(costs)

    def ci(u_flat):
        return jnp.concatenate([u_flat + data.umax,
                                data.umax - u_flat])

    return Problem(f=rollout_cost, nvar=D, nineq=2 * D, ci=ci)


def make_mpc_batch_solver(config: IPMConfig, horizon: int, jit: bool = True):
    def mk(data):
        return make_mpc_problem(data, horizon)

    return _batch_solver(mk, config, jit)


def mpc_x0(batch: int, horizon: int, nu: int = 2, dtype=jnp.float32):
    return jnp.zeros((batch, horizon * nu), dtype)


# ----------------------------------------------------------------------
# Multi-agent resource allocation — the DISTRIBUTED block workload
# (parallel/schur.py BlockNLP): K agents each minimize a local quadratic
# cost under local linear constraints and per-resource consumption caps
# coupling ALL agents:
#
#     min   sum_k 0.5 x_k' Q_k x_k + c_k' x_k
#     s.t.  Ce_k x_k = e_k            (local allocations, e.g. demand)
#           x_k >= 0                  (nonnegative activity levels)
#           sum_k R_k x_k = budget    (shared resource pool, mc resources)
#
# The classic decomposition testbed (dual decomposition / ADMM papers use
# exactly this shape); here it solves as ONE interior-point program with
# the coupling reduced over the mesh by the bordered Schur complement.
class ResourceAllocData(NamedTuple):
    theta: dict              # per-agent {Q, c, Ce, e, R, lb} (K, ...)
    ccdata: dict             # {"budget": (mc,)}


def sample_resource_alloc(key, nagents: int, nvar: int, nres: int = 4,
                          neq: int = 1, dtype=jnp.float32):
    """Random feasible instance: consumption matrices R_k >= 0, budget set
    from a strictly positive feasible allocation."""
    kq, kc, ke, kr, kx = jax.random.split(key, 5)
    K, d = nagents, nvar
    G = jax.random.normal(kq, (K, d, d), dtype) / jnp.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", G, G) + jnp.eye(d, dtype=dtype)[None]
    c = jax.random.normal(kc, (K, d), dtype)
    Ce = jax.random.normal(ke, (K, neq, d), dtype) / jnp.sqrt(d)
    R = jnp.abs(jax.random.normal(kr, (K, nres, d), dtype)) / (K * d)
    xfeas = jnp.abs(jax.random.normal(kx, (K, d), dtype)) + 0.5
    e = jnp.einsum("kmd,kd->km", Ce, xfeas)
    budget = jnp.einsum("krd,kd->r", R, xfeas)
    theta = {"Q": Q, "c": c, "Ce": Ce, "e": e, "R": R,
             "lb": jnp.zeros((K, d), dtype)}
    return ResourceAllocData(theta=theta, ccdata={"budget": budget})


def make_resource_alloc_spec(nvar: int, nres: int = 4, neq: int = 1,
                             cap: str = "eq"):
    """BlockNLP spec for :func:`sample_resource_alloc` instances (use with
    parallel.schur.make_block_solver over a ``model`` mesh axis).

    ``cap='eq'`` makes the pool binding (sum_k R_k x_k = budget);
    ``cap='ineq'`` makes it a true CAP (sum_k R_k x_k <= budget) via the
    coupling-inequality class."""
    from pyipm_jax.parallel.schur import BlockNLP

    kw = dict(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        d=nvar,
        ce_blk=lambda xk, th: th["Ce"] @ xk - th["e"], me=neq,
        ci_blk=lambda xk, th: xk - th["lb"], ni=nvar, ci_identity=True,
        g_blk=lambda xk, th: th["R"] @ xk, p=nres,
    )
    if cap == "eq":
        return BlockNLP(cc=lambda u, ccd: u - ccd["budget"], mc=nres,
                        **kw)
    if cap == "ineq":
        return BlockNLP(cci=lambda u, ccd: ccd["budget"] - u, mci=nres,
                        **kw)
    raise ValueError(f"cap must be 'eq' or 'ineq', got {cap!r}")
