"""Random NLP families for benchmarking and stress tests.

Covers the driver-defined benchmark configs (BASELINE.md):
  - 10k-instance vmapped batches of random quadratic-objective NLPs with
    box + linear inequality constraints (single chip, DP analog);
  - an n=4096 dense NLP with a neural-net-style nonconvex objective and 256
    equality constraints (the blocked-LDL^T hot path).

Instance data (Q, c, A, b, ...) is generated host-side; per-instance
problems are constructed INSIDE the traced function so the callables close
over traced data and the whole family vmaps/shards over the instance axis
— the reference has no equivalent (one host loop per problem,
reference pyipm.py:1658).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyipm_jax.config import IPMConfig
from pyipm_jax.core.problem import Problem
from pyipm_jax.core.solver import make_solver


class QPData(NamedTuple):
    """One random inequality-constrained QP instance.

        min 0.5 x'Qx + c'x   s.t.   x - lb >= 0,  ub - x >= 0,  Ax - b >= 0

    Q is symmetric positive definite, x=0 is strictly feasible by
    construction (lb < 0 < ub, b < 0)."""
    Q: jnp.ndarray        # (D, D)
    c: jnp.ndarray        # (D,)
    A: jnp.ndarray        # (L, D)
    b: jnp.ndarray        # (L,)
    lb: jnp.ndarray       # (D,)
    ub: jnp.ndarray       # (D,)


def sample_qp_batch(key, batch: int, nvar: int, nlin: int = 4,
                    dtype=jnp.float32) -> QPData:
    """Sample a batch of random QP instances (leading axis = instance)."""
    kq, kc, ka, kb, kl, ku = jax.random.split(key, 6)
    D, L = nvar, nlin
    G = jax.random.normal(kq, (batch, D, D), dtype)
    Q = (jnp.einsum("bij,bkj->bik", G, G) / D
         + jnp.eye(D, dtype=dtype)[None])
    c = jax.random.normal(kc, (batch, D), dtype)
    A = jax.random.normal(ka, (batch, L, D), dtype)
    b = -(jnp.abs(jax.random.normal(kb, (batch, L), dtype)) + 0.1)
    lb = -(jnp.abs(jax.random.normal(kl, (batch, D), dtype)) + 0.5)
    ub = jnp.abs(jax.random.normal(ku, (batch, D), dtype)) + 0.5
    return QPData(Q, c, A, b, lb, ub)


def make_qp_problem(data: QPData, nvar: int, nlin: int) -> Problem:
    """Problem for ONE instance; callables close over (possibly traced)
    instance data, so this composes with vmap."""

    def f(x):
        return 0.5 * x @ (data.Q @ x) + data.c @ x

    def ci(x):
        return jnp.concatenate([
            x - data.lb,
            data.ub - x,
            data.A @ x - data.b,
        ])

    return Problem(f=f, nvar=nvar, nineq=2 * nvar + nlin, ci=ci)


def make_qp_batch_solver(config: IPMConfig, nvar: int, nlin: int = 4,
                         jit: bool = True):
    """Jitted, vmapped solver over (x0_batch, QPData_batch); pass
    ``jit=False`` for a traceable version to embed in larger programs."""
    cfg = config.replace(verbosity=0)

    def solve_one(x0, data: QPData):
        prob = make_qp_problem(data, nvar, nlin)
        fn = make_solver(prob, cfg, jit=False)
        return fn(x0)

    fn = jax.vmap(solve_one)
    return jax.jit(fn) if jit else fn


# ----------------------------------------------------------------------
# large dense nonconvex NLP (the LDL^T hot-path config)
class DenseNLPData(NamedTuple):
    """min 0.5 x'Px + c'x + alpha * sum(tanh(Wx/sqrt(D)))  s.t.  Aeq x = beq

    Nonconvex (tanh features), D variables, M equality constraints."""
    P: jnp.ndarray        # (D, D) PSD quadratic part
    c: jnp.ndarray        # (D,)
    W: jnp.ndarray        # (H, D) feature weights
    Aeq: jnp.ndarray      # (M, D)
    beq: jnp.ndarray      # (M,)
    alpha: jnp.ndarray    # scalar


def sample_dense_nlp(key, nvar: int, neq: int, hidden: int = 256,
                     dtype=jnp.float32) -> DenseNLPData:
    kp, kc, kw, ka, kx = jax.random.split(key, 5)
    D, M, H = nvar, neq, hidden
    G = jax.random.normal(kp, (D, D), dtype) / float(np.sqrt(D))
    P = G @ G.T + 0.5 * jnp.eye(D, dtype=dtype)
    c = jax.random.normal(kc, (D,), dtype)
    W = jax.random.normal(kw, (H, D), dtype)
    Aeq = jax.random.normal(ka, (M, D), dtype) / float(np.sqrt(D))
    xfeas = jax.random.normal(kx, (D,), dtype) * 0.1
    beq = Aeq @ xfeas                      # guarantees feasibility
    return DenseNLPData(P, c, W, Aeq, beq, jnp.asarray(0.5, dtype))


def make_dense_nlp_problem(data: DenseNLPData, nvar: int, neq: int) -> Problem:
    sqrtD = float(np.sqrt(nvar))

    def f(x):
        feat = jnp.tanh(data.W @ x / sqrtD)
        return 0.5 * x @ (data.P @ x) + data.c @ x + data.alpha * jnp.sum(feat)

    def ce(x):
        return data.Aeq @ x - data.beq

    return Problem(f=f, nvar=nvar, neq=neq, ce=ce)


def make_dense_nlp_solver(config: IPMConfig, nvar: int, neq: int):
    cfg = config.replace(verbosity=0)

    def solve_one(x0, data: DenseNLPData):
        prob = make_dense_nlp_problem(data, nvar, neq)
        fn = make_solver(prob, cfg, jit=False)
        return fn(x0)

    return jax.jit(solve_one)
