"""pyipm_jax — a nonlinear-programming interior-point framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of jkaardal/pyipm
(reference: pyipm.py): a line-search primal-dual interior-point
method for problems of the form

    min f(x)   subject to   ce(x) = 0,  ci(x) >= 0

with slack variables, a log-barrier, an l1 merit function with Armijo
backtracking + second-order correction, fraction-to-the-boundary stepping,
inertia-corrected exact-Hessian KKT solves, compact-representation L-BFGS,
and an adaptive Fiacco-McCormick/centrality barrier update.

Unlike the reference (host-side Python loops around Aesara-compiled kernels,
reference pyipm.py:1567-1863), the entire solver here is a pure jittable
function of a `SolverState` pytree: it vmaps over thousands of problem
instances, shards over device meshes, and runs its hot linear algebra through
blocked factorizations built from large matmuls.

Public API:
  - `IPM` — class facade matching the reference constructor/solve/KKT contract.
  - `Problem`, `make_problem` — functional problem specification.
  - `IPMConfig` — all solver hyperparameters (reference pyipm.py:311-376).
  - `solve` — functional single-instance solve.
  - `solve_batch` — vmapped scenario batching.
  - `solve_fleet` — heterogeneous-shape fleet solving (bucketed dispatch).
  - `BlockNLP`, `make_block_solver` — one LARGE block-separable NLP
    sharded over a device mesh (bordered Schur complement; general
    per-block ce/ci + nonlinear coupling).
"""

from pyipm_jax.config import IPMConfig
from pyipm_jax.core.problem import Problem, make_problem
from pyipm_jax.core.solver import SolverState, SolverResult, make_solver, solve
from pyipm_jax.api import IPM
from pyipm_jax.parallel.batch import rescue_failures, solve_batch
from pyipm_jax.parallel.fleet import solve_fleet
from pyipm_jax.parallel.schur import BlockNLP, make_block_solver

__version__ = "0.1.0"

__all__ = [
    "IPM",
    "IPMConfig",
    "Problem",
    "make_problem",
    "SolverState",
    "SolverResult",
    "make_solver",
    "solve",
    "solve_batch",
    "rescue_failures",
    "solve_fleet",
    "BlockNLP",
    "make_block_solver",
]
