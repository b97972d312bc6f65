"""Heterogeneous fleet: mixed problem SHAPES in one call (the EP analog —
bucketing by traced structure; no reference counterpart).

``solve_fleet`` lifts each instance's callables to jaxprs, groups
structurally identical instances, batches each bucket through the wave
solver, and returns per-instance results in order — matching a loop of
single solves.

    python examples/heterogeneous_fleet.py
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp                     # noqa: E402
import numpy as np                          # noqa: E402

from pyipm_jax import IPMConfig             # noqa: E402
from pyipm_jax.core.problem import Problem  # noqa: E402
from pyipm_jax.models.reference_problems import get_problem  # noqa: E402
from pyipm_jax.parallel.fleet import solve_fleet  # noqa: E402


def box_qp(nvar, seed):
    """A tiny box-constrained QP of dimension ``nvar``."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(nvar, nvar))
    W = jnp.asarray(G @ G.T / nvar + np.eye(nvar))
    c = jnp.asarray(rng.normal(size=nvar))
    return Problem(
        f=lambda x: 0.5 * x @ W @ x + c @ x,
        ci=lambda x: jnp.concatenate([x + 1.0, 1.0 - x]),  # -1 <= x <= 1
        nvar=nvar, nineq=2 * nvar)


def main():
    problems, x0s = [], []
    # three different shapes: QPs of dim 2 and 4, plus reference problem 5
    for i in range(6):
        problems.append(box_qp(2, i));       x0s.append(np.zeros(2))
    for i in range(5):
        problems.append(box_qp(4, 10 + i));  x0s.append(np.zeros(4))
    spec = get_problem(5)
    problems.append(spec.make(dtype=np.float64))
    x0s.append(np.zeros(2))

    results = solve_fleet(problems, x0s, IPMConfig(verbosity=0))
    for i, r in enumerate(results):
        print(f"instance {i:2d}: D={r.x.shape[0]} signal={int(r.signal)} "
              f"f={float(r.fval):+.4f}")
    assert all(int(r.signal) in (1, 2) for r in results)
    # the reference-problem instance lands on its known optimum (4, 3)
    assert np.allclose(np.asarray(results[-1].x), [4.0, 3.0], atol=1e-3)


if __name__ == "__main__":
    main()
