"""The 10 bundled example problems of the reference, as pure JAX callables.

These mirror the problem definitions in the reference CLI ``main()``
(reference pyipm.py:1920-2131) and double as the conformance suite: the
build target is all 10 converged to Ktol parity (BASELINE.md).

Each entry provides the objective/constraints, a ground-truth set (several
problems have multiple optima, e.g. problem 4 lists three,
pyipm.py:1984-1988), and the reference's x0 sampler.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from pyipm_jax.core.problem import Problem, make_problem


@dataclasses.dataclass(frozen=True)
class ReferenceProblem:
    name: str
    description: str
    nvar: int
    f: Callable
    ce: Optional[Callable]
    ci: Optional[Callable]
    ground_truth: Sequence[Sequence[float]]   # one or more optima
    sample_x0: Callable                        # rng -> x0 (reference sampler)

    def make(self, dtype=np.float64, **overrides) -> Problem:
        return make_problem(self.f, self.nvar, ce=self.ce, ci=self.ci,
                            dtype=dtype, **overrides)

    def distance_to_truth(self, x) -> float:
        """Distance to the nearest known optimum (the unit-test oracle,
        reference unit_tests.py:405-409)."""
        x = np.asarray(x)
        return min(float(np.linalg.norm(x - np.asarray(gt)))
                   for gt in self.ground_truth)


_SQ2 = float(np.sqrt(2.0))
_SQ3 = float(np.sqrt(3.0))
_SQ13 = float(np.sqrt(13.0))


def _p1_f(x):
    # pyipm.py:1925-1926
    return x[0] ** 2 - 4 * x[0] + x[1] ** 2 - x[1] - x[0] * x[1]


def _p2_f(x):
    # 2D Rosenbrock (pyipm.py:1943)
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


def _p3_f(x):
    return -jnp.sum(x)


def _p3_ce(x):
    return jnp.sum(x ** 2) - 1.0


def _p4_f(x):
    return -(x[0] ** 2) * x[1]


def _p4_ce(x):
    return jnp.sum(x ** 2) - 3.0


def _p5_f(x):
    return x[0] ** 2 + 2.0 * x[1] ** 2 + 2.0 * x[0] + 8.0 * x[1]


def _p5_ci(x):
    return jnp.stack([x[0] + 2.0 * x[1] - 10.0, x[0], x[1]])


def _p6_f(x):
    eps = jnp.finfo(x.dtype).eps
    return jnp.sum(x * jnp.log(x + eps))


def _p6_ce(x):
    return jnp.sum(x) - 1.0


def _p6_ci(x):
    return 1.0 * x


def _p7_f(x):
    return -x[0] * x[1] * x[2]


def _p7_ce(x):
    return jnp.sum(x) - 1.0


def _p7_ci(x):
    return 1.0 * x


def _p8_f(x):
    return 4.0 * x[1] - 2.0 * x[2]


def _p8_ce(x):
    return jnp.stack([2.0 * x[0] - x[1] - x[2] - 2.0,
                      x[0] ** 2 + x[1] ** 2 - 1.0])


def _p9_f(x):
    return (x[0] - 2.0) ** 2 + 2.0 * (x[1] - 1.0) ** 2


def _p9_ci(x):
    return jnp.stack([-x[0] - 4.0 * x[1] + 3.0, x[0] - x[1]])


def _p10_f(x):
    return ((x[0] - 1.0) ** 2 + 2.0 * (x[1] + 2.0) ** 2
            + 3.0 * (x[2] + 3.0) ** 2)


def _p10_ce(x):
    return x[2] - x[1] - x[0] - 1.0


def _p10_ci(x):
    return x[2] - x[0] ** 2


def _randn(n):
    def sample(rng):
        return rng.standard_normal(n)
    return sample


def _p6_x0(rng):
    # pyipm.py:2024-2025: uniform, normalized to the simplex
    x0 = rng.random(6)
    return x0 / np.sum(x0)


REFERENCE_PROBLEMS = {
    1: ReferenceProblem(
        "p1_unconstrained_quadratic",
        "min x^2 - 4x + y^2 - y - xy (pyipm.py:1920-1936)",
        2, _p1_f, None, None, [[3.0, 2.0]], _randn(2)),
    2: ReferenceProblem(
        "p2_rosenbrock",
        "2D Rosenbrock (pyipm.py:1937-1953)",
        2, _p2_f, None, None, [[1.0, 1.0]], _randn(2)),
    3: ReferenceProblem(
        "p3_eq_circle",
        "max x+y s.t. x^2+y^2=1 (pyipm.py:1954-1971)",
        2, _p3_f, _p3_ce, None, [[_SQ2 / 2, _SQ2 / 2]], _randn(2)),
    4: ReferenceProblem(
        "p4_eq_sphere",
        "max x^2*y s.t. x^2+y^2=3 (pyipm.py:1972-1994)",
        2, _p4_f, _p4_ce, None,
        [[_SQ2, 1.0], [-_SQ2, 1.0], [0.0, -_SQ3]], _randn(2)),
    5: ReferenceProblem(
        "p5_ineq_qp",
        "min x^2+2y^2+2x+8y s.t. x+2y>=10, x,y>=0 (pyipm.py:1995-2018)",
        2, _p5_f, None, _p5_ci, [[4.0, 3.0]], _randn(2)),
    6: ReferenceProblem(
        "p6_maxent_die",
        "max entropy 6-die s.t. sum=1, x>=0 (pyipm.py:2019-2042)",
        6, _p6_f, _p6_ce, _p6_ci, [[1.0 / 6.0] * 6], _p6_x0),
    7: ReferenceProblem(
        "p7_maxprod",
        "max xyz s.t. x+y+z=1, x,y,z>=0 (pyipm.py:2043-2064)",
        3, _p7_f, _p7_ce, _p7_ci, [[1.0 / 3.0] * 3], _randn(3)),
    8: ReferenceProblem(
        "p8_two_eq",
        "min 4y-2z s.t. 2x-y-z=2, x^2+y^2=1 (pyipm.py:2065-2088)",
        3, _p8_f, _p8_ce, None,
        [[2.0 / _SQ13, -3.0 / _SQ13, -2.0 + 7.0 / _SQ13]], _randn(3)),
    9: ReferenceProblem(
        "p9_ineq_qp2",
        "min (x-2)^2+2(y-1)^2 s.t. x+4y<=3, x>=y (pyipm.py:2089-2110)",
        2, _p9_f, None, _p9_ci, [[5.0 / 3.0, 1.0 / 3.0]], _randn(2)),
    10: ReferenceProblem(
        "p10_mixed",
        "min (x-1)^2+2(y+2)^2+3(z+3)^2 s.t. z-y-x=1, z>=x^2 "
        "(pyipm.py:2111-2131)",
        3, _p10_f, _p10_ce, _p10_ci,
        [[0.12288, -1.1078, 0.015100]], _randn(3)),
}


def get_problem(num: int) -> ReferenceProblem:
    return REFERENCE_PROBLEMS[num]
