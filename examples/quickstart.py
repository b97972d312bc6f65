"""Quick start: the class facade on the reference's example problem 7.

    max xyz   s.t.  x + y + z = 1,  x, y, z >= 0

(reference pyipm.py:2043-2064; ground truth x = y = z = 1/3).  Identical
surface to the reference: construct ``IPM`` with plain callables, call
``solve()``, get the 5-tuple ``(x, s, lda, fval, kkt)``.

    python examples/quickstart.py
"""

import jax

jax.config.update("jax_platforms", "cpu")   # run anywhere; drop for a GPU
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp                     # noqa: E402
import numpy as np                          # noqa: E402

from pyipm_jax import IPM                   # noqa: E402


def main():
    problem = IPM(
        x0=np.array([0.2, 0.3, 0.5]),
        f=lambda x: -x[0] * x[1] * x[2],          # maximize xyz
        ce=lambda x: jnp.array([x[0] + x[1] + x[2] - 1.0]),
        ci=lambda x: x,                           # x, y, z >= 0
        Ftol=1e-8,
    )
    x, s, lda, fval, kkt = problem.solve()
    print("x     =", x)
    print("s     =", s)
    print("lda   =", lda)
    print("f(x)  =", fval)
    print("KKT   =", [np.asarray(k) for k in kkt])
    assert np.allclose(x, 1.0 / 3.0, atol=1e-3)


if __name__ == "__main__":
    main()
