"""Batched scenario solving: thousands of independent NLP instances on one
chip via the wave-compacted batch solver (the DP-analog layer; no
reference counterpart — reference pyipm.py solves one problem per host
loop).

Each instance is a random inequality-constrained QP-objective NLP from the
same family (one compiled solver, per-instance data), solved with
converged instances retiring early instead of paying the vmap lockstep
straggler tax.

    python examples/batched_fleet.py [batch]
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")   # drop to run on a GPU

import jax.numpy as jnp                     # noqa: E402
import numpy as np                          # noqa: E402

from pyipm_jax import IPMConfig             # noqa: E402
from pyipm_jax.models.random_nlp import (   # noqa: E402
    make_qp_problem, sample_qp_batch,
)
from pyipm_jax.parallel.batch import make_wave_batch_solver  # noqa: E402


def main(batch=512, nvar=8, nlin=3):
    cfg = IPMConfig(float_dtype="float32", verbosity=0,
                    mu_strategy="mehrotra")   # predictor-corrector barrier
    solver = make_wave_batch_solver(
        config=cfg, family=lambda d: make_qp_problem(d, nvar, nlin),
        first_wave=8, wave=16)

    data = sample_qp_batch(jax.random.key(0), batch, nvar, nlin=nlin)
    x0 = jnp.zeros((batch, nvar), jnp.float32)
    res = solver(x0, data)

    sigs = np.asarray(res.signal)
    iters = np.asarray(res.iter_count)
    print(f"{batch} instances: "
          f"{int(np.sum(np.isin(sigs, (1, 2))))} converged, "
          f"mean {iters.mean():.1f} iterations, "
          f"max KKT residual "
          f"{float(np.max(np.asarray(res.kkt))):.2e}")
    assert np.mean(np.isin(sigs, (1, 2))) > 0.99


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
