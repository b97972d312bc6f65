"""float32 robustness sweep.

The reference warns that 32-bit precision is "not recommended"
(reference pyipm.py:205-209), but f32 is the accelerator's fast dtype,
so this build must stay finite and convergent in f32.  Regression for
the inertia-correction escalation bug where the LDL^T retry loop required
a conditioning bound that ill-conditioned-but-solvable KKT systems never
meet, driving delta to overflow (fixed: retry on inertia/finiteness only,
matching reference pyipm.py:1399)."""

import numpy as np
import pytest

from pyipm_jax import IPMConfig
from pyipm_jax.core.solver import make_solver
from pyipm_jax.models import REFERENCE_PROBLEMS


@pytest.mark.parametrize("num", sorted(REFERENCE_PROBLEMS))
def test_f32_ldlt_converges(num):
    spec = REFERENCE_PROBLEMS[num]
    prob = spec.make(dtype=np.float32)
    rng = np.random.default_rng(7)
    x0 = spec.sample_x0(rng).astype(np.float32)
    cfg = IPMConfig(Ftol=1e-8, verbosity=0, float_dtype="float32")
    res = make_solver(prob, cfg)(x0)
    x = np.asarray(res.x)
    assert np.all(np.isfinite(x))
    assert int(res.signal) in (1, 2)
    # f32 oracle: looser than the f64 Stol=1e-3 only in principle; in
    # practice all 10 land well inside it
    assert spec.distance_to_truth(x) <= 5e-3


def test_float32_coupling_inequality_distributed():
    """The f32 robustness stack holds for the new coupling-inequality
    path on the 8-device mesh (Ruiz + mu floor + guarded refinement)."""
    import jax
    import jax.numpy as jnp

    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    K, d = 8, 3
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(31), K, d, me=1, ni=2, p=2, mc=1, mci=1,
        dtype=jnp.float32)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("model",))
    cfg = IPMConfig(float_dtype="float32", verbosity=0, niter=10,
                    miter=25)
    res = make_block_solver(spec, mesh, cfg)(x0, theta, ccdata=ccdata)
    assert int(res.signal) == 1, np.asarray(res.kkt)
    assert np.all(np.asarray(res.kkt) <= cfg.Ktol * (1 + 1e-6))
    assert np.all(np.asarray(res.sc) > 0)
