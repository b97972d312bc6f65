"""Round-4 distributed features in one walkthrough:

1. **Per-block L-BFGS** (`IPMConfig(lbfgs=m)`): the sharded block solver
   replaces its d^3 per-block factorization with a compact Woodbury
   operator, so blocks far beyond the dense factorization's reach
   (benchmarks/bench_schur_scaling.py --mode dsweep) stay cheap per
   iteration.  Here: a CPU-sized demo with d = 512 blocks.

2. **Ragged blocks**: per-block constraint counts (me_k, ni_k) under
   static maxima + validity masks — one compiled SPMD program solves a
   fleet of UNEQUAL blocks (`BlockNLP(ce_mask_key=..., ci_mask_key=...)`).

    python examples/block_lbfgs_and_ragged.py
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp                     # noqa: E402
import numpy as np                          # noqa: E402

from pyipm_jax import IPMConfig             # noqa: E402
from pyipm_jax.parallel.mesh import make_solver_mesh  # noqa: E402
from pyipm_jax.parallel.schur import (      # noqa: E402
    BlockNLP, box_ci, make_block_solver, sample_block_ragged,
)


def main():
    mesh = make_solver_mesh(batch=1, model=8)

    # ---- 1. per-block L-BFGS: big diagonal-quadratic blocks ----------
    K, d, p = 8, 512, 4
    kq, kc, ka, kx = jax.random.split(jax.random.key(3), 4)
    theta = {
        "q": 0.5 + jax.random.uniform(kq, (K, d), jnp.float32),
        "c": jax.random.normal(kc, (K, d), jnp.float32),
        "A": jax.random.normal(ka, (K, p, d), jnp.float32)
        / np.sqrt(K * d),
        "lb": jnp.full((K, d), -3.0, jnp.float32),
    }
    xf = jax.random.normal(kx, (K, d), jnp.float32) * 0.1
    ccdata = {"b": jnp.einsum("kpd,kd->p", theta["A"], xf)}

    spec = BlockNLP(
        f_blk=lambda xk, th: 0.5 * xk @ (th["q"] * xk) + th["c"] @ xk,
        d=d, ci_blk=box_ci("lb"), ni=d, ci_identity=True,
        g_blk=lambda xk, th: th["A"] @ xk,
        cc=lambda u, ccd: u - ccd["b"], p=p, mc=p)
    cfg = IPMConfig(float_dtype="float32", verbosity=0, lbfgs=8,
                    niter=20, miter=60)
    res = make_block_solver(spec, mesh, cfg)(
        jnp.zeros((K, d), jnp.float32), theta, ccdata=ccdata)
    assert int(res.signal) in (1, 2), np.asarray(res.kkt)
    print(f"L-BFGS block solve: {K * d} vars (d={d}/block), "
          f"signal={int(res.signal)}, iters={int(res.iter_count)}, "
          f"kkt={np.asarray(res.kkt)}")

    # ---- 2. ragged blocks: unequal (me_k, ni_k) in ONE program -------
    rspec, rtheta, rccdata, rx0, me_k, ni_k = sample_block_ragged(
        jax.random.key(21), 8, d=4, me=2, ni=3, p=2, mc=1,
        dtype=jnp.float32)
    rcfg = IPMConfig(float_dtype="float32", verbosity=0)
    rres = make_block_solver(rspec, mesh, rcfg)(
        rx0, rtheta, ccdata=rccdata)
    assert int(rres.signal) in (1, 2), np.asarray(rres.kkt)
    # inactive rows stay exactly pinned
    ce_m = np.asarray(rtheta["ce_mask"])
    assert np.all(np.asarray(rres.le)[ce_m == 0] == 0.0)
    print(f"ragged block solve: me_k={me_k.tolist()}, "
          f"ni_k={ni_k.tolist()}, signal={int(rres.signal)}, "
          f"iters={int(rres.iter_count)}")
    print("OK")


if __name__ == "__main__":
    main()
