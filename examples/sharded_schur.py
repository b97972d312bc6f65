"""Sharded model-parallel solve: one LARGE block-separable NLP whose
variable blocks live on different devices (the TP analog; no reference
counterpart — reference pyipm.py is single-device by construction).

The condensed KKT system's Schur complement over the coupling constraints
is reduced with ``psum`` inside ``shard_map`` over the mesh's ``model``
axis, so the per-iteration linear algebra runs block-local with one small
collective.  Here: 8 virtual CPU devices; on a multi-GPU host the same
code runs its collectives as NCCL calls.

    python examples/sharded_schur.py
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np                          # noqa: E402

from pyipm_jax import IPMConfig             # noqa: E402
from pyipm_jax.parallel.mesh import make_solver_mesh  # noqa: E402
from pyipm_jax.parallel.schur import (      # noqa: E402
    make_separable_solver, sample_separable,
)


def main():
    mesh = make_solver_mesh(batch=1, model=8)
    K, d, mc = 16, 32, 4                    # 16 blocks x 32 vars, 4 couplings
    spec, data, x0 = sample_separable(jax.random.key(0), K, d, mc)
    cfg = IPMConfig(float_dtype="float32", verbosity=0)
    solve = make_separable_solver(spec, mesh, cfg, axis="model")
    res = solve(x0, data)
    print(f"{K * d} variables in {K} blocks over "
          f"{mesh.devices.size} devices: signal={int(res.signal)}, "
          f"kkt={np.asarray(res.kkt)}")
    assert int(res.signal) in (1, 2)

    # --- full generality: nonlinear per-block inequalities + equalities
    # and a NONLINEAR coupling cc(sum_k g_k(x_k)) = 0 through the bordered
    # Schur complement (BlockNLP / make_block_solver)
    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    gspec, gtheta, gccdata, gx0 = sample_block_general(
        jax.random.key(1), K, 3, me=1, ni=2, p=2, mc=1,
        dtype=jax.numpy.float32)
    gfn = make_block_solver(gspec, mesh, cfg, axis="model")
    gres = gfn(gx0, gtheta, ccdata=gccdata)
    print(f"general block NLP (nonlinear coupling): "
          f"signal={int(gres.signal)}, kkt={np.asarray(gres.kkt)}")
    assert int(gres.signal) in (1, 2)

    # --- AFFINE coupling: declare it (BlockNLP.linear_coupling=True) and
    # the solver fuses the pooled-feature reduction, the Schur-border
    # formation, and the first bordered solve into ONE collective per
    # iteration (fewer all-reduces per iteration than the general path —
    # benchmarks/collective_census.py counts them); identical
    # solutions to the general path (tests/test_schur.py pins it)
    lspec, ltheta, lccdata, lx0 = sample_block_general(
        jax.random.key(2), K, 3, me=1, ni=2, p=2, mc=1,
        dtype=jax.numpy.float32, nonlinear_cc=False)
    assert lspec.linear_coupling
    lres = make_block_solver(lspec, mesh, cfg, axis="model")(
        lx0, ltheta, ccdata=lccdata)
    print(f"linear-coupling block NLP (fused border): "
          f"signal={int(lres.signal)}, kkt={np.asarray(lres.kkt)}")
    assert int(lres.signal) in (1, 2)


if __name__ == "__main__":
    main()
