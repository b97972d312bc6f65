"""Checkpoint / resume: pause a solve mid-flight, serialize the
SolverState pytree, restore it in a "new process", and finish — the
result is bit-identical to an uninterrupted solve.

The reference has no checkpointing (its de-facto resume is warm-starting
x0/s0/lda0, reference pyipm.py:1567-1578, losing mu/nu/delta/L-BFGS
state); here the ENTIRE iteration state is one immutable pytree that is
both the ``lax.while_loop`` carry and the checkpoint unit.

    python examples/checkpoint_resume.py
"""

import os
import tempfile

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax                                  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np                          # noqa: E402

from pyipm_jax import IPMConfig             # noqa: E402
from pyipm_jax.core.solver import make_solver  # noqa: E402
from pyipm_jax.models.reference_problems import get_problem  # noqa: E402
from pyipm_jax.utils.checkpoint import restore_state, save_state  # noqa: E402


def main():
    spec = get_problem(10)                  # mixed eq+ineq problem
    prob = spec.make(dtype=np.float64)
    cfg = IPMConfig(verbosity=0)
    solver = make_solver(prob, cfg)
    x0 = np.zeros(3)

    # uninterrupted solve, for comparison
    full = solver.finalize(solver.run(solver.init_state(x0)))

    # run 3 iterations, checkpoint, "crash"
    st = solver.run_budget(solver.init_state(x0), 3)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ckpt"
        save_state(path, st)
        # ... new process: rebuild the solver, restore, finish
        st2 = restore_state(path, solver.init_state(x0))
        res = solver.finalize(solver.run(st2))

    print("resumed  x =", np.asarray(res.x), "signal", int(res.signal))
    print("straight x =", np.asarray(full.x), "signal", int(full.signal))
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(full.x))
    assert int(res.iter_count) == int(full.iter_count)
    print("bit-identical after resume:",
          int(res.iter_count), "total iterations")


def main_distributed():
    """Same contract for the DISTRIBUTED block solver: the sharded
    SolverState is the checkpoint unit, so multi-host failure recovery is
    relaunch-same-world-size + restore + resume (parallel/launch.py)."""
    import jax.numpy as jnp

    from pyipm_jax.parallel.schur import (
        make_block_solver, sample_block_general,
    )

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("model",))
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(3), 8, 3, me=1, ni=2, p=2, mc=1)
    cfg = IPMConfig(float_dtype="float64", verbosity=0)
    fn = make_block_solver(spec, mesh, cfg)

    full = fn(x0, theta, ccdata=ccdata)
    st = fn.run_budget(fn.init_state(x0, theta, ccdata=ccdata),
                       theta, ccdata=ccdata, max_new_iters=3)
    host = jax.tree.map(np.asarray, st)     # the checkpoint payload
    st2 = jax.tree.map(jnp.asarray, host)   # "new process" restore
    res = fn.finalize(fn.run(st2, theta, ccdata=ccdata),
                      theta, ccdata=ccdata)
    np.testing.assert_array_equal(np.asarray(res.x), np.asarray(full.x))
    print("distributed resume bit-identical:",
          int(res.iter_count), "total iterations over",
          mesh.devices.size, "devices")


if __name__ == "__main__":
    main()
    main_distributed()
