"""Worker for the launcher test (test_launch.py): joins the cluster purely
through the ``PYIPM_*`` rendezvous environment set by
``pyipm_jax.parallel.launch`` — no argv plumbing — then runs one tiny
mesh-sharded batched solve and prints a per-rank OK line.

Also doubles as the fail-fast fixture: ``--fail-rank R`` makes rank R
exit(3) before joining, which must take the whole job down.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from pyipm_jax import IPMConfig  # noqa: E402
from pyipm_jax.models.reference_problems import get_problem  # noqa: E402
from pyipm_jax.parallel import distributed as dist  # noqa: E402
from pyipm_jax.parallel.batch import make_batch_solver  # noqa: E402
from pyipm_jax.parallel.launch import ENV_PROC_ID  # noqa: E402


def main():
    import os

    rank = int(os.environ[ENV_PROC_ID])
    if "--fail-rank" in sys.argv:
        r = int(sys.argv[sys.argv.index("--fail-rank") + 1])
        if rank == r:
            sys.exit(3)

    dist.initialize()                  # env-driven: launcher contract
    nproc = jax.process_count()
    assert nproc > 1, "launcher did not form a cluster"
    from pyipm_jax.parallel.launch import ENV_LOCAL_DEVICES
    want = os.environ.get(ENV_LOCAL_DEVICES)
    if want is not None:
        # --local-devices must win over any inherited XLA_FLAGS device
        # count (spawn_local REPLACES the flag; see parallel/launch.py)
        assert jax.local_device_count() == int(want), (
            jax.local_device_count(), want)
    mesh = dist.global_batch_mesh()

    B = 2 * mesh.devices.size
    spec = get_problem(1)              # unconstrained quadratic: fastest
    prob = spec.make(dtype=np.float64)
    rng = np.random.default_rng(0)
    x0_global = np.stack([spec.sample_x0(rng) for _ in range(B)])
    sl = dist.host_local_slice(B)

    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("batch"))
    x0 = jax.make_array_from_process_local_data(
        sharding, x0_global[sl], global_shape=x0_global.shape)

    fn = make_batch_solver(prob, IPMConfig(verbosity=0), mesh=mesh)
    res = fn(x0)
    res.x.block_until_ready()

    from jax.experimental import multihost_utils

    sigs = np.asarray(
        multihost_utils.process_allgather(res.signal, tiled=True))
    assert np.all(sigs == 1), sigs
    print(f"[rank {jax.process_index()}] OK over {nproc} processes")


if __name__ == "__main__":
    main()
