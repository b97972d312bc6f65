"""Worker for the 2-process jax.distributed CPU test (test_distributed.py).

Each process exposes 4 virtual CPU devices (8 global), joins the cluster
through ``distributed.initialize``, builds the global batch mesh, feeds its
host-local input shard via ``host_local_slice`` +
``jax.make_array_from_process_local_data``, runs one batched solve, and
checks the globally-gathered results.  Run via::

    python tests/distributed_worker.py <coordinator_port> <process_id> <nproc>
"""

import os
import sys

LOCAL_DEVICES = 4

port, proc_id, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from pyipm_jax import IPMConfig  # noqa: E402
from pyipm_jax.models.reference_problems import get_problem  # noqa: E402
from pyipm_jax.parallel import distributed as dist  # noqa: E402
from pyipm_jax.parallel.batch import make_batch_solver  # noqa: E402


def main():
    dist.initialize(coordinator_address=f"localhost:{port}",
                    num_processes=nproc, process_id=proc_id)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == proc_id
    assert len(jax.devices()) == LOCAL_DEVICES * nproc
    assert len(jax.local_devices()) == LOCAL_DEVICES

    mesh = dist.global_batch_mesh()
    assert mesh.devices.size == LOCAL_DEVICES * nproc

    # 2-D global mesh constructor is exercised for shape bookkeeping
    mesh2 = dist.global_solver_mesh(batch=nproc, model=LOCAL_DEVICES)
    assert mesh2.devices.shape == (nproc, LOCAL_DEVICES)

    # Global batch of identical-seeded starts on every host; each host
    # materializes ONLY its host_local_slice and hands JAX the local shard.
    B = 4 * LOCAL_DEVICES * nproc
    spec = get_problem(7)
    prob = spec.make(dtype=np.float64)
    rng = np.random.default_rng(42)
    x0_global = np.stack([spec.sample_x0(rng) for _ in range(B)])
    sl = dist.host_local_slice(B)
    assert (sl.stop - sl.start) * nproc == B
    x0_local = x0_global[sl]

    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("batch"))
    x0_sharded = jax.make_array_from_process_local_data(
        sharding, x0_local, global_shape=x0_global.shape)

    cfg = IPMConfig(Ftol=1e-8, verbosity=0)
    fn = make_batch_solver(prob, cfg, mesh=mesh)
    res = fn(x0_sharded)
    res.x.block_until_ready()

    from jax.experimental import multihost_utils

    sigs = np.asarray(multihost_utils.process_allgather(
        res.signal, tiled=True))
    xs = np.asarray(multihost_utils.process_allgather(res.x, tiled=True))
    assert sigs.shape == (B,), sigs.shape
    assert np.all(np.isin(sigs, (1, 2))), sigs
    gt = np.asarray(spec.ground_truth)
    dist_to_gt = np.min(
        np.linalg.norm(xs[:, None, :] - gt[None], axis=-1), axis=1)
    assert np.all(dist_to_gt <= 1e-3), dist_to_gt

    print(f"[worker {proc_id}] OK: {B} instances over "
          f"{LOCAL_DEVICES * nproc} devices / {nproc} processes")


if __name__ == "__main__":
    main()
