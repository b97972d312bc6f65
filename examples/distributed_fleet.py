"""Multi-process batched solving via the launcher (comm-backend +
launcher analog; the reference is single-process by construction).

Run through the launcher's local spawn mode (2 processes x 4 virtual CPU
devices each — the same code launches one-process-per-host on a real
cluster):

    python -m pyipm_jax.parallel.launch --spawn 2 examples/distributed_fleet.py
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np                          # noqa: E402

from pyipm_jax import IPMConfig             # noqa: E402
from pyipm_jax.models.reference_problems import get_problem  # noqa: E402
from pyipm_jax.parallel import distributed as dist  # noqa: E402
from pyipm_jax.parallel.batch import make_batch_solver  # noqa: E402


def main():
    dist.initialize()                       # launcher rendezvous env
    mesh = dist.global_batch_mesh()
    B = 4 * mesh.devices.size

    spec = get_problem(9)
    prob = spec.make(dtype=np.float64)
    rng = np.random.default_rng(7)
    x0_global = np.stack([spec.sample_x0(rng) for _ in range(B)])

    # each process materializes only its slice of the global batch
    sl = dist.host_local_slice(B)
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("batch"))
    x0 = jax.make_array_from_process_local_data(
        sharding, x0_global[sl], global_shape=x0_global.shape)

    fn = make_batch_solver(prob, IPMConfig(verbosity=0), mesh=mesh)
    res = fn(x0)

    from jax.experimental import multihost_utils

    sigs = np.asarray(multihost_utils.process_allgather(
        res.signal, tiled=True))
    if jax.process_index() == 0:
        print(f"{B} instances over {jax.process_count()} processes / "
              f"{mesh.devices.size} devices: "
              f"{int(np.sum(np.isin(sigs, (1, 2))))} converged")
    assert np.all(np.isin(sigs, (1, 2)))


if __name__ == "__main__":
    main()
