"""Multi-host runtime helpers.

The reference is strictly single-process (SURVEY.md §2 absence table); the
replacement for the launcher/communication-backend role is
``jax.distributed`` + a global device mesh.  Each process runs the SAME
program; XLA compiles the shard_map/psum collectives into NCCL calls
between the GPUs of a host and across hosts.

Typical multi-host launch (one process per host):

    from pyipm_jax.parallel import distributed as dist
    dist.initialize()                       # launcher-env driven
    mesh = dist.global_batch_mesh()         # all devices, 'batch' axis
    fn = make_batch_solver(problem, cfg, mesh=mesh)
    res = fn(x0_global)                     # inputs sharded over hosts
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np


def _apply_local_devices() -> None:
    """Honor the launcher's PYIPM_LOCAL_DEVICES contract: when set (and the
    XLA backend has not been touched yet), force that many virtual CPU host
    devices.  spawn_local also sets XLA_FLAGS directly for its children, so
    this matters for cluster-mode workers launched by hand."""
    from pyipm_jax.parallel import launch as _l

    local = os.environ.get(_l.ENV_LOCAL_DEVICES)
    if local is None:
        return
    os.environ["XLA_FLAGS"] = _l._set_device_count_flag(
        os.environ.get("XLA_FLAGS", ""), int(local))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the multi-host runtime (no-op when single-process).

    Rendezvous resolution order: explicit arguments, then the ``PYIPM_*``
    environment block set by the launcher (``parallel/launch.py``), then
    jax's own environment discovery (e.g. under SLURM).

    Must run before anything touches the XLA backend (jax.devices,
    any computation); checked via ``jax.distributed.is_initialized`` —
    NOT ``jax.process_count()``, which would itself boot the backend."""
    if jax.distributed.is_initialized():
        return  # already initialized
    if coordinator_address is None and num_processes is None:
        # launcher rendezvous env (parallel/launch.py contract)
        from pyipm_jax.parallel import launch as _l

        coordinator_address = os.environ.get(_l.ENV_COORD)
        if coordinator_address is not None:
            nproc = os.environ.get(_l.ENV_NPROC)
            pid = os.environ.get(_l.ENV_PROC_ID)
            if nproc is None or pid is None:
                raise RuntimeError(
                    f"incomplete launcher rendezvous environment: "
                    f"{_l.ENV_COORD} is set but "
                    f"{_l.ENV_NPROC}/{_l.ENV_PROC_ID} "
                    f"{'are' if nproc is None and pid is None else 'is'} "
                    f"missing; all three must be set together "
                    f"(see pyipm_jax.parallel.launch.rendezvous_env)")
            num_processes = int(nproc)
            process_id = int(pid)
        _apply_local_devices()
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception:
            # single-process / no coordinator configured: run locally
            return
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)


def global_batch_mesh() -> jax.sharding.Mesh:
    """1-D mesh over ALL devices of all hosts with a ``batch`` axis."""
    return jax.sharding.Mesh(
        np.asarray(jax.devices()), ("batch",),
        axis_types=(jax.sharding.AxisType.Auto,))


def global_solver_mesh(batch: int, model: int) -> jax.sharding.Mesh:
    """2-D (batch, model) mesh over all devices; ``model`` should map to
    the devices of one host (the Schur psum rides that axis)."""
    devs = np.asarray(jax.devices())
    assert batch * model == devs.size, (
        f"mesh {batch}x{model} != {devs.size} devices")
    return jax.sharding.Mesh(
        devs.reshape(batch, model), ("batch", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)


def host_local_slice(global_batch: int) -> slice:
    """The [start, stop) slice of a leading global batch axis owned by
    this host (for building host-local input shards)."""
    per = global_batch // jax.process_count()
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
