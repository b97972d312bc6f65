"""Worker for the 2-process general Schur/TP test (test_distributed.py).

THE cross-process execution proof for the model-parallel layer: the same
general block NLP (nonlinear per-block ce/ci + nonlinear coupling eq AND
ineq) that the single-process parity suite solves (tests/test_schur.py)
is solved here over a (batch=1, model=8) mesh whose ``model`` axis SPANS
a real OS process boundary — 2 processes x 4 virtual CPU devices, blocks
0-3 owned by process 0 and 4-7 by process 1, with block-sharded
``theta``/``x0`` built via ``jax.make_array_from_process_local_data``.
Checks, in order:

1. the straight-through distributed solve converges (signal 1) and its
   gathered solution matches an in-process single-device solve of the
   ASSEMBLED problem to roundoff (x, fval, iter count) — the same oracle
   as tests/test_schur.py::test_block_general_parity_with_assembled;
2. init_state -> run_budget(3) pauses mid-solve, the sharded SolverState
   round-trips through a HOST npz checkpoint file (allgather -> disk ->
   reload -> reshard via ``fn.state_specs``), and the resumed solve is
   BIT-EXACT against the straight-through result — the multi-host
   failure-recovery contract (relaunch + resume from checkpoint).

Run via::

    python tests/schur_worker.py <coordinator_port> <process_id> <nproc>
"""

import os
import sys
import tempfile

LOCAL_DEVICES = 4

port, proc_id, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={LOCAL_DEVICES}")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from pyipm_jax import IPMConfig  # noqa: E402
from pyipm_jax.parallel import distributed as dist  # noqa: E402
from pyipm_jax.parallel.schur import (  # noqa: E402
    make_block_solver, sample_block_general,
)

K, D, ME, NI, P_, MC, MCI = 8, 3, 1, 2, 2, 1, 1


def shard_blocked(mesh, full, axis="model"):
    """Global block-sharded array from a host-full value: this process
    hands JAX only its host-local row slice."""
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(axis))
    sl = dist.host_local_slice(full.shape[0])
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(full)[sl], global_shape=full.shape)


def gather(a):
    return np.asarray(multihost_utils.process_allgather(a, tiled=True))


def main():
    dist.initialize(coordinator_address=f"localhost:{port}",
                    num_processes=nproc, process_id=proc_id)
    assert jax.process_count() == nproc
    assert len(jax.devices()) == LOCAL_DEVICES * nproc

    mesh = dist.global_solver_mesh(batch=1, model=LOCAL_DEVICES * nproc)

    # identical seed on every process -> identical host-full data; each
    # process then shards ONLY its local blocks onto the global mesh
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(11), K, D, me=ME, ni=NI, p=P_, mc=MC, mci=MCI)
    theta_h = jax.tree.map(np.asarray, theta)
    x0_g = shard_blocked(mesh, np.asarray(x0))
    theta_g = jax.tree.map(lambda a: shard_blocked(mesh, a), theta_h)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    ccdata_g = jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(
            rep, np.asarray(a), global_shape=np.shape(a)), ccdata)

    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=10,
                    miter=25)
    fn = make_block_solver(spec, mesh, cfg)

    # ---- 1. straight-through cross-process solve + assembled oracle ----
    res = fn(x0_g, theta_g, ccdata=ccdata_g)
    sig = int(gather(res.signal))
    assert sig == 1, (sig, gather(res.kkt))
    x_d = gather(res.x).reshape(-1)

    # in-process single-device oracle on the assembled problem (no
    # collectives; every process computes its own copy independently)
    from pyipm_jax.core.problem import Problem
    from pyipm_jax.core.solver import solve as solve_single

    def f(x):
        xb = x.reshape(K, D)
        return jnp.sum(jax.vmap(spec.f_blk)(xb, theta))

    def ce(x):
        xb = x.reshape(K, D)
        per = jax.vmap(spec.ce_blk)(xb, theta).reshape(-1)
        u = jnp.sum(jax.vmap(spec.g_blk)(xb, theta), axis=0)
        return jnp.concatenate([per, spec.cc(u, ccdata)])

    def ci(x):
        xb = x.reshape(K, D)
        per = jax.vmap(spec.ci_blk)(xb, theta).reshape(-1)
        u = jnp.sum(jax.vmap(spec.g_blk)(xb, theta), axis=0)
        return jnp.concatenate([per, spec.cci(u, ccdata)])

    prob = Problem(f=f, nvar=K * D, neq=K * ME + MC, nineq=K * NI + MCI,
                   ce=ce, ci=ci)
    # no hand-fed lda0: both sides default to the least-squares
    # multiplier init (the distributed one crosses the process boundary
    # through its border psums)
    scfg = cfg.replace(linear_solver="condensed")
    res_s = solve_single(prob, np.asarray(x0).reshape(-1), scfg)
    assert int(res_s.signal) == 1, np.asarray(res_s.kkt)
    np.testing.assert_allclose(x_d, np.asarray(res_s.x),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(gather(res.fval)),
                               float(res_s.fval), rtol=1e-9)
    assert abs(int(gather(res.iter_count))
               - int(res_s.iter_count)) <= 1

    # ---- 2. budgeted run + npz checkpoint + cross-process resume ------
    st = fn.init_state(x0_g, theta_g, ccdata=ccdata_g)
    st = fn.run_budget(st, theta_g, ccdata=ccdata_g, max_new_iters=3)
    assert int(gather(st.signal)) == 0          # paused mid-solve

    # checkpoint: allgather the sharded carry to host-full values, write
    # a real npz file, reload, reshard via fn.state_specs
    host = jax.tree.map(gather, st)
    leaves, treedef = jax.tree.flatten(host)
    ckpt = os.path.join(tempfile.gettempdir(),
                        f"schur_ckpt_{port}_{proc_id}.npz")
    np.savez(ckpt, **{f"a{i}": v for i, v in enumerate(leaves)})
    with np.load(ckpt) as z:
        loaded = [z[f"a{i}"] for i in range(len(leaves))]
    host2 = jax.tree.unflatten(treedef, loaded)

    def reshard(leaf, pspec):
        sharding = jax.sharding.NamedSharding(mesh, pspec)
        if pspec == jax.sharding.PartitionSpec("model"):
            sl = dist.host_local_slice(leaf.shape[0])
            return jax.make_array_from_process_local_data(
                sharding, leaf[sl], global_shape=leaf.shape)
        return jax.make_array_from_process_local_data(
            sharding, leaf, global_shape=np.shape(leaf))

    st2 = jax.tree.map(reshard, host2, fn.state_specs)
    st2 = fn.run(st2, theta_g, ccdata=ccdata_g)
    resumed = fn.finalize(st2, theta_g, ccdata=ccdata_g)

    assert int(gather(resumed.signal)) == sig
    assert int(gather(resumed.iter_count)) == int(gather(res.iter_count))
    np.testing.assert_array_equal(gather(resumed.x), gather(res.x))
    np.testing.assert_array_equal(gather(resumed.lc), gather(res.lc))
    os.remove(ckpt)

    print(f"[worker {proc_id}] SCHUR OK: {K} blocks over "
          f"{LOCAL_DEVICES * nproc} devices / {nproc} processes; "
          f"parity + checkpoint-resume bit-exact")


if __name__ == "__main__":
    main()
