"""Checkpoint/resume of the SolverState pytree (SURVEY.md §5)."""

import jax
import jax.numpy as jnp
import numpy as np

from pyipm_jax import IPMConfig
from pyipm_jax.core.solver import make_solver
from pyipm_jax.models import REFERENCE_PROBLEMS
from pyipm_jax.utils import checkpoint as ckpt_mod
from pyipm_jax.utils.checkpoint import (
    CheckpointError, restore_state, save_state,
)
import pytest


@pytest.mark.slow
def test_save_restore_roundtrip(tmp_path):
    spec = REFERENCE_PROBLEMS[7]
    prob = spec.make()
    cfg = IPMConfig(verbosity=0)
    fn = make_solver(prob, cfg)
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)
    st = fn.init_state(x0)
    path = str(tmp_path / "ckpt")
    save_state(path, st)
    st2 = restore_state(path, fn.init_state(np.zeros_like(x0)))
    np.testing.assert_array_equal(np.asarray(st.x), np.asarray(st2.x))
    np.testing.assert_array_equal(np.asarray(st.s), np.asarray(st2.s))
    np.testing.assert_array_equal(np.asarray(st.lda), np.asarray(st2.lda))


def _batched_states(B=6):
    """A batched (vmapped-init) SolverState for problem 5."""
    spec = REFERENCE_PROBLEMS[5]
    prob = spec.make()
    fn = make_solver(prob, IPMConfig(verbosity=0), jit=False)
    rng = np.random.default_rng(0)
    x0b = jnp.asarray(np.stack([spec.sample_x0(rng) for _ in range(B)]))
    return jax.vmap(fn.init_state)(x0b), fn, x0b


@pytest.mark.parametrize("backend", ["orbax", "npz"])
def test_batched_state_roundtrip_both_backends(tmp_path, backend,
                                               monkeypatch):
    """VERDICT r4 #8: a BATCHED SolverState round-trips through both the
    orbax and the npz backend bit-exactly."""
    if backend == "npz":
        monkeypatch.setattr(ckpt_mod, "_try_orbax", lambda: None)
    st, fn, x0b = _batched_states()
    path = str(tmp_path / f"batched_{backend}")
    save_state(path, st)
    like = jax.vmap(fn.init_state)(jnp.zeros_like(x0b))
    st2 = restore_state(path, like)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sharded_state_roundtrip(tmp_path, monkeypatch):
    """A mesh-sharded batched state saves and restores (npz backend —
    leaves are materialized to host and restored unsharded; callers
    re-shard with device_put)."""
    monkeypatch.setattr(ckpt_mod, "_try_orbax", lambda: None)
    st, fn, x0b = _batched_states(B=8)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("batch",))
    sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("batch"))
    st_sharded = jax.tree.map(
        lambda a: jax.device_put(a, sh) if a.ndim >= 1 and a.shape[0] == 8
        else a, st)
    path = str(tmp_path / "sharded")
    save_state(path, st_sharded)
    st2 = restore_state(path, st)
    for a, b in zip(jax.tree.leaves(st_sharded), jax.tree.leaves(st2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the restored pytree re-shards cleanly
    resharded = jax.tree.map(
        lambda a: jax.device_put(a, sh) if a.ndim >= 1 and a.shape[0] == 8
        else a, st2)
    assert jax.tree.leaves(resharded)[0].sharding.is_equivalent_to(
        sh, jax.tree.leaves(resharded)[0].ndim)


def test_restore_structure_mismatch_raises(tmp_path, monkeypatch):
    """A checkpoint from a different shape/structure must raise a clear
    CheckpointError, not unflatten into a plausible wrong state."""
    monkeypatch.setattr(ckpt_mod, "_try_orbax", lambda: None)
    spec5, spec7 = REFERENCE_PROBLEMS[5], REFERENCE_PROBLEMS[7]
    rng = np.random.default_rng(1)
    fn5 = make_solver(spec5.make(), IPMConfig(verbosity=0), jit=False)
    fn7 = make_solver(spec7.make(), IPMConfig(verbosity=0), jit=False)
    st5 = fn5.init_state(spec5.sample_x0(rng))
    path = str(tmp_path / "p5")
    save_state(path, st5)
    like7 = fn7.init_state(spec7.sample_x0(rng))
    with pytest.raises(CheckpointError, match="shape"):
        restore_state(path, like7)
    # leaf-count mismatch: same problem but trace_metrics adds buffers
    fnm = make_solver(spec5.make(),
                      IPMConfig(verbosity=0, trace_metrics=True),
                      jit=False)
    likem = fnm.init_state(spec5.sample_x0(rng))
    with pytest.raises(CheckpointError, match="shape|leaves"):
        restore_state(path, likem)
    with pytest.raises(CheckpointError, match="no checkpoint"):
        restore_state(str(tmp_path / "missing"), st5)


@pytest.mark.slow
def test_resume_from_checkpointed_state(tmp_path):
    """Truncated run -> checkpoint -> resume completes to the same answer
    as an uninterrupted run (the reference's only resume path is manual
    warm-starting, pyipm.py:1567-1578)."""
    spec = REFERENCE_PROBLEMS[5]
    prob = spec.make()
    rng = np.random.default_rng(42)
    x0 = spec.sample_x0(rng)

    full = make_solver(prob, IPMConfig(verbosity=0, Ftol=1e-8))(x0)

    short_cfg = IPMConfig(verbosity=0, niter=1, miter=3)
    short = make_solver(prob, short_cfg)
    partial = short(x0)
    path = str(tmp_path / "mid")
    save_state(path, partial)
    restored = restore_state(path, partial)

    resumed = make_solver(
        prob, IPMConfig(verbosity=0, Ftol=1e-8),
        with_s0=True, with_lda0=True)(
            np.asarray(restored.x), np.asarray(restored.s),
            np.asarray(restored.lda))
    assert int(resumed.signal) in (1, 2)
    assert spec.distance_to_truth(resumed.x) <= 1e-3
    assert spec.distance_to_truth(full.x) <= 1e-3
