"""Checkpoint/resume for solver state.

The reference has no checkpointing; its de-facto resume mechanism is the
warm-start arguments of solve() plus mutable members left on the instance
(reference pyipm.py:273-275, 1567-1578, 1816-1821).  Here the
:class:`~pyipm_jax.core.solver.SolverState` pytree IS the checkpoint unit:
save it mid-run (or the result of a bounded-iteration run) and resume by
feeding x/s/lda back as warm starts, or by continuing the while_loop from
the restored carry via ``make_solver(...).run``.

Serialization uses orbax when available, with a NumPy .npz fallback so the
subsystem has no hard dependency.  Failure policy (this backs the
multi-host fail-fast+resume story of parallel/launch.py, so nothing is
swallowed silently):

  - orbax import failure or save/restore error -> ``warnings.warn`` with
    the underlying exception, then the npz fallback;
  - npz restore validates leaf count, shapes, and castability against the
    ``like`` structure and raises ``CheckpointError`` with a precise
    message on mismatch (a truncated or wrong-run file must never
    unflatten into a plausible-looking state).
"""

from __future__ import annotations

import os
import warnings
from typing import Any

import jax
import numpy as np


class CheckpointError(RuntimeError):
    """A checkpoint file does not match the expected state structure."""


def _flatten(tree: Any):
    leaves, treedef = jax.tree.flatten(tree)
    return leaves, treedef


def _try_orbax():
    try:
        import orbax.checkpoint as ocp
        return ocp
    except Exception as e:                          # pragma: no cover
        warnings.warn(f"orbax unavailable ({e!r}); using the .npz "
                      "checkpoint fallback", RuntimeWarning)
        return None


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: Any) -> None:
    """Save any solver pytree (SolverState, SolverResult, batched or not).

    Multi-host/sharded states: each leaf is materialized to host via
    ``np.asarray`` for the npz path (orbax handles sharded arrays
    natively); call from one process per state, or per-shard with
    distinct paths.
    """
    leaves0, _ = _flatten(state)
    if any(np.size(l) == 0 for l in leaves0):
        # orbax rejects zero-size arrays ("Cannot save arrays with zero
        # size"), and exact-Hessian SolverStates always carry empty
        # L-BFGS buffers (lbfgs_mem == 0) — route those straight to npz
        # instead of warning on an expected condition every save.
        np.savez(_npz_path(path), *[np.asarray(l) for l in leaves0])
        return
    ocp = _try_orbax()
    if ocp is not None:
        try:
            ckptr = ocp.StandardCheckpointer()
            ckptr.save(os.path.abspath(path), state, force=True)
            ckptr.wait_until_finished()
            return
        except Exception as e:
            warnings.warn(f"orbax save failed ({e!r}); falling back to "
                          f"{_npz_path(path)}", RuntimeWarning)
    np.savez(_npz_path(path), *[np.asarray(l) for l in leaves0])


def restore_state(path: str, like: Any) -> Any:
    """Restore a pytree saved by :func:`save_state`; ``like`` supplies the
    structure (e.g. a freshly-built init state).

    Raises :class:`CheckpointError` when the file's leaf count or leaf
    shapes do not match ``like`` — e.g. a checkpoint from a different
    problem shape, batch size, or trace_metrics setting.
    """
    ocp = _try_orbax()
    if ocp is not None and os.path.isdir(os.path.abspath(path)):
        # orbax checkpoints are directories; a .npz is a file.  Routing on
        # that keeps "orbax missing at restore but present at save" (and
        # vice versa) unambiguous instead of masked by a generic except.
        try:
            ckptr = ocp.StandardCheckpointer()
            return ckptr.restore(os.path.abspath(path), like)
        except Exception as e:
            raise CheckpointError(
                f"orbax restore of {path!r} failed: {e!r}") from e
    npz = _npz_path(path)
    if not os.path.exists(npz):
        raise CheckpointError(
            f"no checkpoint at {path!r}: neither an orbax directory nor "
            f"{npz!r} exists")
    data = np.load(npz)
    leaves, treedef = _flatten(like)
    if len(data.files) != len(leaves):
        raise CheckpointError(
            f"checkpoint {npz!r} holds {len(data.files)} leaves but the "
            f"expected state structure has {len(leaves)} — saved from a "
            "different state type or library version?")
    import jax.numpy as jnp
    new_leaves = []
    for i, l in enumerate(leaves):
        arr = np.asarray(data[f"arr_{i}"])
        want = tuple(np.shape(l))
        if tuple(arr.shape) != want:
            raise CheckpointError(
                f"checkpoint {npz!r} leaf {i}: shape {tuple(arr.shape)} "
                f"!= expected {want} (different problem/batch shape or "
                "solver configuration?)")
        new_leaves.append(jnp.asarray(arr, jnp.asarray(l).dtype))
    return jax.tree.unflatten(treedef, new_leaves)
