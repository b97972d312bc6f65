"""Collective census of the distributed Schur iteration.

Counts the XLA collectives (all_reduce / all_gather / collective_permute /
reduce_scatter / all_to_all) in the lowered AND optimized programs of the
block solver's ``run_budget`` step on a virtual 8-device mesh, per
configuration.  Static occurrences in the while-loop body execute once per
inner iteration, so the count is the per-iteration collective LATENCY
multiplier of the sharded solve.  A count, not a timing: it runs on the
CPU.

    JAX_PLATFORMS=cpu python benchmarks/collective_census.py

Prints the census as one JSON object.
"""

import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_jax.config import IPMConfig  # noqa: E402
from pyipm_jax.parallel.mesh import make_solver_mesh  # noqa: E402
from pyipm_jax.parallel.schur import (  # noqa: E402
    make_block_solver, sample_block_general,
)

PATTERNS = {
    "all_reduce": r"\ball-reduce\b|stablehlo\.all_reduce",
    "all_gather": r"\ball-gather\b|stablehlo\.all_gather",
    "collective_permute": (r"\bcollective-permute\b"
                           r"|stablehlo\.collective_permute"),
    "reduce_scatter": r"\breduce-scatter\b|stablehlo\.reduce_scatter",
    "all_to_all": r"\ball-to-all\b|stablehlo\.all_to_all",
}


def count_collectives(txt):
    return {k: len(re.findall(p, txt)) for k, p in PATTERNS.items()}


def census_one(name, spec, theta, ccdata, x0, cfg, mesh):
    fn = make_block_solver(spec, mesh, cfg)
    st = fn.init_state(x0, theta, ccdata=ccdata)

    def step(st_, th_, cc_, b_):
        return fn.run_budget(st_, th_, ccdata=cc_, max_new_iters=b_)

    lowered = jax.jit(step).lower(st, theta, ccdata,
                                  jnp.asarray(1, jnp.int32))
    low_counts = count_collectives(lowered.as_text())
    try:
        opt_counts = count_collectives(
            lowered.compile().as_text() or "")
    except Exception:
        opt_counts = None
    row = {
        "config": name,
        "lowered": low_counts,
        "lowered_total": int(sum(low_counts.values())),
        "optimized": opt_counts,
        "optimized_total": (int(sum(opt_counts.values()))
                            if opt_counts else None),
    }
    print(json.dumps(row))
    return row


def main():
    mesh = make_solver_mesh(batch=1, model=8)
    rows = []

    K = 8
    spec, theta, ccdata, x0 = sample_block_general(
        jax.random.key(2), K, 3, me=1, ni=2, p=2, mc=1, mci=1,
        dtype=jnp.float32)
    for strat in ("adaptive", "mehrotra"):
        cfg = IPMConfig(float_dtype="float32", verbosity=0,
                        mu_strategy=strat)
        rows.append(census_one(f"general_coupled_{strat}", spec, theta,
                               ccdata, x0, cfg, mesh))

    # a weak-scaling-like shape (d=16 blocks, linear coupling)
    gspec2, th2, cc2, x02 = sample_block_general(
        jax.random.key(4), K, 16, me=1, ni=2, p=2, mc=1, mci=0,
        dtype=jnp.float32, nonlinear_cc=False)
    cfg2 = IPMConfig(float_dtype="float32", verbosity=0)
    rows.append(census_one("weakscale_like_d16_linear_cc", gspec2, th2,
                           cc2, x02, cfg2, mesh))
    rows.append(census_one(
        "weakscale_d16_refine1_unguarded", gspec2, th2, cc2, x02,
        cfg2.replace(schur_refine_steps=1, schur_refine_guard=False),
        mesh))
    rows.append(census_one(
        "weakscale_d16_refine0", gspec2, th2, cc2, x02,
        cfg2.replace(schur_refine_steps=0), mesh))
    rows.append(census_one(
        "general_coupled_lbfgs", spec, theta, ccdata, x0,
        IPMConfig(float_dtype="float32", verbosity=0, lbfgs=6,
                  niter=20, miter=40), mesh))

    print(json.dumps({"rows": rows,
                      "note": ("static collective ops in the run_budget "
                               "program; ops inside the while body "
                               "execute once per inner iteration "
                               "(line-search chunk retries add their phi "
                               "collective per extra chunk)")}, indent=1))


if __name__ == "__main__":
    main()
