"""Weak-scaling efficiency of the batched solver (BASELINE.md config 5).

Fixed per-device batch of random QP instances; the device count doubles
from 1 to the full mesh and the total batch grows with it.  Ideal weak
scaling keeps the per-step wall time constant: efficiency_k = T_1 / T_k.

Run on a multi-GPU host as-is; on the CPU (JAX_PLATFORMS=cpu) it
provisions the standard virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count), which validates the
sharding/collective structure — CPU timings are advisory, not device
numbers.

    python benchmarks/bench_scaling.py [--per-device 256] [--nvar 16]
                                       [--devices 8]

Prints one JSON line per device count plus a summary line with the
efficiency at the largest mesh.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=256)
    ap.add_argument("--nvar", type=int, default=16)
    ap.add_argument("--nlin", type=int, default=4)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax

    devs = jax.devices()
    if len(devs) < args.devices:
        raise SystemExit(
            f"need {args.devices} devices, have {len(devs)} "
            f"({devs[0].platform}); for virtual CPU devices run with "
            f"JAX_PLATFORMS=cpu")

    import jax.numpy as jnp
    import numpy as np

    from pyipm_jax.config import IPMConfig
    from pyipm_jax.models.random_nlp import (
        make_qp_batch_solver, sample_qp_batch,
    )

    D, L, b = args.nvar, args.nlin, args.per_device
    cfg = IPMConfig(float_dtype="float32", verbosity=0)

    counts = []
    k = 1
    while k <= args.devices:
        counts.append(k)
        k *= 2

    results = {}
    for k in counts:
        mesh = jax.sharding.Mesh(np.asarray(devs[:k]), ("batch",))
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("batch"))
        B = b * k
        data = sample_qp_batch(jax.random.key(42), B, D, nlin=L)
        data = jax.device_put(data, sharding)
        x0 = jax.device_put(jnp.zeros((B, D), jnp.float32), sharding)

        base = make_qp_batch_solver(cfg, nvar=D, nlin=L, jit=False)

        def make_rep(R):
            @jax.jit
            def rep(x0, data):
                def body(i, acc):
                    r = base(x0 + 1e-6 * acc, data)
                    return acc + jnp.sum(r.x) * jnp.float32(1e-12)
                return jax.lax.fori_loop(
                    0, R, body, jnp.zeros((), jnp.float32))
            return rep

        def timed(fn, trials=3):
            float(fn(x0, data))
            best = float("inf")
            for _ in range(trials):
                t0 = time.perf_counter()
                float(fn(x0, data))
                best = min(best, time.perf_counter() - t0)
            return best

        t1 = timed(make_rep(1))
        tR = timed(make_rep(args.reps))
        t = max((tR - t1) / (args.reps - 1), 1e-9)
        results[k] = t
        print(json.dumps({
            "metric": "weak_scaling_step_time",
            "devices": k, "batch": B, "value": round(t * 1e3, 3),
            "unit": "ms", "platform": devs[0].platform,
        }))

    kmax = counts[-1]
    eff = results[counts[0]] / results[kmax]
    print(json.dumps({
        "metric": "weak_scaling_efficiency",
        "value": round(eff, 4),
        "unit": "fraction",
        "vs_baseline": None,
        "devices": kmax,
        "per_device_batch": b,
        "platform": devs[0].platform,
        "advisory": devs[0].platform == "cpu",
    }))


if __name__ == "__main__":
    main()
