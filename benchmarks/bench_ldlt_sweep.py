"""Automated (block, segments) sweep of the blocked LDL^T factorization —
the tuning evidence for ops/linalg.ldlt_factor's defaults, versioned as a
JSON artifact instead of living in code comments (VERDICT r2 #7/#9).

    python benchmarks/bench_ldlt_sweep.py [--n 4352] [--out results/r03/...]
"""

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4352)
    ap.add_argument("--blocks", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--segments", type=int, nargs="+",
                    default=[2, 4, 8, 12])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax

    from pyipm_jax.utils import compile_cache
    compile_cache.enable(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pyipm_jax.ops.linalg import ldlt_factor

    n = args.n
    kg = jax.random.key(0)
    G = jax.random.normal(kg, (n, n), jnp.float32) / jnp.sqrt(n)
    A = G @ G.T + 0.5 * jnp.eye(n, dtype=jnp.float32)

    def timed(fn, *a, trials=3):
        # scalar fetch as the barrier (see bench.py)
        float(fn(*a))
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            float(fn(*a))
            best = min(best, time.perf_counter() - t0)
        return best

    rows = []
    flops = n ** 3 / 3 * 2
    for b, s in itertools.product(args.blocks, args.segments):
        # R reps in one jit with perturbed inputs; rep(R)-rep(1) diffing
        # cancels dispatch overhead (bench_kkt.py methodology)
        def make_rep(R, b=b, s=s):
            @jax.jit
            def rep(A):
                def body(i, acc):
                    Ai = A + (1e-6 * acc + 1e-30) * jnp.eye(n, dtype=A.dtype)
                    with jax.default_matmul_precision("highest"):
                        L, d = ldlt_factor(Ai, block=b, segments=s)
                    return acc + jnp.sum(d) * 1e-20
                return jax.lax.fori_loop(0, R, body,
                                         jnp.zeros((), A.dtype))
            return rep

        t1 = timed(make_rep(1), A)
        tR = timed(make_rep(args.reps), A)
        dt = max((tR - t1) / (args.reps - 1), 1e-9)
        rows.append({"block": b, "segments": s,
                     "wall_ms": round(dt * 1e3, 2),
                     "gflops": round(flops / dt / 1e9, 1)})
        print(json.dumps({"metric": "ldlt_sweep_point", "n": n,
                          **rows[-1]}))

    best = max(rows, key=lambda r: r["gflops"])
    out = {
        "metric": "ldlt_factor_sweep",
        "value": best["gflops"],
        "unit": "GFLOP/s",
        "vs_baseline": None,
        "n": n,
        "best": best,
        "rows": rows,
        "backend": jax.default_backend(),
    }
    print(json.dumps(out))
    if args.out:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            args.out)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
