"""Large-D L-BFGS benchmark — the regime the mode exists for (reference
README.md:196-207: the (D+M+N)^2 Hessian is prohibitive, L-BFGS is the
large-D answer).  Batched solves of the dense nonconvex NLP family with
the Hessian DISABLED (compact-Woodbury directions only).

    python benchmarks/bench_lbfgs.py [--d 4096] [--batch 8] [--m 8]
        [--mem 8] [--cpu] [--out lbfgs_bench.json]

Reports end-to-end wall, iterations/s, and the peak device-memory
estimate from XLA's compiled executable (no (D+M+N)^2 allocations).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--m", type=int, default=8, help="eq constraints")
    ap.add_argument("--mem", type=int, default=8, help="L-BFGS memory")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    from pyipm_jax.utils import compile_cache
    compile_cache.enable(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    import jax.numpy as jnp
    import numpy as np

    from pyipm_jax.config import IPMConfig
    from pyipm_jax.core.solver import make_solver
    from pyipm_jax.models.random_nlp import (
        make_dense_nlp_problem, sample_dense_nlp,
    )

    D, M, B = args.d, args.m, args.batch
    cfg = IPMConfig(float_dtype="float32", verbosity=0, lbfgs=args.mem,
                    niter=10, miter=60)
    keys = jax.random.split(jax.random.key(0), B)
    datas = jax.vmap(lambda k: sample_dense_nlp(k, D, M))(keys)

    def solve_one(x0, data):
        prob = make_dense_nlp_problem(data, D, M)
        return make_solver(prob, cfg, jit=False)(x0)

    fn = jax.jit(jax.vmap(solve_one))
    x0 = jnp.zeros((B, D), jnp.float32)

    res = jax.block_until_ready(fn(x0, datas))          # compile
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(x0 + 1e-4, datas))
    dt = time.perf_counter() - t0

    peak_mb = None
    try:
        mem = fn.lower(x0, datas).compile().memory_analysis()
        if mem is not None:
            peak_mb = round(
                (mem.temp_size_in_bytes + mem.argument_size_in_bytes
                 + mem.output_size_in_bytes) / 1e6, 1)
    except Exception:
        pass

    iters = int(np.sum(np.asarray(res.iter_count)))
    sigs = np.asarray(res.signal)
    out = {
        "metric": "lbfgs_large_d",
        "value": round(iters / dt, 1),
        "unit": "iters/s",
        "vs_baseline": None,
        "d": D, "neq": M, "batch": B, "lbfgs_mem": args.mem,
        "wall_s": round(dt, 3),
        "total_iters": iters,
        "converged": int(np.sum(np.isin(sigs, (1, 2)))),
        "kkt_max": float(np.asarray(res.kkt).max()),
        "peak_device_mb": peak_mb,
        # (D+M)^2 f32 would need this much per instance — the number the
        # compact representation avoids
        "dense_kkt_mb_equiv": round(((D + M) ** 2 * 4) / 1e6, 1),
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
