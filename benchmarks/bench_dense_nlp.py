"""Full solve of the n=4096 dense nonconvex NLP (BASELINE.md config 4).

    python benchmarks/bench_dense_nlp.py [--n 4096] [--m 256] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyipm_jax.config import IPMConfig
    from pyipm_jax.models.random_nlp import (
        make_dense_nlp_solver, sample_dense_nlp,
    )

    D, M = args.n, args.m
    cfg = IPMConfig(float_dtype="float32", verbosity=0)
    data = sample_dense_nlp(jax.random.key(0), D, M, hidden=args.hidden)
    fn = make_dense_nlp_solver(cfg, D, M)
    x0 = jnp.zeros((D,), jnp.float32)

    res = jax.block_until_ready(fn(x0, data))
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(x0 + 1e-3, data))
    dt = time.perf_counter() - t0

    iters = int(res.iter_count)
    K = D + M
    factor_flops = iters * K ** 3 / 3 * 2
    print(json.dumps({
        "metric": "dense_nlp_solve",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": None,
        "n": D, "neq": M, "iters": iters,
        "signal": int(res.signal),
        "kkt_max": float(np.asarray(res.kkt).max()),
        "iters_per_s": round(iters / dt, 2),
        "factor_gflops_lower_bound": round(factor_flops / dt / 1e9, 1),
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
