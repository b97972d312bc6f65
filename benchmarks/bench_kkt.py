"""KKT factorize+solve throughput (BASELINE.md config 4).

Times the inertia-corrected factor+solve (``reg_solve_kkt``) on a
KKT-structured matrix of the n=4096, 256-equality-constraint dense NLP —
the hot path the reference delegates to LAPACK — and reports GFLOP/s
against the LDL^T flop count K^3/3.

    python benchmarks/bench_kkt.py [--n 4096] [--m 256] [--cpu]
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
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from pyipm_jax.config import IPMConfig

    D, M = args.n, args.m
    K = D + M
    cfg = IPMConfig(float_dtype="float32", ldlt_block=args.block)

    key = jax.random.key(0)
    kg, kj, kr = jax.random.split(key, 3)
    G = jax.random.normal(kg, (D, D), jnp.float32) / jnp.sqrt(D)
    W = G @ G.T + 0.5 * jnp.eye(D, dtype=jnp.float32)     # PD primal block
    Je = jax.random.normal(kj, (D, M), jnp.float32) / jnp.sqrt(D)
    H = jnp.zeros((K, K), jnp.float32)
    H = H.at[:D, :D].set(W).at[:D, D:].set(Je).at[D:, :D].set(Je.T)
    g = jax.random.normal(kr, (K,), jnp.float32)

    from pyipm_jax.ops.linalg import reg_solve_kkt

    @jax.jit
    def run(H, g):
        with jax.default_matmul_precision("highest"):
            return reg_solve_kkt(
                H, g, jnp.zeros(()), jnp.asarray(0.1),
                nvar=D, neq=M, nineq=0, eps=cfg.eps,
                reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
                delta0=cfg.delta0, max_retries=4, method="ldlt",
                block=args.block)

    dz, _, _ = jax.block_until_ready(run(H, g))

    # --- timing methodology --------------------------------------------
    # R reps inside ONE jit (each consuming a perturbed H so nothing
    # folds), a scalar fetch as the barrier, and differencing rep(R)
    # against rep(1) so the constant dispatch overhead cancels.
    def make_rep(R):
        @jax.jit
        def rep(H, g):
            def body(i, acc):
                Hi = H + (1e-6 * acc + 1e-30) * jnp.eye(K, dtype=H.dtype)
                dzi, _, _ = run(Hi, g)
                return acc + jnp.sum(dzi) * 1e-20
            return jax.lax.fori_loop(0, R, body,
                                     jnp.zeros((), H.dtype))
        return rep

    def timed(fn, *a, trials=3):
        float(fn(*a))
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            float(fn(*a))
            best = min(best, time.perf_counter() - t0)
        return best

    t_one = timed(make_rep(1), H, g)
    t_all = timed(make_rep(args.reps), H, g)
    dt = max((t_all - t_one) / (args.reps - 1), 1e-9)

    flops = K ** 3 / 3 * 2          # LDL^T multiply-adds
    resid = float(jnp.linalg.norm(H @ dz - g) / jnp.linalg.norm(g))
    print(json.dumps({
        "metric": "kkt_factor_solve_gflops",
        "value": round(flops / dt / 1e9, 1),
        "unit": "GFLOP/s",
        "vs_baseline": None,
        "K": K, "wall_s": round(dt, 4),
        "rel_residual": resid,
        "backend": jax.default_backend(),
    }))


if __name__ == "__main__":
    main()
