"""Headline benchmark: IPM iterations/sec per chip on a 10k-instance
vmapped batch of random inequality-constrained QP-objective NLPs
(BASELINE.md, driver config 3), solved with wave-compacted batching
(parallel/batch.py) so converged instances retire early instead of paying
the vmap lockstep straggler tax.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.
Extra keys include the BASELINE.md config-4 hot-path certification:
``kkt_gflops`` / ``kkt_n`` — the n=4096+256-eq inertia-corrected KKT
factor+solve throughput (benchmarks/bench_kkt.py methodology, inlined here
so the driver records it every round).

The reference publishes no numbers (BASELINE.md) and its Aesara stack is
not installed here, so ``vs_baseline`` is the architectural ratio against a
reference-style host-driven loop: the same jitted single-instance solver
dispatched from a Python loop (one host round-trip per solve — strictly
FEWER host crossings than the reference's ~10 compiled-function calls per
iteration, so the ratio understates the true speedup).

Runs on a GPU only: without one it exits non-zero.  The JSON names the
device (``backend``, ``device_kind``, and the ``nvidia-smi`` name and
power limit under ``gpu``).

Env knobs: BENCH_BATCH, BENCH_NVAR, BENCH_BASELINE_N, BENCH_REPS,
BENCH_SKIP_KKT=1, BENCH_KKT_N, BENCH_KKT_M.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# Any timed section whose measured wall falls below this floor is treated
# as a timing failure: every timed section below (a) feeds each rep FRESH
# (perturbed) inputs so no result can be reused, (b) uses a SCALAR FETCH
# (device->host transfer of a value the computation produced) as the
# barrier, and (c) divides only when the wall clears this floor —
# otherwise the derived rate is reported as None instead of a nonsense
# stat.
WALL_FLOOR_S = 0.010


def guarded_rate(count, wall, floor=WALL_FLOOR_S):
    """count/wall, or None when the wall is below the trust floor."""
    if wall < floor:
        return None
    return round(count / wall, 1)


def bench_kkt_gflops(jax, jnp, n=4096, m=256, reps=12):
    """BASELINE.md config 4: inertia-corrected KKT factor+solve GFLOP/s
    at D=n variables, M=m equality constraints (K = n+m system)."""
    from pyipm_jax.config import IPMConfig
    from pyipm_jax.ops.linalg import reg_solve_kkt

    D, M = n, m
    K = D + M
    cfg = IPMConfig(float_dtype="float32")

    kg, kj, kr = jax.random.split(jax.random.key(0), 3)
    G = jax.random.normal(kg, (D, D), jnp.float32) / jnp.sqrt(D)
    W = G @ G.T + 0.5 * jnp.eye(D, dtype=jnp.float32)     # PD primal block
    Je = jax.random.normal(kj, (D, M), jnp.float32) / jnp.sqrt(D)
    H = jnp.zeros((K, K), jnp.float32)
    H = H.at[:D, :D].set(W).at[:D, D:].set(Je).at[D:, :D].set(Je.T)
    g = jax.random.normal(kr, (K,), jnp.float32)

    def run(H, g):
        with jax.default_matmul_precision("highest"):
            return reg_solve_kkt(
                H, g, jnp.zeros(()), jnp.asarray(0.1),
                nvar=D, neq=M, nineq=0, eps=cfg.eps,
                reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
                delta0=cfg.delta0, max_retries=4, method="ldlt",
                block=cfg.ldlt_block)

    # R reps inside ONE jit (each consuming a perturbed H so nothing
    # folds or hoists out of the loop), scalar fetch as the barrier,
    # rep(R)-rep(1) differencing so constant dispatch overhead cancels
    # (see benchmarks/bench_kkt.py).  The perturbation is a SCALAR
    # scaling (one elementwise pass, inertia-preserving): the r4 form
    # added eps*acc*eye(K) — an eye materialization plus add, ~3 K^2
    # memory passes of pure harness overhead inside the timed body.
    def make_rep(R):
        @jax.jit
        def rep(H, g):
            def body(i, acc):
                Hi = H * (1.0 + 1e-9 * acc + 1e-30)
                dzi, _, _ = run(Hi, g)
                return acc + jnp.sum(dzi) * 1e-20
            return jax.lax.fori_loop(0, R, body, jnp.zeros((), H.dtype))
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
    t_all = timed(make_rep(reps), H, g)
    if t_all < WALL_FLOOR_S or t_all <= t_one:
        return None, K           # timing not trustworthy; never divide
    dt = max((t_all - t_one) / (reps - 1), 1e-9)
    flops = K ** 3 / 3 * 2          # LDL^T multiply-adds
    return round(flops / dt / 1e9, 1), K


def gpu_identity():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py measures a GPU; JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 2
    from pyipm_jax.utils import compile_cache

    # persistent compilation cache: the bench compiles ~10 distinct wave
    # shapes; warm repeat runs cut minutes of compile wall (timing
    # excludes compiles either way)
    compile_cache.enable(os.path.dirname(os.path.abspath(__file__)))
    import jax.numpy as jnp

    from pyipm_jax.config import IPMConfig
    from pyipm_jax.core.solver import make_solver
    from pyipm_jax.models.random_nlp import (
        make_qp_batch_solver, make_qp_problem, sample_qp_batch, QPData,
    )
    from pyipm_jax.parallel.batch import make_wave_batch_solver

    # ----- BASELINE.md config 4: KKT factor+solve hot path ------------
    # measured FIRST, on a clean device, before the heavy fleet phases
    if os.environ.get("BENCH_SKIP_KKT"):
        kkt_gflops, kkt_k = None, None
    else:
        kkt_gflops, kkt_k = bench_kkt_gflops(
            jax, jnp,
            n=int(os.environ.get("BENCH_KKT_N", 4096)),
            m=int(os.environ.get("BENCH_KKT_M", 256)))

    B = int(os.environ.get("BENCH_BATCH", 10000))
    D = int(os.environ.get("BENCH_NVAR", 16))
    L = 4
    # The headline metric keeps the reference-parity 'adaptive' barrier so
    # iters/s stays comparable run over run; the Mehrotra
    # predictor-corrector (mu_strategy='mehrotra') takes fewer, costlier
    # iterations and is benched separately below as the end-to-end
    # solve-throughput keys (mehrotra_*).
    strategy = os.environ.get("BENCH_MU_STRATEGY", "adaptive")
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4,
                    mu_strategy=strategy)

    key = jax.random.key(42)
    data = sample_qp_batch(key, B, D, nlin=L)
    x0 = jnp.zeros((B, D), jnp.float32)

    # first-wave sizes (waves of 2*fw) and the growth below were swept on
    # another accelerator and are untuned on the H100
    fw_default = 8 if strategy == "mehrotra" else 10
    fw = int(os.environ.get("BENCH_FIRST_WAVE", fw_default))
    wv = int(os.environ.get("BENCH_WAVE", 2 * fw))
    # geometric wave growth for the straggler tail: fewer host
    # syncs/dispatches at the same hit rate
    wg = float(os.environ.get("BENCH_WAVE_GROWTH", 1.5))
    solver = make_wave_batch_solver(
        config=cfg, family=lambda d: make_qp_problem(d, D, L),
        first_wave=fw, wave=wv, wave_growth=wg, min_pad=256)

    # warm every wave-bucket compilation once (excluded from timing); also
    # the reported convergence stats.  The iter_count fetch is the
    # barrier (a device->host transfer cannot complete before the
    # computation has).
    res = solver(x0, data)
    int(np.sum(np.asarray(res.iter_count)))
    # second warm-up with a perturbed start: the first post-compile call
    # still pays lazy allocator/layout work
    rng0 = np.random.default_rng(3)
    r_w = solver(jnp.asarray(1e-6 * rng0.standard_normal((B, D)),
                             jnp.float32), data)
    int(np.sum(np.asarray(r_w.iter_count)))

    # --- timing methodology -------------------------------------------
    # The wave solver is host-orchestrated (one small signal fetch per
    # wave), so wall-clock around the call IS the honest number; each rep
    # gets a FRESH perturbed x0 (nothing can be reused) and ends with a
    # scalar-array fetch as the barrier; take the median of 5 reps so one
    # slow outlier rep does not become the median
    reps = int(os.environ.get("BENCH_REPS", 5))
    rng = np.random.default_rng(7)
    rep_x0s = jax.block_until_ready([
        jnp.asarray(1e-6 * rng.standard_normal((B, D)), jnp.float32)
        for _ in range(reps)])
    times, rep_iters = [], []
    for x0r in rep_x0s:
        t0 = time.perf_counter()
        r = solver(x0r, data)
        it = int(np.sum(np.asarray(r.iter_count)))     # fetch = barrier
        times.append(time.perf_counter() - t0)
        rep_iters.append(it)
    elapsed = float(np.median(times))
    assert elapsed > WALL_FLOOR_S, f"headline wall {elapsed} below floor"
    total_iters = int(np.median(rep_iters))
    iters_per_sec = float(np.median(
        [it / t for it, t in zip(rep_iters, times)]))
    sigs = np.asarray(res.signal)
    hit_rate = float(np.mean(np.isin(sigs, (1, 2))))

    # ----- hit-rate tail diagnosis -------------------------------------
    # record WHAT the failures are (signal histogram + their iteration
    # counts), then rescue budget-outs (-1) with a fresh Mehrotra re-solve
    # under an uncapped-in-practice budget — stragglers of the adaptive
    # schedule, not genuinely infeasible instances.
    fail_idx = np.flatnonzero(~np.isin(sigs, (1, 2)))
    iters_arr = np.asarray(res.iter_count)
    tail = {
        "fail_count": int(fail_idx.size),
        "fail_signals": {int(s): int(np.sum(sigs[fail_idx] == s))
                         for s in np.unique(sigs[fail_idx])},
        "fail_iters": [int(i) for i in iters_arr[fail_idx][:32]],
    }
    if fail_idx.size and not os.environ.get("BENCH_SKIP_RESCUE"):
        from pyipm_jax.parallel.batch import rescue_failures

        rcfg = cfg.replace(mu_strategy="mehrotra", niter=30, miter=20)
        rescue_family = lambda d_: make_qp_problem(d_, D, L)  # noqa: E731
        t0 = time.perf_counter()
        merged, n_failed, rescued = rescue_failures(
            res, x0, cfg, rescue_family, data, rescue_config=rcfg)
        int(np.sum(np.asarray(merged.iter_count)))   # fetch = barrier
        tail["rescue_wall_s"] = round(time.perf_counter() - t0, 3)
        tail["rescued"] = rescued
        tail["hit_rate_after_rescue"] = round(
            float(np.mean(np.isin(np.asarray(merged.signal), (1, 2)))), 5)
        # steady-state rescue cost: the cold call above pays the one-time
        # trace+compile of the rescue program; with the pow-2 shape
        # bucket + the solver cache in rescue_failures, repeat rescues
        # (the serving pattern) run warm
        t0 = time.perf_counter()
        m2, _, _ = rescue_failures(res, x0, cfg, rescue_family, data,
                                   rescue_config=rcfg)
        int(np.sum(np.asarray(m2.iter_count)))
        tail["rescue_wall_warm_s"] = round(time.perf_counter() - t0, 3)

    # ----- reference-style host-loop baseline on a subsample ----------
    # one jitted single-instance solver taking instance data as an
    # argument, dispatched from a Python loop: the reference architecture
    # (host loop around compiled kernels, pyipm.py:1658) with modern
    # compilation — a generous stand-in.
    nb = int(os.environ.get("BENCH_BASELINE_N", 32))
    sub = QPData(*(np.asarray(a)[:nb] for a in data))

    def solve_one(x0_i, data_i):
        prob = make_qp_problem(data_i, D, L)
        return make_solver(prob, cfg, jit=False)(x0_i)

    single = jax.jit(solve_one)
    x0_single = jnp.zeros((D,), jnp.float32)
    inst = lambda i: QPData(*(jnp.asarray(a[i]) for a in sub))
    single(x0_single, inst(0)).x.block_until_ready()  # compile

    insts = jax.block_until_ready([inst(i) for i in range(nb)])
    t0 = time.perf_counter()
    rs = [single(x0_single, di) for di in insts]   # async dispatch;
    # barrier = scalar fetches from a small SAMPLE spread across the
    # dispatch order plus the last result: on a strictly-FIFO stream the
    # last fetch alone suffices, but if the backend overlaps executions
    # on multiple streams a single fetch could return before earlier
    # solves finish and shrink the measured baseline wall (inflating
    # vs_baseline).  Fetching EVERY result would add nb host round-trips
    # to the baseline it is timing.
    for k in sorted({nb // 4 - 1, nb // 2 - 1, 3 * nb // 4 - 1, nb - 1}):
        if 0 <= k < nb:
            int(rs[k].iter_count)
    base_elapsed = time.perf_counter() - t0        # generous to baseline
    assert base_elapsed > WALL_FLOOR_S, base_elapsed
    base_iters = sum(int(ri.iter_count) for ri in rs)
    base_iters_per_sec = max(base_iters, 1) / base_elapsed

    # serving latency: one warm single-instance solve, synchronous
    # (scalar fetch per call = the online-serving pattern)
    lats = []
    for i in range(min(nb, 8)):
        t0 = time.perf_counter()
        r1 = single(x0_single, insts[i])
        float(r1.fval)
        lats.append(time.perf_counter() - t0)
    single_latency_ms = round(float(np.median(lats)) * 1e3, 3)

    # ----- lockstep comparison point -----------------------------------
    # plain lockstep vmap (one dispatch, no wave machinery); the wave
    # architecture's value is robustness to heavy-tailed fleets.  Both
    # numbers are reported; the timed call gets a fresh perturbed x0.
    lockstep = make_qp_batch_solver(cfg, nvar=D, nlin=L)
    wres = lockstep(x0, data)
    int(np.sum(np.asarray(wres.iter_count)))       # compile + barrier
    x0_lock = jax.block_until_ready(
        jnp.asarray(1e-6 * rng.standard_normal((B, D)), jnp.float32))
    t0 = time.perf_counter()
    lres = lockstep(x0_lock, data)
    lock_iters = int(np.sum(np.asarray(lres.iter_count)))  # barrier
    lock_elapsed = time.perf_counter() - t0
    lock_ips = guarded_rate(lock_iters, lock_elapsed)

    # ----- Mehrotra predictor-corrector: end-to-end solve throughput --
    if strategy != "mehrotra" and not os.environ.get("BENCH_SKIP_MEHROTRA"):
        mcfg = cfg.replace(mu_strategy="mehrotra")
        msolver = make_wave_batch_solver(
            config=mcfg, family=lambda d: make_qp_problem(d, D, L),
            first_wave=8, wave=16, min_pad=256)
        mres = msolver(x0, data)                   # compile + stats
        int(np.sum(np.asarray(mres.iter_count)))   # fetch = barrier
        x0_m = jax.block_until_ready(
            jnp.asarray(1e-6 * rng.standard_normal((B, D)), jnp.float32))
        t0 = time.perf_counter()
        r_m = msolver(x0_m, data)                  # fresh inputs
        int(np.sum(np.asarray(r_m.iter_count)))    # fetch = barrier
        m_wall = time.perf_counter() - t0
        assert m_wall > WALL_FLOOR_S, m_wall
        m_sigs = np.asarray(mres.signal)
        mehrotra = {
            "mehrotra_solves_per_sec": round(B / m_wall, 1),
            "mehrotra_wall_s": round(m_wall, 3),
            "mehrotra_hit_rate": round(
                float(np.mean(np.isin(m_sigs, (1, 2)))), 4),
            "mehrotra_mean_iters": round(
                float(np.mean(np.asarray(mres.iter_count))), 2),
        }
    else:
        mehrotra = {}

    out = {
        "metric": "ipm_iters_per_sec_per_chip",
        "value": round(iters_per_sec, 1),
        "unit": "iters/s",
        "vs_baseline": round(iters_per_sec / base_iters_per_sec, 2),
        "batch": B,
        "nvar": D,
        "nineq": 2 * D + L,
        "wall_s": round(elapsed, 3),
        "rep_walls_s": [round(t, 3) for t in times],
        "total_inner_iters": total_iters,
        "solves_per_sec": round(B / elapsed, 1),
        "mu_strategy": strategy,
        "ktol_hit_rate": round(hit_rate, 4),
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "gpu": gpu_identity(),
        "baseline": "host-loop single-instance solves (reference-style)",
        "baseline_iters_per_sec": round(base_iters_per_sec, 1),
        "single_solve_latency_ms": single_latency_ms,
        "lockstep_iters_per_sec": lock_ips,        # None if wall < floor
        "lockstep_wall_s": round(lock_elapsed, 3),
        **mehrotra,
        **tail,
        "kkt_gflops": kkt_gflops,
        "kkt_n": kkt_k,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
