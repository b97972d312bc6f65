"""Weak scaling of the distributed Schur path + the 1M-variable proof
(BASELINE.md weak-scaling row; VERDICT r2 #3).

Two modes:

  --mode weak     Schur weak scaling: FIXED blocks per device, the
                  ``model`` mesh axis doubles 1 -> N; the Schur border
                  psums are the only cross-device traffic.  Without real
                  multi-chip hardware this self-provisions the virtual
                  CPU mesh — structure validated, timings advisory (the
                  JSON says so).  Efficiency is per-ITERATION step time
                  (iteration counts differ slightly across instance
                  sizes).

  --mode million  The BASELINE "1M-variable block-separable NLP" proof:
                  K x d >= 2^20 variables with bounds + linear coupling,
                  solved on whatever mesh is available (model=1 on the
                  single real chip; the same program shards unchanged on
                  a pod).  Reports wall, iterations, KKT norms.

    python benchmarks/bench_schur_scaling.py --mode weak --devices 8
    python benchmarks/bench_schur_scaling.py --mode million --blocks 4096
        --d 256
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cpu_mesh_devices(n):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()
    import jax

    devs = jax.devices()
    if len(devs) < n:
        raise SystemExit(
            f"need {n} devices, have {len(devs)} ({devs[0].platform}); for "
            f"virtual CPU devices run with JAX_PLATFORMS=cpu")
    return devs


def mode_weak(args):
    devs = _cpu_mesh_devices(args.devices)
    import jax
    import numpy as np

    from pyipm_jax.config import IPMConfig
    from pyipm_jax.parallel.schur import (
        make_separable_solver, sample_separable,
    )

    on_cpu = devs[0].platform == "cpu"
    # the d=16-per-block weak-scaling regime is collective-LATENCY bound
    # (collective census): run it at the lean setting — no guarded
    # refinement (fewer all-reduces per iteration).  Large-compute
    # configs keep the parity defaults.
    cfg = IPMConfig(float_dtype="float32", verbosity=0,
                    schur_refine_steps=0, schur_refine_guard=False)
    counts = []
    k = 1
    while k <= args.devices:
        counts.append(k)
        k *= 2

    rows = []
    for nk in counts:
        mesh = jax.sharding.Mesh(np.asarray(devs[:nk]), ("model",))
        K = args.blocks_per_device * nk
        spec, data, x0 = sample_separable(
            jax.random.key(42), K, args.d, args.mc)
        fn = make_separable_solver(spec, mesh, cfg)
        res = jax.block_until_ready(fn(x0, data))     # compile
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(x0, data))
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        iters = int(res.iter_count)
        rows.append({
            "devices": nk, "blocks": K, "wall_s": round(wall, 4),
            "iters": iters,
            "step_ms": round(wall / max(iters, 1) * 1e3, 3),
            "signal": int(res.signal),
        })
        print(json.dumps({"metric": "schur_weak_scaling_step",
                          **rows[-1],
                          "platform": devs[0].platform}))

    eff = rows[0]["step_ms"] / rows[-1]["step_ms"]
    out = {
        "metric": "schur_weak_scaling_efficiency",
        "value": round(eff, 4),
        "unit": "fraction",
        "vs_baseline": None,
        "devices": counts[-1],
        "blocks_per_device": args.blocks_per_device,
        "d": args.d, "mc": args.mc,
        "rows": rows,
        "platform": devs[0].platform,
        "advisory": on_cpu,
        "note": ("virtual CPU mesh: collective structure validated, "
                 "timings advisory" if on_cpu else "hardware mesh"),
    }
    print(json.dumps(out))
    return out


def mode_million(args):
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from pyipm_jax.utils import compile_cache
    compile_cache.enable(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np

    from pyipm_jax.config import IPMConfig
    from pyipm_jax.parallel.schur import (
        make_separable_solver, sample_separable,
    )

    K, d, mc = args.blocks, args.d, args.mc
    nvars = K * d
    devs = jax.devices()
    nmesh = 1
    for cand in (8, 4, 2, 1):
        if len(devs) >= cand and K % cand == 0:
            nmesh = cand
            break
    mesh = jax.sharding.Mesh(np.asarray(devs[:nmesh]), ("model",))
    cfg = IPMConfig(float_dtype="float32", verbosity=0,
                    niter=args.niter, miter=args.miter,
                    mu_strategy=args.mu_strategy)
    spec, data, x0 = sample_separable(jax.random.key(7), K, d, mc)
    fn = make_separable_solver(spec, mesh, cfg)

    # a scalar fetch is the barrier, and each timed rep gets a FRESH
    # perturbed x0 so no result can be reused (bench.py WALL_FLOOR_S)
    import jax.numpy as jnp

    t0 = time.perf_counter()
    res = fn(x0, data)
    _ = float(res.fval)
    compile_wall = time.perf_counter() - t0
    walls = []
    for _i in range(3):
        x0i = x0 + jnp.asarray(1e-6 * (_i + 1), x0.dtype)
        t0 = time.perf_counter()
        res = fn(x0i, data)
        _ = float(res.fval)
        walls.append(time.perf_counter() - t0)
    import numpy as _np
    wall = float(_np.median(walls))
    assert wall > 0.01, f"wall {wall} below trust floor"

    iters = int(res.iter_count)
    kkt = np.asarray(res.kkt)
    # per-iteration block-factorization MACs alone (the dominated cost)
    factor_flops = K * (d ** 3) / 3 * 2 * iters
    out = {
        "metric": "schur_million_var_solve",
        "value": round(wall, 3),
        "unit": "s",
        "vs_baseline": None,
        "nvars": nvars, "blocks": K, "d": d, "mc": mc,
        "mesh_model": nmesh,
        "iters": iters, "signal": int(res.signal),
        "mu_strategy": cfg.mu_strategy,
        "kkt": [float(v) for v in kkt],
        "converged": bool(np.all(kkt <= cfg.Ktol * 10)),
        "compile_wall_s": round(compile_wall - wall, 3),
        "iters_per_s": round(iters / wall, 3),
        "factor_gflops_lower_bound": round(factor_flops / wall / 1e9, 1),
        "backend": jax.default_backend(),
    }
    print(json.dumps(out))
    return out


def mode_dsweep(args):
    """Large-d-per-block boundary sweep (VERDICT r3 #8): where does dense
    per-block factorization stop scaling?  Runs the box+coupling family
    at growing d with K chosen to keep total work bounded, records
    per-iteration wall and effective factor throughput, and the point
    where the (d+me)^3 per-iteration cost makes dense blocks impractical
    (documented in BlockNLP's docstring)."""
    rows = []
    for K, d in [(8, 512), (8, 1024), (4, 2048), (2, 4096)]:
        args.blocks, args.d = K, d
        args.mc = min(args.mc, 4)
        row = mode_million(args)
        row["per_iter_s"] = round(row["value"] / max(row["iters"], 1), 4)
        rows.append(row)
    out = {"metric": "schur_dsweep", "rows": rows,
           "note": ("per-block dense factorization is d^3/3 MACs; the "
                    "sweep shows where per-iteration wall crosses "
                    "interactive budgets — beyond it, partition the "
                    "block further or use the L-BFGS mode "
                    "(reference README.md:196-207)")}
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    print(json.dumps({"metric": "schur_dsweep",
                      "per_iter_s": [r["per_iter_s"] for r in rows]}))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["weak", "million", "dsweep"],
                    default="weak")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--blocks-per-device", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=4096)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--mc", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--miter", type=int, default=30)
    ap.add_argument("--mu-strategy", default="adaptive",
                    choices=["adaptive", "mehrotra", "auto"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    if args.mode == "dsweep":
        args.out = (os.path.join(
            os.path.dirname(os.path.abspath(__file__)), args.out)
            if args.out else None)
        mode_dsweep(args)
        return
    out = mode_weak(args) if args.mode == "weak" else mode_million(args)
    if args.out:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            args.out)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
