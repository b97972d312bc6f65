"""Each Triton kernel against what XLA makes of the plain version, on the GPU.

    python benchmarks/bench_kernels.py [--only panel,fleet] [--out rows.jsonl]

Every comparison runs in one process, on one card, in the order plain,
kernel, kernel, plain, and reports the median wall of each variant (the
panel factor's variants: fori loop, Triton kernel and, per panel only,
the statically unrolled form):

  * panel: one 128 x 128 float32 panel factorization, 64 in sequence inside
    one jitted loop, per panel;
  * kkt: ``reg_solve_kkt`` (factor + solve) at K=4352, the dense path's
    hot call;
  * dense: the full dense-NLP solve (D=4096, M=256) through
    ``make_dense_nlp_solver``;
  * fleet: the 10,000-instance QP fleet, lockstep and wave-compacted, with
    the instance-last small-system kernels on and off;
  * sweep: device time of the backward panel sweep at K=4352 against the
    whole ``reg_solve_kkt`` call, both from a profiler trace;
  * precision: the fleet's hit rate at float32 matmul precision
    'default' (TF32) against 'highest'.

The variants are selected by swapping the dispatch functions of
ops/triton_ldlt.py before each trace, so every variant compiles its own
program.  Prints one JSON object per comparison (and appends them to
``--out`` when given).  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _gpu_identity():
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


@contextlib.contextmanager
def panel_variant(name):
    """Swap the diagonal-panel factorization used by ldlt_factor."""
    from pyipm_jax.ops import linalg, triton_ldlt

    def unrolled(A):
        L, d = linalg.ldlt_factor_unrolled(A[None], panel=A.shape[0])
        return L[0], d[0]

    impl = {"fori": linalg.ldlt_unblocked,
            "triton": triton_ldlt.panel_factor,
            "unrolled": unrolled}[name]
    saved = triton_ldlt.panel_factor
    triton_ldlt.panel_factor = impl
    try:
        yield
    finally:
        triton_ldlt.panel_factor = saved


@contextlib.contextmanager
def lane_variant(on):
    """Turn the instance-last small-system kernels on or off."""
    from pyipm_jax.ops import triton_ldlt

    saved = triton_ldlt._lane_ok
    if not on:
        triton_ldlt._lane_ok = lambda n, dtype: False
    try:
        yield
    finally:
        triton_ldlt._lane_ok = saved


def _wall(fn, *args, reps=5):
    import jax
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _alternate(variants, measure):
    """measure(v) for v in variants, then again in reverse order; returns
    {variant: [first, second]}."""
    out = {v: [] for v in variants}
    for v in list(variants) + list(reversed(variants)):
        out[v].append(measure(v))
    return out


def device_busy_ns(logdir):
    """Union of kernel intervals on the GPU planes of a profiler trace."""
    import jax

    paths = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    spans = []
    lines_seen = set()
    for p in paths:
        pd = jax.profiler.ProfileData.from_file(p)
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                lines_seen.add(line.name)
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, sorted(lines_seen)


def traced_device_ns(fn, *args, reps=10):
    import jax
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        busy, lines = device_busy_ns(d)
    return busy / reps, lines


def kkt_system():
    from chip_smoke import kkt_matrix
    import jax
    import jax.numpy as jnp

    H = kkt_matrix()
    g = jax.random.normal(jax.random.key(3), (H.shape[0],), jnp.float32)
    return H, g


def reg_solve(H, g):
    import jax
    import jax.numpy as jnp
    from pyipm_jax.config import IPMConfig
    from pyipm_jax.ops.linalg import reg_solve_kkt

    cfg = IPMConfig(float_dtype="float32")
    with jax.default_matmul_precision("highest"):
        return reg_solve_kkt(
            H, g, jnp.zeros((), H.dtype), jnp.asarray(0.1, H.dtype),
            nvar=4096, neq=H.shape[0] - 4096, nineq=0, eps=cfg.eps,
            reg_coef=cfg.reg_coef, eta=cfg.eta, beta=cfg.beta,
            delta0=cfg.delta0, max_retries=4, block=cfg.ldlt_block)[0]


def bench_panel():
    import jax
    import jax.numpy as jnp
    from pyipm_jax.ops import triton_ldlt

    rng = np.random.default_rng(0)
    A = rng.standard_normal((128, 128))
    A = jnp.asarray((A + A.T) / 2 + 16 * np.eye(128), jnp.float32)
    n_seq = 64

    def measure(v):
        with panel_variant(v):
            pf = triton_ldlt.panel_factor

            @jax.jit
            def seq(A):
                def body(i, acc):
                    L, d = pf(A * (1 + 1e-7 * acc))
                    return acc + d[0] * 1e-30 + L[1, 0] * 1e-30
                return jax.lax.fori_loop(0, n_seq, body,
                                         jnp.zeros((), A.dtype))
            return _wall(seq, A) / n_seq

    res = _alternate(["fori", "triton", "unrolled"], measure)
    return {"what": "panel 128x128 f32, s per panel", **res}


def bench_kkt():
    import jax
    H, g = kkt_system()

    def measure(v):
        with panel_variant(v):
            # a fresh function per variant: jit's trace cache is keyed on
            # the function, not on the swapped dispatch
            return _wall(jax.jit(lambda H, g: reg_solve(H, g)), H, g)

    # the statically unrolled panel is compared per panel only: with it
    # unrolled into all 34 panels of K=4352 this comparison ran past ten
    # minutes on an H100
    res = _alternate(["fori", "triton"], measure)
    return {"what": "reg_solve_kkt K=4352 f32, s per call", **res}


def bench_dense():
    import jax
    import jax.numpy as jnp
    from pyipm_jax.config import IPMConfig
    from pyipm_jax.models.random_nlp import (
        make_dense_nlp_solver, sample_dense_nlp,
    )

    cfg = IPMConfig(float_dtype="float32", verbosity=0)
    data = sample_dense_nlp(jax.random.key(0), 4096, 256, hidden=256)
    x0 = jnp.zeros((4096,), jnp.float32)
    iters = {}

    def measure(v):
        with panel_variant(v):
            fn = make_dense_nlp_solver(cfg, 4096, 256)
            t0 = time.perf_counter()
            c = fn.lower(x0, data).compile()
            comp = time.perf_counter() - t0
            iters[v] = int(c(x0, data).iter_count)
            return {"wall_s": _wall(c, x0, data, reps=3),
                    "compile_s": comp}

    res = _alternate(["fori", "triton"], measure)
    return {"what": "dense NLP D=4096 M=256 f32 solve", "iters": iters,
            **res}


def bench_fleet():
    import jax
    import jax.numpy as jnp
    from pyipm_jax.config import IPMConfig
    from pyipm_jax.models.random_nlp import (
        make_qp_batch_solver, make_qp_problem, sample_qp_batch,
    )
    from pyipm_jax.parallel.batch import make_wave_batch_solver

    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)
    data = sample_qp_batch(jax.random.key(42), 10_000, 16, nlin=4)
    x0 = jnp.zeros((10_000, 16), jnp.float32) + 1e-6
    stats = {}

    def measure(v):
        with lane_variant(v == "lane"):
            lock = make_qp_batch_solver(cfg, nvar=16, nlin=4)
            wave = make_wave_batch_solver(
                config=cfg, family=lambda d: make_qp_problem(d, 16, 4),
                first_wave=10, wave=20, wave_growth=1.5, min_pad=256)
            r = lock(x0, data)
            stats[v] = {"hit": float(np.mean(np.isin(
                np.asarray(r.signal), (1, 2)))),
                "iters": int(np.sum(np.asarray(r.iter_count)))}
            return {"lockstep_s": _wall(lock, x0, data),
                    "wave_s": _wall(wave, x0, data)}

    res = _alternate(["plain", "lane"], measure)
    return {"what": "QP fleet B=10000 D=16 f32 wall", "stats": stats,
            **res}


def bench_precision():
    """The fleet's hit rate and iterations at float32 matmul precision
    'default' (TF32 on this card) against 'highest'."""
    import jax
    import jax.numpy as jnp
    from pyipm_jax.config import IPMConfig
    from pyipm_jax.models.random_nlp import (
        make_qp_batch_solver, sample_qp_batch,
    )

    data = sample_qp_batch(jax.random.key(42), 10_000, 16, nlin=4)
    x0 = jnp.zeros((10_000, 16), jnp.float32)
    out = {}
    for prec in ("highest", "default"):
        cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4,
                        matmul_precision=prec)
        r = make_qp_batch_solver(cfg, nvar=16, nlin=4)(x0, data)
        it = np.asarray(r.iter_count)
        out[prec] = {"hit": float(np.mean(np.isin(np.asarray(r.signal),
                                                  (1, 2)))),
                     "iters_mean": float(it.mean()), "iters_max": int(
                         it.max())}
    return {"what": "QP fleet B=10000 D=16 f32 by matmul precision", **out}


def bench_sweep():
    import jax
    import jax.numpy as jnp
    from pyipm_jax.ops import linalg

    H, g = kkt_system()
    with jax.default_matmul_precision("highest"):
        Hs, dsc = jax.jit(linalg.ruiz_scale)(H)
        Lp, dp, invp, yf = jax.jit(
            lambda A, b: linalg.ldlt_factor_panels(A, rhs=b))(Hs, dsc * g)
        Lb, db, invb, yb = jax.jit(lambda A, b: linalg.ldlt_factor_blocks(
            A, rhs=b, group=8, pad_to_grid=True))(Hs, dsc * g)
    sweep = jax.jit(linalg.ldlt_solve_panels_bwd)
    t_sweep, lines = traced_device_ns(sweep, Lp, dp, invp, yf)
    sweep_b = jax.jit(linalg.ldlt_solve_blocks_bwd)
    t_sweep_b, _ = traced_device_ns(sweep_b, Lb, db, invb, yb)
    t_all, _ = traced_device_ns(jax.jit(reg_solve), H, g)
    return {"what": "backward sweeps K=4352 f32, device ns per call: "
                    "panel sweep (single-shot reg_solve_kkt) and "
                    "superblock sweep (condensed path, want_solver)",
            "panel_sweep_ns": t_sweep, "superblock_sweep_ns": t_sweep_b,
            "reg_solve_kkt_ns": t_all,
            "panel_share": t_sweep / t_all if t_all else None,
            "gpu_trace_lines": lines,
            "panel_sweep_wall_s": _wall(sweep, Lp, dp, invp, yf),
            "superblock_sweep_wall_s": _wall(sweep_b, Lb, db, invb, yb)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also append the JSON rows to this file")
    ap.add_argument("--only", default="panel,fleet,precision,sweep,dense,kkt",
                    help="comma-separated subset of the comparisons")
    args = ap.parse_args(argv)

    import jax
    if jax.devices()[0].platform != "gpu":
        print("no GPU found", file=sys.stderr)
        return 2
    from pyipm_jax.utils import compile_cache
    compile_cache.enable(ROOT)
    card = _gpu_identity()
    benches = {"panel": bench_panel, "kkt": bench_kkt, "sweep": bench_sweep,
               "precision": bench_precision, "fleet": bench_fleet,
               "dense": bench_dense}
    for name in args.only.split(","):
        t0 = time.perf_counter()
        row = {"bench": name, "card": card,
               "device_kind": jax.devices()[0].device_kind,
               **benches[name](),
               "bench_wall_s": time.perf_counter() - t0}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
