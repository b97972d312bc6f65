"""Smoke test of the solver on one NVIDIA GPU, through its public entry points.

    python chip_smoke.py                # phases 0-5 on one card
    python chip_smoke.py --four-cards   # the two paths across four cards

Phases (one card):
  0. environment: card name and power limit, JAX version, device kind,
     XLA_FLAGS, compile-cache directory; exits non-zero without a GPU;
  1. the Triton kernels, compiled for the card, against the plain reference
     at real widths: every diagonal panel the K=4352 KKT factorization
     factors, and the batched small-system factor/solve at B=10,000, n=16;
  2. the 10,000-instance random-QP fleet (D=16, L=4, float32), lockstep
     and wave-compacted, against SLSQP in float64 on 64 instances;
  3. the dense nonconvex NLP (D=4096, M=256, float32), checked in float64
     on the host from the problem's own formulas;
  4. the block-separable Schur solve, 4,096 blocks of d=256 with 8 linear
     coupling constraints (1,048,576 variables) on a one-card mesh;
  5. reference problems 1-10 through the ``IPM`` facade in float64.

With ``--four-cards`` only two comparisons run: the phase-4 problem on a
``model=4`` mesh against one card, and the phase-2 fleet sharded over
``batch=4`` against one card.

Each phase prints what it found.  Any failed phase makes the exit code
non-zero and suppresses the final line, which is otherwise exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

KTOL = 1e-4
FLEET_B, FLEET_D, FLEET_L = 10_000, 16, 4
DENSE_D, DENSE_M, DENSE_H = 4096, 256, 256
SCHUR_K, SCHUR_D, SCHUR_MC = 4096, 256, 8
PANEL = 128
LANE_B, LANE_N = 10_000, 16


class PhaseFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def gpu_identity() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except FileNotFoundError:
        return "nvidia-smi: not found"
    return (out.stdout.strip() or out.stderr.strip()).replace("\n", " | ")


def last_line(jax) -> str:
    d = jax.devices()
    return json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}})


def timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ----------------------------------------------------------------------
# phase 1: kernels against the plain reference
def kkt_matrix(D=DENSE_D, M=DENSE_M):
    """The inertia-corrected KKT system of the K = D + M benchmark: a PD
    primal block and M equality rows (bench.py's construction)."""
    import jax
    import jax.numpy as jnp

    K = D + M
    kg, kj = jax.random.split(jax.random.key(0))
    G = jax.random.normal(kg, (D, D), jnp.float32) / jnp.sqrt(D)
    W = G @ G.T + 0.5 * jnp.eye(D, dtype=jnp.float32)
    Je = jax.random.normal(kj, (D, M), jnp.float32) / jnp.sqrt(D)
    H = jnp.zeros((K, K), jnp.float32)
    return H.at[:D, :D].set(W).at[:D, D:].set(Je).at[D:, :D].set(Je.T)


def trailing_panels(A, block=PANEL):
    """Every diagonal panel a right-looking blocked LDL^T of A factors: the
    leading block of each trailing Schur complement, in float64."""
    W = np.asarray(A, np.float64)
    panels = []
    while W.shape[0] > 0:
        panels.append(W[:block, :block].copy())
        if W.shape[0] <= block:
            break
        W = (W[block:, block:]
             - W[block:, :block] @ np.linalg.solve(W[:block, :block],
                                                    W[:block, block:]))
    return np.stack(panels)


def factor_errors(A, L, d):
    """(max reconstruction error / (max|A| n), negative-pivot counts) per
    matrix, on the host in float64."""
    A = np.asarray(A, np.float64)
    L = np.asarray(L, np.float64)
    d = np.asarray(d, np.float64)
    n = A.shape[-1]
    rec = np.einsum("bij,bj,bkj->bik", L, d, L)
    err = np.abs(rec - A).max(axis=(1, 2))
    scale = np.abs(A).max(axis=(1, 2)) * n
    return err / scale, (d < 0).sum(-1)


def small_systems(B=LANE_B, n=LANE_N, seed=1):
    """Half SPD, half quasi-definite [[Q, A^T], [A, -E]] (n/4 negative
    eigenvalues) — the two shapes the condensed small systems take."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    S = np.einsum("bij,bkj->bik", G, G) / n + np.eye(n)
    m = n // 4
    half = B // 2
    S[half:, n - m:, :] = rng.standard_normal((B - half, m, n)) / np.sqrt(n)
    S[half:, :, n - m:] = np.swapaxes(S[half:, n - m:, :], 1, 2)
    S[half:, n - m:, n - m:] = -np.eye(m) * rng.uniform(
        0.1, 1.0, (B - half, 1, m))
    return S.astype(np.float32)


def phase_kernels(jax, jnp):
    from pyipm_jax.ops import linalg, triton_ldlt

    lines = []
    with jax.default_matmul_precision("highest"):
        Hs, _ = jax.jit(linalg.ruiz_scale)(kkt_matrix())
    panels = trailing_panels(Hs)
    P32 = jnp.asarray(panels, jnp.float32)
    truth = (np.linalg.eigvalsh(np.asarray(P32, np.float64)) < 0).sum(-1)
    with jax.default_matmul_precision("highest"):
        Lk, dk = jax.jit(jax.vmap(triton_ldlt.panel_ldlt))(P32)
        Lr, dr = jax.jit(jax.vmap(linalg.ldlt_unblocked))(P32)
    rel_k, neg_k = factor_errors(P32, Lk, dk)
    rel_r, neg_r = factor_errors(P32, Lr, dr)
    lowered = jax.jit(triton_ldlt.panel_factor).lower(P32[0]).as_text()
    lines.append(
        f"panel kernel: {len(panels)} trailing panels of K={DENSE_D + DENSE_M}"
        f", max rel reconstruction {rel_k.max():.3e} (plain {rel_r.max():.3e},"
        f" limit 5e-5), negative pivots {neg_k.tolist()} "
        f"eigvalsh {truth.tolist()}, dispatch to Triton "
        f"{'triton' in lowered}, precision highest")
    check(rel_k.max() <= 5e-5, "panel kernel reconstruction")
    check(np.array_equal(neg_k, truth), "panel kernel inertia")
    check("triton" in lowered, "panel_factor did not dispatch to Triton")

    A = small_systems()
    b = np.random.default_rng(2).standard_normal((LANE_B, LANE_N))
    Aj, bj = jnp.asarray(A), jnp.asarray(b, jnp.float32)
    truth = (np.linalg.eigvalsh(A.astype(np.float64)) < 0).sum(-1)
    with jax.default_matmul_precision("highest"):
        Lk, dk = jax.jit(triton_ldlt.batched_ldlt_factor)(Aj)
        xk = jax.jit(triton_ldlt.batched_ldlt_solve)(Lk, dk, bj)
        Lr, dr = jax.jit(linalg.ldlt_factor_unrolled)(Aj)
    rel_k, neg_k = factor_errors(A, Lk, dk)
    rel_r, _ = factor_errors(A, Lr, dr)
    xs = np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0]
    xerr = (np.abs(np.asarray(xk, np.float64) - xs).max()
            / np.abs(xs).max())
    lowered = jax.jit(jax.vmap(triton_ldlt.ldlt_factor_small)).lower(
        Aj).as_text()
    lines.append(
        f"lane kernel: B={LANE_B} n={LANE_N}, max rel reconstruction "
        f"{rel_k.max():.3e} (plain {rel_r.max():.3e}, limit 5e-5), "
        f"inertia exact {np.array_equal(neg_k, truth)}, solve rel error "
        f"{xerr:.3e} vs float64, dispatch to Triton {'triton' in lowered},"
        f" precision highest")
    check(rel_k.max() <= 5e-5, "lane kernel reconstruction")
    check(np.array_equal(neg_k, truth), "lane kernel inertia")
    check(xerr <= 1e-3, "lane kernel solve")
    check("triton" in lowered, "ldlt_factor_small did not dispatch")
    return lines


# ----------------------------------------------------------------------
# phase 2: the QP fleet
def qp_slsqp(Q, c, A, b, lb, ub):
    from scipy.optimize import minimize

    res = minimize(
        lambda x: 0.5 * x @ Q @ x + c @ x, np.zeros(len(c)),
        jac=lambda x: Q @ x + c, method="SLSQP",
        bounds=list(zip(lb, ub)),
        constraints=[{"type": "ineq", "fun": lambda x: A @ x - b,
                      "jac": lambda x: A}],
        options={"ftol": 1e-12, "maxiter": 500})
    return res.x, res.fun


def fleet_oracle(data, x, n=64):
    """Worst relative objective gap against SLSQP (float64) on n
    instances, and the worst constraint violation of the fleet's x."""
    arrs = [np.asarray(a, np.float64) for a in data]
    xs = np.asarray(x, np.float64)
    gap, viol = 0.0, 0.0
    for i in range(n):
        Q, c, A, b, lb, ub = (a[i] for a in arrs)
        _, fref = qp_slsqp(Q, c, A, b, lb, ub)
        xi = xs[i]
        f = 0.5 * xi @ Q @ xi + c @ xi
        gap = max(gap, abs(f - fref) / max(1.0, abs(fref)))
        viol = max(viol, float(np.max(np.maximum(
            0, np.concatenate([lb - xi, xi - ub, b - A @ xi])))))
    return gap, viol


def fleet_stats(res):
    sig = np.asarray(res.signal)
    it = np.asarray(res.iter_count)
    return float(np.mean(np.isin(sig, (1, 2)))), float(it.mean()), int(
        it.max())


def phase_fleet(jax, jnp):
    from pyipm_jax.config import IPMConfig
    from pyipm_jax.models.random_nlp import (
        make_qp_batch_solver, make_qp_problem, sample_qp_batch,
    )
    from pyipm_jax.parallel.batch import make_wave_batch_solver

    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=KTOL)
    data = sample_qp_batch(jax.random.key(42), FLEET_B, FLEET_D,
                           nlin=FLEET_L)
    x0 = jnp.zeros((FLEET_B, FLEET_D), jnp.float32)
    x1 = x0 + 1e-6

    lock = make_qp_batch_solver(cfg, nvar=FLEET_D, nlin=FLEET_L)
    t0 = time.perf_counter()
    compiled = lock.lower(x0, data).compile()
    t_comp = time.perf_counter() - t0
    compiled(x0, data).signal.block_until_ready()
    res, wall = timed(compiled, x1, data)
    hit, mean_it, max_it = fleet_stats(res)
    gap, viol = fleet_oracle(data, res.x)
    lines = [f"fleet lockstep (vmapped make_solver, as solve_batch): "
             f"B={FLEET_B} D={FLEET_D} hit {hit:.4f}, iters mean "
             f"{mean_it:.2f} max {max_it}, wall {wall:.4f} s, compile "
             f"{t_comp:.1f} s, SLSQP objective gap {gap:.2e} "
             f"(64 instances), violation {viol:.1e}"]
    check(hit >= 0.999, "lockstep hit rate")
    check(gap <= 1e-4, "lockstep objective vs SLSQP")

    wave = make_wave_batch_solver(
        config=cfg, family=lambda d: make_qp_problem(d, FLEET_D, FLEET_L),
        first_wave=10, wave=20, wave_growth=1.5, min_pad=256)
    _, first = timed(wave, x0, data)
    res, wall = timed(wave, x1, data)
    hit, mean_it, max_it = fleet_stats(res)
    gap, viol = fleet_oracle(data, res.x)
    lines.append(
        f"fleet wave (first_wave=10, wave=20, growth 1.5): hit {hit:.4f}, "
        f"iters mean {mean_it:.2f} max {max_it}, wall {wall:.4f} s, "
        f"compile {first - wall:.1f} s (first call minus second), SLSQP "
        f"objective gap {gap:.2e}, violation {viol:.1e}")
    check(hit >= 0.999, "wave hit rate")
    check(gap <= 1e-4, "wave objective vs SLSQP")
    return lines


# ----------------------------------------------------------------------
# phase 3: the dense nonconvex NLP
def dense_residuals(data, x, lda):
    """Stationarity and feasibility in float64 from the problem's own
    formulas: grad f(x) - Aeq^T lda_e (the solver's sign convention) and
    Aeq x - beq."""
    P, c, W, Aeq, beq, alpha = (np.asarray(a, np.float64) for a in data)
    x = np.asarray(x, np.float64)
    le = np.asarray(lda, np.float64)[:Aeq.shape[0]]
    sq = np.sqrt(x.shape[0])
    t = np.tanh(W @ x / sq)
    grad = P @ x + c + alpha * (W.T @ (1 - t * t)) / sq
    return (np.abs(grad - Aeq.T @ le).max(),
            np.abs(Aeq @ x - beq).max())


def phase_dense(jax, jnp):
    from pyipm_jax.config import IPMConfig
    from pyipm_jax.models.random_nlp import (
        make_dense_nlp_solver, sample_dense_nlp,
    )

    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=KTOL)
    data = sample_dense_nlp(jax.random.key(0), DENSE_D, DENSE_M,
                            hidden=DENSE_H)
    fn = make_dense_nlp_solver(cfg, DENSE_D, DENSE_M)
    x0 = jnp.zeros((DENSE_D,), jnp.float32)
    t0 = time.perf_counter()
    compiled = fn.lower(x0, data).compile()
    t_comp = time.perf_counter() - t0
    res, wall = timed(compiled, x0, data)
    stat, feas = dense_residuals(data, res.x, res.lda)
    sig = int(res.signal)
    line = (f"dense NLP D={DENSE_D} M={DENSE_M}: signal {sig}, iters "
            f"{int(res.iter_count)}, wall {wall:.3f} s, compile "
            f"{t_comp:.1f} s, float64 stationarity {stat:.2e} feasibility "
            f"{feas:.2e} (limit {10 * KTOL:g})")
    check(sig in (1, 2), "dense NLP signal")
    check(stat <= 10 * KTOL and feas <= 10 * KTOL, "dense NLP residuals")
    return [line]


# ----------------------------------------------------------------------
# phase 4: block-separable Schur solve
def schur_problem(jax, K=SCHUR_K):
    from pyipm_jax.parallel.schur import sample_separable

    return sample_separable(jax.random.key(7), K, SCHUR_D, SCHUR_MC)


def schur_solve(jax, mesh, spec, data, x0):
    from pyipm_jax.config import IPMConfig
    from pyipm_jax.parallel.schur import make_separable_solver

    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=KTOL)
    fn = make_separable_solver(spec, mesh, cfg, axis="model")
    _, first = timed(fn, x0, data)
    res, wall = timed(fn, x0 + 1e-6, data)
    return res, wall, first - wall


def schur_checks(data, res):
    A = np.asarray(data.A, np.float64)
    x = np.asarray(res.x, np.float64)
    coup = np.abs(np.einsum("kcd,kd->c", A, x)
                  - np.asarray(data.b, np.float64)).max()
    lbv = float(np.max(np.asarray(data.lb, np.float64) - x))
    return coup, lbv


def phase_schur(jax, jnp):
    from pyipm_jax.parallel.mesh import make_solver_mesh

    spec, data, x0 = schur_problem(jax)
    mesh = make_solver_mesh(batch=1, model=1)
    res, wall, comp = schur_solve(jax, mesh, spec, data, x0)
    coup, lbv = schur_checks(data, res)
    kkt = np.asarray(res.kkt)
    sig = int(res.signal)
    line = (f"Schur K={SCHUR_K} blocks d={SCHUR_D} mc={SCHUR_MC} "
            f"({SCHUR_K * SCHUR_D} vars, no cut): signal {sig}, iters "
            f"{int(res.iter_count)}, kkt max {kkt.max():.2e}, wall "
            f"{wall:.3f} s, compile {comp:.1f} s, float64 coupling "
            f"residual {coup:.2e}, max(lb - x) {lbv:.1e}")
    check(sig in (1, 2), "Schur signal")
    check(kkt.max() <= KTOL, "Schur kkt")
    check(coup <= 10 * KTOL and lbv <= 1e-6, "Schur residuals")
    return [line]


# ----------------------------------------------------------------------
# phase 5: reference parity
def phase_parity(jax, jnp):
    from pyipm_jax.api import IPM
    from pyipm_jax.models.reference_problems import get_problem

    dists = []
    for num in range(1, 11):
        spec = get_problem(num)
        x0 = spec.sample_x0(np.random.default_rng(42))
        p = IPM(x0=x0, f=spec.f, ce=spec.ce, ci=spec.ci, Ftol=1e-8,
                float_dtype=np.float64, verbosity=-1)
        x = p.solve()[0]
        dists.append(spec.distance_to_truth(x))
    line = ("reference problems 1-10 (IPM, float64): distance to truth "
            + " ".join(f"{d:.1e}" for d in dists) + " (limit 1e-3)")
    check(max(dists) <= 1e-3, "reference parity")
    return [line]


# ----------------------------------------------------------------------
# four cards
def phase_four_schur(jax, jnp):
    from pyipm_jax.parallel.mesh import make_solver_mesh

    spec, data, x0 = schur_problem(jax)
    one = make_solver_mesh(batch=1, model=1)
    four = make_solver_mesh(batch=1, model=4)
    r1, w1, _ = schur_solve(jax, one, spec, data, x0)
    r4, w4, c4 = schur_solve(jax, four, spec, data, x0)
    x1 = np.asarray(r1.x, np.float64)
    x4 = np.asarray(r4.x, np.float64)
    rel = np.abs(x4 - x1).max() / max(np.abs(x1).max(), 1e-30)
    devs = {d.id for d in r4.x.sharding.device_set}
    shard_devs = {s.device.id for s in r4.x.addressable_shards}
    line = (f"Schur model=4: signal {int(r4.signal)} (one card "
            f"{int(r1.signal)}), x rel diff {rel:.2e} (limit 1e-4), iters "
            f"{int(r4.iter_count)} vs {int(r1.iter_count)}, wall {w4:.3f} s "
            f"vs {w1:.3f} s, compile {c4:.1f} s, x on devices "
            f"{sorted(shard_devs)}")
    check(int(r4.signal) == int(r1.signal), "Schur signals differ")
    check(rel <= 1e-4, "Schur x differs across meshes")
    check(len(devs) == 4 and len(shard_devs) == 4, "Schur not spread")
    return [line]


def phase_four_fleet(jax, jnp):
    from jax.sharding import NamedSharding, PartitionSpec

    from pyipm_jax.config import IPMConfig
    from pyipm_jax.models.random_nlp import (
        make_qp_batch_solver, sample_qp_batch,
    )
    from pyipm_jax.parallel.mesh import make_batch_mesh

    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=KTOL)
    data = sample_qp_batch(jax.random.key(42), FLEET_B, FLEET_D,
                           nlin=FLEET_L)
    x0 = jnp.zeros((FLEET_B, FLEET_D), jnp.float32)
    fn = make_qp_batch_solver(cfg, nvar=FLEET_D, nlin=FLEET_L)
    r1 = jax.block_until_ready(fn(x0, data))
    shard = NamedSharding(make_batch_mesh(4), PartitionSpec("batch"))
    xs, ds = jax.device_put((x0, data), shard)
    fn(xs, ds).signal.block_until_ready()
    r4, wall = timed(fn, xs, ds)
    _, w1 = timed(fn, x0, data)
    s1, s4 = np.asarray(r1.signal), np.asarray(r4.signal)
    shard_devs = {s.device.id for s in r4.signal.addressable_shards}
    line = (f"fleet batch=4: signals agree {int((s1 == s4).sum())}/"
            f"{FLEET_B}, wall {wall:.4f} s vs one card {w1:.4f} s, "
            f"signal on devices {sorted(shard_devs)}")
    check(np.array_equal(s1, s4), "fleet signals differ across meshes")
    check(len(shard_devs) == 4, "fleet not spread over 4 devices")
    return [line]


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the two four-card comparisons")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    print(f"[0] {gpu_identity()}", flush=True)
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found platform {devs[0].platform!r}",
              file=sys.stderr)
        return 2
    from pyipm_jax.utils import compile_cache

    cache = compile_cache.enable(ROOT)
    import jax.numpy as jnp

    print(f"[0] jax {jax.__version__}, {len(devs)} x {devs[0].device_kind},"
          f" XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile cache "
          f"{cache}", flush=True)
    if args.four_cards:
        if len(devs) < 4:
            print(f"--four-cards needs 4 GPUs, found {len(devs)}",
                  file=sys.stderr)
            return 2
        phases = [("4-schur", phase_four_schur),
                  ("4-fleet", phase_four_fleet)]
    else:
        phases = [("1", phase_kernels), ("2", phase_fleet),
                  ("3", phase_dense), ("4", phase_schur),
                  ("5", phase_parity)]
    failed = []
    for tag, phase in phases:
        t0 = time.perf_counter()
        try:
            lines = phase(jax, jnp)
        except PhaseFailure as e:
            failed.append(tag)
            print(f"[{tag}] FAILED: {e}", flush=True)
            continue
        except Exception:          # report, then run the remaining phases
            failed.append(tag)
            print(f"[{tag}] FAILED with an exception:", flush=True)
            traceback.print_exc(file=sys.stdout)
            continue
        for ln in lines:
            print(f"[{tag}] {ln}", flush=True)
        print(f"[{tag}] phase wall {time.perf_counter() - t0:.1f} s",
              flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(f"[end] {gpu_identity()}")
    print(last_line(jax))
    return 0


if __name__ == "__main__":
    sys.exit(main())
