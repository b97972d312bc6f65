"""Receding-horizon MPC with warm starts — the SERVING pattern.

A production controller re-solves the same finite-horizon program every
tick with a shifted initial state.  The warm-start surface the reference
exposes (x0/s0/lda0, reference pyipm.py:1567-1578) is exactly what a
receding-horizon loop needs: seed each tick with the previous solution
shifted by one step.  With one jitted solver (state-dependent data is an
ARGUMENT, so no recompiles across ticks), warm starting cuts the
iteration count per tick substantially vs cold starts — the latency that
matters in closed-loop control.

    python examples/mpc_receding_horizon.py
"""

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp                     # noqa: E402
import numpy as np                          # noqa: E402

from pyipm_jax import IPMConfig             # noqa: E402
from pyipm_jax.core.solver import make_solver  # noqa: E402
from pyipm_jax.models.applications import (  # noqa: E402
    MPCData, make_mpc_problem, sample_mpc_batch,
)


def main():
    nx, nu, T, ticks = 4, 2, 12, 20
    data0 = jax.tree.map(lambda a: a[0],
                         sample_mpc_batch(jax.random.key(0), 1, nx, nu))
    cfg = IPMConfig(float_dtype="float32", verbosity=0, Ktol=1e-4)

    # ONE jitted solver; per-tick data (x_init) is an argument
    def solve_tick(x_init, u0, s0, lda0, warm):
        data = MPCData(data0.Ad, data0.Bd, x_init, data0.x_ref,
                       data0.umax)
        prob = make_mpc_problem(data, T)
        if warm:
            fn = make_solver(prob, cfg, with_s0=True, with_lda0=True,
                             jit=False)
            return fn(u0, s0, lda0)
        fn = make_solver(prob, cfg, jit=False)
        return fn(u0)

    cold = jax.jit(lambda xi, u0: solve_tick(xi, u0, None, None, False))
    warm = jax.jit(lambda xi, u0, s0, l0: solve_tick(xi, u0, s0, l0,
                                                     True))

    def shift(u_flat):
        u = u_flat.reshape(T, nu)
        return jnp.concatenate([u[1:], u[-1:]]).reshape(-1)

    x = data0.x_init
    u_prev = jnp.zeros((T * nu,), jnp.float32)
    res = cold(x, u_prev)
    cold_iters, warm_iters = [int(res.iter_count)], []
    for t in range(ticks):
        # apply the first input, step the plant, re-solve warm
        u_now = res.x.reshape(T, nu)[0]
        x = data0.Ad @ x + data0.Bd @ u_now
        u_ws = shift(res.x)
        # slacks/multipliers shifted implicitly by re-deriving the slack
        # from ci at the warm start; multipliers reused as-is
        res_w = warm(x, u_ws, jnp.maximum(
            jnp.concatenate([u_ws + data0.umax, data0.umax - u_ws]),
            cfg.Ktol), res.lda)
        res_c = cold(x, jnp.zeros_like(u_prev))
        warm_iters.append(int(res_w.iter_count))
        cold_iters.append(int(res_c.iter_count))
        assert int(res_w.signal) in (1, 2)
        res = res_w

    print(f"cold-start iterations/tick: mean {np.mean(cold_iters):.1f}")
    print(f"warm-start iterations/tick: mean {np.mean(warm_iters):.1f}")
    assert np.mean(warm_iters) < np.mean(cold_iters)
    print("warm starts save "
          f"{100 * (1 - np.mean(warm_iters) / np.mean(cold_iters)):.0f}%"
          " of iterations in the receding-horizon loop")


if __name__ == "__main__":
    main()
