"""Pallas (Triton route) LDL^T kernels and the plain-JAX paths they stand
in for (SURVEY.md §4: Pallas-kernel-vs-jax.numpy equivalence).

Off the GPU the kernels run in interpret mode; the dispatch itself is a
``lax.platform_dependent`` choice, so these tests also check that the CPU
lowering holds no Triton call while the CUDA lowering does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyipm_jax.ops import triton_ldlt as tk
from pyipm_jax.ops.linalg import (
    ldlt_factor, ldlt_factor_unrolled, ldlt_solve, ldlt_solve_inv,
    ldlt_unblocked,
)


def _rand_sym(rng, B, n):
    A = rng.standard_normal((B, n, n))
    A = (A + np.swapaxes(A, 1, 2)) / 2 + np.eye(n) * (n / 4)
    return jnp.asarray(A, jnp.float32)


def _lowered(fn, *args, platform=None):
    traced = jax.jit(fn).trace(*args)
    if platform is None:
        return traced.lower().as_text()
    return traced.lower(lowering_platforms=(platform,)).as_text()


def _check_factor(A, L, d, tol=5e-5):
    """Reconstruction within tol * max|A| * n, inertia exactly that of
    eigvalsh in float64."""
    A64 = np.asarray(A, np.float64)
    n = A64.shape[-1]
    rec = np.einsum("...ij,...j,...kj->...ik", np.asarray(L, np.float64),
                    np.asarray(d, np.float64), np.asarray(L, np.float64))
    scale = np.max(np.abs(A64))
    np.testing.assert_allclose(rec, A64, atol=tol * scale * n, rtol=1e-4)
    w = np.linalg.eigvalsh(A64)
    np.testing.assert_array_equal((np.asarray(d) < 0).sum(-1),
                                  (w < 0).sum(-1))


@pytest.mark.parametrize("B,n", [(128, 16), (256, 24), (130, 8),
                                 (128, 48), (128, 64)])
def test_batched_factor_matches_reference(rng, B, n):
    """Power-of-two n: the instance-last kernel (interpret mode); other n:
    the batched unrolled form the dispatch sends them to.  Both against
    the left-looking loop reference."""
    A = _rand_sym(rng, B, n)
    # make some instances indefinite so inertia is non-trivial
    A = A.at[0].add(-np.float32(n / 2) * jnp.eye(n, dtype=jnp.float32))
    if tk._lane_ok(n, A.dtype):
        L, d = tk.batched_ldlt_factor(A, interpret=True)
    else:
        L, d = jax.vmap(tk.ldlt_factor_small)(A)
    Lr, dr = jax.vmap(ldlt_unblocked)(A)
    np.testing.assert_allclose(np.asarray(d), np.asarray(dr),
                               rtol=5e-3, atol=1e-3)
    _check_factor(A, L, d)


@pytest.mark.parametrize("B,n", [(128, 16), (129, 12), (128, 48),
                                 (128, 64)])
def test_batched_solve_matches_reference(rng, B, n):
    """Kernel solve (power-of-two n, interpret mode) or the log-depth
    inverse solve against float64 np.linalg.solve."""
    A = _rand_sym(rng, B, n)
    b = jnp.asarray(rng.standard_normal((B, n)), jnp.float32)
    Lr, dr = jax.vmap(ldlt_unblocked)(A)
    if tk._lane_ok(n, A.dtype):
        x = tk.batched_ldlt_solve(Lr, dr, b, interpret=True)
    else:
        x = jax.vmap(tk.ldlt_solve_small)(Lr, dr, b)
    A64 = np.asarray(A, np.float64)
    ref = np.linalg.solve(A64, np.asarray(b, np.float64)[..., None])[..., 0]
    # normwise forward error: a multiple of eps * cond(A) per instance,
    # with room for the element growth of an unpivoted LDL^T on the
    # indefinite instances
    fwd = (np.abs(np.asarray(x, np.float64) - ref).max(-1)
           / np.abs(ref).max(-1))
    bound = 500 * np.finfo(np.float32).eps * np.linalg.cond(A64, np.inf)
    assert np.all(fwd <= bound), (fwd / bound).max()
    res = np.einsum("bij,bj->bi", A64, np.asarray(x, np.float64)) \
        - np.asarray(b, np.float64)
    assert np.max(np.abs(res)) < 1e-4 * np.abs(A64).max() \
        * np.abs(np.asarray(x)).max() * n
    xr = jax.vmap(ldlt_solve)(Lr, dr, b)
    np.testing.assert_allclose(np.asarray(x), np.asarray(xr),
                               rtol=2e-3, atol=6e-3)


@pytest.mark.parametrize("n", [64, 128])
def test_panel_kernel_matches_reference(rng, n):
    A = _rand_sym(rng, 1, n)[0]
    A = A.at[: n // 4, : n // 4].add(-np.float32(n) * jnp.eye(
        n // 4, dtype=jnp.float32))
    L, d = tk.panel_ldlt(A, interpret=True)
    Lr, dr = ldlt_unblocked(A)
    np.testing.assert_allclose(np.asarray(d), np.asarray(dr),
                               rtol=5e-3, atol=1e-3)
    _check_factor(A, L, d)
    # the kernel builds L in place: exactly unit lower triangular
    np.testing.assert_array_equal(np.triu(np.asarray(L), 1), 0.0)
    np.testing.assert_array_equal(np.diag(np.asarray(L)), 1.0)


def test_custom_vmap_dispatch_unbatched(rng):
    """Unbatched calls take the unrolled XLA form on every platform: a
    valid factorization and no Triton call even when lowered for CUDA."""
    A = _rand_sym(rng, 1, 16)[0]
    L, d = tk.ldlt_factor_small(A)
    Lr, dr = ldlt_unblocked(A)
    np.testing.assert_allclose(np.asarray(L), np.asarray(Lr), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(d), np.asarray(dr), rtol=1e-4)
    _check_factor(A, L, d, tol=1e-5)
    assert "triton" not in _lowered(tk.ldlt_factor_small, A)
    assert "triton" not in _lowered(tk.ldlt_factor_small, A,
                                    platform="cuda")


def test_custom_vmap_dispatch_batched_cpu_fallback(rng):
    """vmapped calls lower to the batched unrolled form on the CPU (no
    Triton call in the HLO) and to the Triton kernel for CUDA."""
    A = _rand_sym(rng, 8, 16)
    L, d = jax.vmap(tk.ldlt_factor_small)(A)
    Lr, dr = jax.vmap(ldlt_unblocked)(A)
    np.testing.assert_allclose(np.asarray(L), np.asarray(Lr), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(d), np.asarray(dr), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(d) < 0, np.asarray(dr) < 0)
    f = jax.vmap(tk.ldlt_factor_small)
    assert "triton" not in _lowered(f, A)
    assert "triton" in _lowered(f, A, platform="cuda")
    b = jnp.ones((8, 16), jnp.float32)
    s = jax.vmap(tk.ldlt_solve_small)
    assert "triton" not in _lowered(s, L, d, b)
    assert "triton" in _lowered(s, L, d, b, platform="cuda")


@pytest.mark.slow
@pytest.mark.parametrize("B,n", [(4, 16), (4, 24), (3, 48), (2, 130)])
def test_unrolled_factor_blocked(rng, B, n):
    """Blocked unrolled factorization (panel inverse + matmul trailing
    updates) reconstructs A and gets the inertia right at every size."""
    A = _rand_sym(rng, B, n)
    # make some instances indefinite so inertia is non-trivial
    A = A.at[0].add(-np.float32(n) * jnp.eye(n, dtype=jnp.float32))
    L, d = ldlt_factor_unrolled(A)
    rec = np.einsum("bij,bj,bkj->bik", np.asarray(L), np.asarray(d),
                    np.asarray(L))
    scale = np.max(np.abs(np.asarray(A)))
    np.testing.assert_allclose(rec, np.asarray(A),
                               atol=1e-4 * scale * n, rtol=1e-3)
    w = np.linalg.eigvalsh(np.asarray(A).astype(np.float64))
    np.testing.assert_array_equal(
        (np.asarray(d) < 0).sum(-1), (w < 0).sum(-1))


def test_unit_lower_inverse_exact(rng):
    from pyipm_jax.ops.linalg import unit_lower_inverse

    for n in (5, 16, 33):
        L = np.tril(rng.standard_normal((n, n)), -1) + np.eye(n)
        Linv = np.asarray(unit_lower_inverse(jnp.asarray(L)))
        np.testing.assert_allclose(Linv @ L, np.eye(n), atol=1e-10)


def test_ldlt_solve_inv_matches_substitution(rng):
    A = _rand_sym(rng, 6, 20)
    b = jnp.asarray(rng.standard_normal((6, 20)), jnp.float32)
    L, d = jax.vmap(ldlt_unblocked)(A)
    x = np.asarray(ldlt_solve_inv(L, d, b))
    xr = np.linalg.solve(np.asarray(A).astype(np.float64),
                         np.asarray(b).astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, xr, rtol=1e-3, atol=1e-4)


# ----------------------------------------------------------------------
# panel-level backward sweep (the solve path of reg_solve_kkt)
def _panel_factors(rng, n, block=128, group=8):
    from pyipm_jax.ops.linalg import ldlt_factor_panels

    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2 + n * np.eye(n)
    b = rng.standard_normal(n)
    Lp, dp, invp, yf = ldlt_factor_panels(
        jnp.asarray(A, jnp.float32), block=block, group=group,
        rhs=jnp.asarray(b, jnp.float32))
    return A, b, Lp, dp, invp, yf


@pytest.mark.parametrize("n", [300, 1100, 1500])
def test_panel_sweep_xla_solves(rng, n):
    """fwd+bwd XLA panel sweeps against dense numpy solve (the
    want_solver=False reg_solve_kkt path)."""
    from pyipm_jax.ops.linalg import ldlt_solve_panels, ldlt_solve_panels_bwd

    A, b, Lp, dp, invp, yf = _panel_factors(rng, n)
    ref = np.linalg.solve(A, b)
    # full solve from scratch
    x1 = np.asarray(ldlt_solve_panels(Lp, dp, invp, jnp.asarray(b, jnp.float32)))
    np.testing.assert_allclose(x1, ref, rtol=5e-4, atol=5e-4)
    # folded-forward variant
    x2 = np.asarray(ldlt_solve_panels_bwd(Lp, dp, invp, yf))[:n]
    np.testing.assert_allclose(x2, ref, rtol=5e-4, atol=5e-4)


def test_panel_sweep_kernel_interpret_matches_xla(rng):
    """The backward panel sweep at a size with several superblocks and a
    padded tail (n=1900 pads to 2048) against a float64 dense solve."""
    from pyipm_jax.ops.linalg import ldlt_solve_panels_bwd

    n = 1900
    A, b, Lp, dp, invp, yf = _panel_factors(rng, n)
    assert Lp.shape[0] == 2048
    x = np.asarray(ldlt_solve_panels_bwd(Lp, dp, invp, yf))
    np.testing.assert_allclose(x[:n], np.linalg.solve(A, b), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(x[n:], 0.0, atol=1e-6)


def test_panel_sweep_custom_vmap_batched_fallback(rng):
    """The blocked factorization's panel dispatch: under vmap on the CPU
    it matches the loop reference with no Triton call in the HLO; lowered
    for CUDA it calls the kernel, batched and unbatched."""
    A = _rand_sym(rng, 3, 128)
    L, d = jax.vmap(tk.panel_factor)(A)
    Lr, dr = jax.vmap(ldlt_unblocked)(A)
    np.testing.assert_allclose(np.asarray(d), np.asarray(dr), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(L), np.asarray(Lr), rtol=1e-4,
                               atol=1e-5)
    f = jax.vmap(tk.panel_factor)
    assert "triton" not in _lowered(f, A)
    assert "triton" in _lowered(f, A, platform="cuda")
    assert "triton" in _lowered(tk.panel_factor, A[0], platform="cuda")
    # non-power-of-two panels and float64 never reach the kernel
    assert "triton" not in _lowered(tk.panel_factor, A[0, :96, :96],
                                    platform="cuda")


@pytest.mark.parametrize("n", [256, 384])
def test_blocked_factor_with_unblocked_panels(rng, n):
    """ldlt_factor at several panels (the CPU takes the unblocked panel
    loop): reconstruction and exact inertia of an indefinite matrix."""
    A = _rand_sym(rng, 1, n)[0]
    A = A.at[-64:, -64:].add(-np.float32(n) * jnp.eye(64, dtype=jnp.float32))
    L, d = ldlt_factor(A, block=128)
    _check_factor(A, L, d)
