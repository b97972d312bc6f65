"""Pallas kernels (Triton route) for the LDL^T hot path on NVIDIA GPUs.

Two kernels, each the GPU side of a ``lax.platform_dependent`` choice made
for the platform the computation is lowered for: the CUDA branch runs the
kernel, every other platform runs the plain-JAX form from ops/linalg.py.
Nothing here reads the process's default backend, so a computation staged
onto a CPU mesh inside a GPU process takes the plain path by itself.

* :func:`panel_factor` — the 128 x 128 diagonal panel of the blocked
  factorization (:func:`~pyipm_jax.ops.linalg.ldlt_factor`).  The plain
  form is a 128-step ``fori_loop`` of dependent column updates, each step
  a few separate kernel launches; here one program holds the panel on
  chip and walks the columns itself.  L is built in place in A's storage
  (each finished column overwrites column j), so the program carries one
  128 x 128 tile instead of two.

* :func:`ldlt_factor_small` / :func:`ldlt_solve_small` — the batched
  small-system factor and solve (the fleet's condensed systems).  Under
  ``vmap`` the batch is laid out instance-last, (n, n, B), so that every
  step of the factorization is elementwise work across instances with
  coalesced loads; unbatched calls take the plain unrolled form.

Triton needs power-of-two block shapes: other sizes, and dtypes other than
float32, take the plain path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from pyipm_jax.ops import linalg as _lin

# one program per 128 x 128 float32 panel: 8 warps keep the in-place tile
# in registers (64 KB over 256 threads)
PANEL_WARPS = 8
# instances per program of the lane kernels: an (n, n, LANE_BLOCK) tile of
# at most LANE_TILE elements
LANE_TILE = 8192
LANE_WARPS = 4


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


# ----------------------------------------------------------------------
# single-panel kernel for the blocked factorization
def _panel_kernel(a_ref, l_ref, d_ref):
    A = a_ref[...]
    n = A.shape[0]
    dtype = A.dtype
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    rows = lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    cols = lax.broadcasted_iota(jnp.int32, (1, n), 1)

    def body(j, carry):
        A, dv = carry
        c = jnp.sum(jnp.where(cols == j, A, zero), axis=1,
                    keepdims=True)                           # (n, 1)
        dj = jnp.sum(jnp.where(rows == j, c, zero))
        safe = jnp.where(jnp.abs(dj) > 0, dj, one)
        below = rows > j
        col = jnp.where(below, c / safe, zero)               # L[:, j]
        # rank-1 trailing update, rows and columns > j only
        A = A - jnp.where(below, c, zero) * col.reshape(1, n)
        A = jnp.where(cols == j, col + jnp.where(rows == j, one, zero), A)
        dv = jnp.where(cols == j, dj, dv)
        return A, dv

    L, dv = lax.fori_loop(0, n, body, (A, jnp.zeros((1, n), dtype)))
    l_ref[...] = L
    d_ref[...] = dv


def panel_ldlt(A, *, interpret: bool = False):
    """(n, n) unpivoted LDL^T in one Triton program; returns (L, d)."""
    n = A.shape[0]
    L, d = pl.pallas_call(
        _panel_kernel,
        out_shape=[jax.ShapeDtypeStruct((n, n), A.dtype),
                   jax.ShapeDtypeStruct((1, n), A.dtype)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=PANEL_WARPS),
        interpret=interpret,
        name="ldlt_panel",
    )(A)
    return L, d[0]


def panel_factor(A):
    """Diagonal-panel factorization for :func:`ldlt_factor`: the Triton
    kernel where the computation is lowered for CUDA, the plain loop
    elsewhere."""
    n = A.shape[0]
    if A.dtype != jnp.float32 or not _pow2(n) or n > 128:
        return _lin.ldlt_unblocked(A)
    return lax.platform_dependent(A, cuda=panel_ldlt,
                                  default=_lin.ldlt_unblocked)


# ----------------------------------------------------------------------
# instance-last kernels for batched small systems: operands (n, n, BL)
# and (n, BL), one program per BL instances
def _lane_factor_kernel(a_ref, l_ref, d_ref):
    A = a_ref[...]
    n = A.shape[0]
    dtype = A.dtype
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    rows3 = lax.broadcasted_iota(jnp.int32, (n, 1, 1), 0)
    cols3 = lax.broadcasted_iota(jnp.int32, (1, n, 1), 1)
    rows2 = lax.broadcasted_iota(jnp.int32, (n, 1), 0)

    def body(j, carry):
        A, dv = carry
        c = jnp.sum(jnp.where(cols3 == j, A, zero), axis=1)      # (n, BL)
        dj = jnp.sum(jnp.where(rows2 == j, c, zero), axis=0,
                     keepdims=True)                               # (1, BL)
        safe = jnp.where(jnp.abs(dj) > 0, dj, one)
        below = rows2 > j
        col = jnp.where(below, c / safe, zero)
        cm = jnp.where(below, c, zero)
        A = A - cm[:, None, :] * col[None, :, :]
        Lcol = col + jnp.where(rows2 == j, one, zero)
        A = jnp.where(cols3 == j, Lcol[:, None, :], A)
        dv = jnp.where(rows2 == j, dj, dv)
        return A, dv

    L, dv = lax.fori_loop(0, n, body,
                          (A, jnp.zeros((n, A.shape[2]), dtype)))
    l_ref[...] = L
    d_ref[...] = dv


def _lane_solve_kernel(l_ref, d_ref, b_ref, x_ref):
    L = l_ref[...]
    dv = d_ref[...]
    b = b_ref[...]
    n = L.shape[0]
    dtype = L.dtype
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    rows3 = lax.broadcasted_iota(jnp.int32, (n, 1, 1), 0)
    cols3 = lax.broadcasted_iota(jnp.int32, (1, n, 1), 1)
    rows2 = lax.broadcasted_iota(jnp.int32, (n, 1), 0)

    def fwd(j, y):
        Lrow = jnp.sum(jnp.where(rows3 == j, L, zero), axis=0)   # (n, BL)
        Lrow = jnp.where(rows2 < j, Lrow, zero)
        bj = jnp.sum(jnp.where(rows2 == j, b, zero), axis=0, keepdims=True)
        yj = bj - jnp.sum(Lrow * y, axis=0, keepdims=True)
        return jnp.where(rows2 == j, yj, y)

    y = lax.fori_loop(0, n, fwd, jnp.zeros_like(b))
    z = y / jnp.where(jnp.abs(dv) > 0, dv, one)

    def bwd(t, x):
        j = n - 1 - t
        Lcol = jnp.sum(jnp.where(cols3 == j, L, zero), axis=1)   # (n, BL)
        Lcol = jnp.where(rows2 > j, Lcol, zero)
        zj = jnp.sum(jnp.where(rows2 == j, z, zero), axis=0, keepdims=True)
        xj = zj - jnp.sum(Lcol * x, axis=0, keepdims=True)
        return jnp.where(rows2 == j, xj, x)

    x_ref[...] = lax.fori_loop(0, n, bwd, jnp.zeros_like(b))


def _lane_block(n: int) -> int:
    return max(1, LANE_TILE // (n * n))


def _lane_call(kernel, operands, out_shapes, n, B, interpret):
    """Run an instance-last kernel over (..., B) operands, B padded to the
    program width; padded instances factor or solve the zero system."""
    bl = _lane_block(n)
    bp = -(-B // bl) * bl
    ops = [jnp.pad(o, [(0, 0)] * (o.ndim - 1) + [(0, bp - B)])
           for o in operands]

    def spec(ndim):
        lead = (0,) * (ndim - 1)
        return pl.BlockSpec((n,) * (ndim - 1) + (bl,),
                            lambda i: lead + (i,))

    outs = pl.pallas_call(
        kernel,
        grid=(bp // bl,),
        in_specs=[spec(o.ndim) for o in ops],
        out_specs=[spec(len(s)) for s in out_shapes],
        out_shape=[jax.ShapeDtypeStruct(s[:-1] + (bp,), ops[0].dtype)
                   for s in out_shapes],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=LANE_WARPS),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*ops)
    return [o[..., :B] for o in outs]


def batched_ldlt_factor(A, *, interpret: bool = False):
    """A (B, n, n) -> (L (B, n, n), d (B, n)) via the instance-last kernel."""
    B, n, _ = A.shape
    L, d = _lane_call(_lane_factor_kernel, [jnp.moveaxis(A, 0, -1)],
                      [(n, n, B), (n, B)], n, B, interpret)
    return jnp.moveaxis(L, -1, 0), jnp.moveaxis(d, -1, 0)


def batched_ldlt_solve(L, d, b, *, interpret: bool = False):
    """(B, n, n), (B, n), (B, n) -> x (B, n) via the instance-last kernel."""
    B, n, _ = L.shape
    (x,) = _lane_call(_lane_solve_kernel,
                      [jnp.moveaxis(L, 0, -1), jnp.moveaxis(d, 0, -1),
                       jnp.moveaxis(b, 0, -1)],
                      [(n, B)], n, B, interpret)
    return jnp.moveaxis(x, -1, 0)


def _lane_ok(n: int, dtype) -> bool:
    return dtype == jnp.float32 and _pow2(n) and n <= 64


@jax.custom_batching.custom_vmap
def ldlt_factor_small(A):
    """LDL^T for n <= 128: the unrolled XLA form for a single system; under
    ``vmap`` the instance-last kernel on CUDA."""
    L, d = _lin.ldlt_factor_unrolled(A[None])
    return L[0], d[0]


@ldlt_factor_small.def_vmap
def _factor_vmap_rule(axis_size, in_batched, A):
    if not _lane_ok(A.shape[-1], A.dtype):
        return _lin.ldlt_factor_unrolled(A), (True, True)
    out = lax.platform_dependent(A, cuda=batched_ldlt_factor,
                                 default=_lin.ldlt_factor_unrolled)
    return tuple(out), (True, True)


@jax.custom_batching.custom_vmap
def ldlt_solve_small(L, d, b):
    return _lin.ldlt_solve_inv(L, d, b)


@ldlt_solve_small.def_vmap
def _solve_vmap_rule(axis_size, in_batched, L, d, b):
    if not all(in_batched):
        f = jax.vmap(_lin.ldlt_solve_inv,
                     in_axes=tuple(0 if x else None for x in in_batched))
        return f(L, d, b), True
    if not _lane_ok(L.shape[-1], L.dtype):
        return _lin.ldlt_solve_inv(L, d, b), True
    return lax.platform_dependent(L, d, b, cuda=batched_ldlt_solve,
                                  default=_lin.ldlt_solve_inv), True
