"""Dense symmetric-indefinite linear algebra for the KKT hot path.

The reference delegates its hot linear algebra to Aesara/LAPACK: a dense
general solve (reference pyipm.py:18-20, 906-914) and a full generalized
eigendecomposition *per inertia-correction retry* (reference
pyipm.py:1373-1406 — one ``eigvalsh`` per delta escalation, the single most
expensive repeated operation in the solver).

Replacement: an unpivoted blocked LDL^T factorization.  By Sylvester's
law of inertia the signs of the pivots d_i give the matrix inertia for
free, so the inertia-corrected KKT solve becomes factor → count → (retry
with larger shift) → reuse the factors for the solve.  The blocked
right-looking form keeps the O(n^3) trailing updates in large matmuls; the
statically-unrolled block loop keeps every shape static for XLA.

Two methods are exposed via :func:`reg_solve_kkt`:
  - ``'ldlt'``  — factor-once inertia (fast path).
  - ``'lu'``    — eigendecomposition inertia + LU solve, reproducing the
                  reference's numerics decision-for-decision for parity tests.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular


# ----------------------------------------------------------------------
# LDL^T factorization
def ldlt_unblocked(A):
    """Unpivoted LDL^T of a symmetric matrix.

    Returns (L, d) with L unit-lower-triangular and A = L @ diag(d) @ L.T.
    Runs one masked column step per ``fori_loop`` iteration; for matrices
    above the block size use :func:`ldlt_factor`.
    """
    n = A.shape[0]
    dtype = A.dtype
    idx = jnp.arange(n)

    def body(j, carry):
        L, d = carry
        colmask = idx < j
        Lj = jnp.where(colmask, L[j, :], jnp.zeros((), dtype))
        w = d * Lj                      # d_k * L[j,k] for k < j
        c = A[:, j] - L @ w             # Schur column
        dj = c[j]
        d = d.at[j].set(dj)
        safe = jnp.where(jnp.abs(dj) > 0, dj, jnp.ones((), dtype))
        col = jnp.where(idx > j, c / safe, jnp.zeros((), dtype))
        L = L.at[:, j].set(col)
        L = L.at[j, j].set(jnp.ones((), dtype))
        return L, d

    L0 = jnp.zeros_like(A)
    d0 = jnp.zeros((n,), dtype)
    return lax.fori_loop(0, n, body, (L0, d0), unroll=False)


def ldlt_factor(A, block: int = 128, segments: int | None = None, rhs=None,
                pad_to: int | None = None, want_panels: bool = False):
    """Blocked right-looking LDL^T with a segmented trailing update.

    Pads to a multiple of ``block`` with an identity tail (which contributes
    unit pivots and leaves the leading inertia untouched) and factors panel
    by panel inside a ``fori_loop`` body: the panel position is a traced
    index handled with fixed-size dynamic slices, the panel solve uses the
    unblocked kernel + a triangular solve, and the trailing update is one
    (m, B) x (B, m) matmul per step (rows above the panel are masked to
    zero, so the 'trailing' restriction is implicit).  The loop keeps the
    compiled program size INDEPENDENT of the panel count.

    A single loop at the full size m = n does 3x the minimal n^3/3 flops
    (every step updates the full height).  Splitting the panel range into
    ``segments`` contiguous chunks, each operating on its STATIC trailing
    submatrix (m shrinks chunk by chunk), cuts the overhead toward 1x as
    the segment count grows.  The default (``segments=None``) is ONE
    BLOCK PER SEGMENT — every trailing update runs at its exact height,
    i.e. the minimal n^3/3 flop count with zero masked overwork, at the
    price of one unrolled loop per panel in the compiled program.  An
    integer ``segments`` keeps the grouped fori_loop form (compiled
    program size independent of the panel count) for callers who need
    compile time bounded at very large n.  Each diagonal panel is
    factored by :func:`~pyipm_jax.ops.triton_ldlt.panel_factor`: one
    Triton program on CUDA, the unblocked loop elsewhere.
    """
    n = A.shape[0]
    if n <= block:
        assert pad_to is None and not want_panels
        if rhs is None:
            return ldlt_unblocked(A)
        L0, d0 = ldlt_unblocked(A)
        y0 = solve_triangular(L0, rhs, lower=True, unit_diagonal=True)
        return L0, d0, y0
    nb = -(-n // block)
    npad = nb * block
    # ``pad_to`` (>= npad, multiple of block): allocate the OUTPUT factor
    # buffers at that size with an identity tail and return them unsliced.
    # The factorization itself still runs on the npad grid — the tail
    # costs zero flops and zero extra memory passes, versus a full pass
    # over the O(n^2) factor a caller pays to re-materialize a padded copy
    # afterwards (reg_solve_kkt pads to the superblock grid of
    # ldlt_factor_blocks so every downstream solve can skip it).
    out = npad if pad_to is None else int(pad_to)
    assert out >= npad and out % block == 0
    dtype = A.dtype
    if npad != n:
        W = jnp.zeros((npad, npad), dtype)
        W = W.at[:n, :n].set(A)
        W = W.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
    else:
        W = A
    with_rhs = rhs is not None
    bt_full = (jnp.zeros((npad,), dtype).at[:n].set(rhs) if with_rhs
               else jnp.zeros((0,), dtype))

    from pyipm_jax.ops import triton_ldlt
    panel_factor = triton_ldlt.panel_factor

    if segments is None:
        sizes = [1] * nb                     # per-block static schedule
    else:
        nseg = max(1, min(int(segments), nb))
        base, rem = divmod(nb, nseg)
        sizes = [base + (1 if s_ < rem else 0) for s_ in range(nseg)]

    L = jnp.zeros((out, out), dtype)
    d = jnp.zeros((out,), dtype)
    if out > npad:
        tail = jnp.arange(npad, out)
        L = L.at[tail, tail].set(1.0)
        d = d.at[npad:].set(1.0)
    y = jnp.zeros((out,), dtype) if with_rhs else None
    # ``want_panels``: stack the diagonal panel factors Lkk as they are
    # computed — consumers (the superblock-inverse chain in
    # :func:`ldlt_factor_blocks`) then never gather panels out of the
    # O(n^2) assembled factor, which would serialize against (and pay
    # for) its full materialization.  Tail panels beyond the factored
    # region are identity.
    if want_panels:
        nbp = out // block
        panels = jnp.zeros((nbp, block, block), dtype) + jnp.eye(
            block, dtype=dtype)
    else:
        panels = None
    off = 0
    Wt = W                                   # running trailing submatrix
    bt = bt_full                             # running fwd-substituted rhs
    for cs in sizes:
        m = npad - off                       # static per segment
        w = cs * block
        rows = jnp.arange(m)

        def body(k, carry, m=m, rows=rows):
            Wt, Lt, dv, bt, yt, pt = carry   # (m,m),(m,w),(w,),(m|0,),(w|0,)
            j0 = k * block                   # panel offset within segment
            Wkk = lax.dynamic_slice(Wt, (j0, j0), (block, block))
            Lkk, dk = panel_factor(Wkk)
            if want_panels:
                pt = lax.dynamic_update_slice(pt, Lkk[None], (k, 0, 0))
            safe = jnp.where(jnp.abs(dk) > 0, dk, jnp.ones((), dtype))
            P = lax.dynamic_slice(Wt, (0, j0), (m, block))   # column slab
            # Y = P L11^{-T} for sub-panel rows; rows <= panel masked out.
            # With a rhs, its panel chunk RIDES THE SAME triangular-solve
            # custom call as one extra column (forward substitution folded
            # into the factorization: y_k = Lkk^{-1} b_k, then the
            # trailing rhs is downdated by L21 y_k alongside the Schur
            # update — the standalone forward sweep disappears)
            if with_rhs:
                bk = lax.dynamic_slice(bt, (j0,), (block,))
                X = solve_triangular(
                    Lkk, jnp.concatenate([P.T, bk[:, None]], axis=1),
                    lower=True, unit_diagonal=True)
                Y = X[:, :m].T
                yk = X[:, m]
            else:
                Y = solve_triangular(Lkk, P.T, lower=True,
                                     unit_diagonal=True).T
            below = (rows >= j0 + block)[:, None].astype(dtype)
            Yb = Y * below
            L21 = Yb / safe[None, :]
            # write the (m, block) column slab of L: Lkk rows on the
            # diagonal block, L21 below, zeros above
            in_blk = ((rows >= j0)
                      & (rows < j0 + block))[:, None].astype(dtype)
            Lkk_full = jnp.zeros((m, block), dtype)
            Lkk_full = lax.dynamic_update_slice(Lkk_full, Lkk, (j0, 0))
            slab = Lkk_full * in_blk + L21
            Lt = lax.dynamic_update_slice(Lt, slab, (0, j0))
            dv = lax.dynamic_update_slice(dv, dk, (j0,))
            # trailing update (implicitly restricted by the row mask)
            Wt = Wt - L21 @ Yb.T
            if with_rhs:
                bt = bt - L21 @ yk           # rows <= panel are masked 0
                yt = lax.dynamic_update_slice(yt, yk, (j0,))
            return Wt, Lt, dv, bt, yt, pt

        Lt0 = jnp.zeros((m, w), dtype)
        dv0 = jnp.zeros((w,), dtype)
        yt0 = jnp.zeros((w if with_rhs else 0,), dtype)
        pt0 = (jnp.zeros((cs, block, block), dtype) if want_panels
               else jnp.zeros((0, block, block), dtype))
        Wt, Lt, dv, bt, yt, pt = lax.fori_loop(
            0, cs, body, (Wt, Lt0, dv0, bt, yt0, pt0))
        L = L.at[off:off + m, off:off + w].set(Lt)
        d = d.at[off:off + w].set(dv)
        if want_panels:
            panels = panels.at[off // block:off // block + cs].set(pt)
        if with_rhs:
            y = y.at[off:off + w].set(yt)
            bt = bt[w:]
        Wt = Wt[w:, w:]                      # static shrink for next segment
        off += w
    outs = (L, d)
    if pad_to is None:
        outs = (L[:n, :n], d[:n])
    if with_rhs:
        outs = outs + ((y if pad_to is not None else y[:n]),)
    if want_panels:
        outs = outs + (panels,)
    return outs


# ----------------------------------------------------------------------
# small-system fast path: unrolled factorization + log-depth inverse.
#
# Sequential substitution for small n is a chain of tiny dependent ops
# whose per-op overhead dominates.  The cure is to eliminate the
# sequential solve entirely: L is UNIT lower triangular, so
# N = I - L is nilpotent (N^n = 0) and
#
#     L^{-1} = (I + N)(I + N^2)(I + N^4)...      [ceil(log2 n) factors]
#
# is EXACT in ceil(log2 n) squaring steps of batched (B, n, n) matmuls
# instead of a 2n-step dependency chain.  Solves then cost two
# batched matvecs and a diagonal scale.
def unit_lower_inverse(L):
    """Exact inverse of a unit lower-triangular matrix (batched or not)
    via log-depth nilpotent doubling; ~2*ceil(log2 n) matmuls."""
    n = L.shape[-1]
    eye = jnp.eye(n, dtype=L.dtype)
    N = eye - L                       # strictly lower, N^n = 0
    P = eye + N
    M = N
    span = 2                          # P currently sums N^0 .. N^(span-1)
    while span < n:
        M = M @ M                     # N^span
        P = P + P @ M                 # extends the sum to N^(2*span - 1)
        span *= 2
    return P


def ldlt_factor_unrolled(A, panel: int = 16, want_panel_inv: bool = False):
    """Batched LDL^T of (B, n, n) with a STATICALLY UNROLLED panel
    factorization and matmul trailing updates — no sequential dispatch
    chains, no custom calls.  Returns (L, d) like the other
    factorizations; with ``want_panel_inv`` additionally returns the
    panel inverses (B, nb, panel, panel) for
    :func:`ldlt_solve_unrolled_blocks` (they are computed anyway).

    The panel factor unrolls `panel` column steps as plain masked
    elementwise ops over (B, p, p); off-panel columns come from one
    batched matmul against the panel's log-depth inverse; the trailing
    Schur update is one batched matmul per panel.  Everything XLA sees is
    large, static, and fusible."""
    Bb, n, _ = A.shape
    dtype = A.dtype

    def factor_panel(Ap):
        """(B, p, p) unrolled unpivoted LDL^T."""
        p = Ap.shape[-1]
        rows = jnp.arange(p)
        cols = []
        ds = []
        for j in range(p):
            dj = Ap[:, j, j]
            safe = jnp.where(jnp.abs(dj) > 0, dj, jnp.ones((), dtype))
            col = Ap[:, :, j] / safe[:, None]
            col = jnp.where(rows[None, :] > j, col, jnp.zeros((), dtype))
            cols.append(col + (rows == j)[None, :].astype(dtype))
            ds.append(dj)
            Ap = Ap - col[:, :, None] * col[:, None, :] * dj[:, None, None]
        return jnp.stack(cols, axis=-1), jnp.stack(ds, axis=-1)

    if n <= panel:
        L, dv = factor_panel(A)
        if want_panel_inv:
            return L, dv, unit_lower_inverse(L)[:, None]
        return L, dv

    nb = -(-n // panel)
    npad = nb * panel
    if npad != n:
        pad = npad - n
        A = jnp.pad(A, ((0, 0), (0, pad), (0, pad)))
        A = A + jnp.pad(jnp.zeros((n,), dtype), (0, pad),
                        constant_values=1.0) * jnp.eye(npad, dtype=dtype)

    Lcols = []
    dparts = []
    invs = []
    At = A                               # (B, m, m) trailing, m shrinks
    for k in range(nb):
        m = npad - k * panel
        A11 = At[:, :panel, :panel]
        A21 = At[:, panel:, :panel]      # (B, m-p, p)
        L11, dk = factor_panel(A11)
        L11inv = unit_lower_inverse(L11)
        safe = jnp.where(jnp.abs(dk) > 0, dk, jnp.ones((), dtype))
        Y = A21 @ jnp.swapaxes(L11inv, -1, -2)      # = L21 * d
        L21 = Y / safe[:, None, :]
        At = At[:, panel:, panel:] - L21 @ jnp.swapaxes(Y, -1, -2)
        slab = jnp.concatenate([L11, L21], axis=1)  # (B, m, p)
        Lcols.append(jnp.pad(slab, ((0, 0), (npad - m, 0), (0, 0))))
        dparts.append(dk)
        invs.append(L11inv)
    L = jnp.concatenate(Lcols, axis=-1)
    d = jnp.concatenate(dparts, axis=-1)
    if want_panel_inv:
        return L[:, :n, :n], d[:, :n], jnp.stack(invs, axis=1)
    return L[:, :n, :n], d[:, :n]


def ldlt_solve_unrolled_blocks(L, d, invb, Bc, panel: int):
    """Batched multi-rhs solve (L diag(d) L^T) X = Bc via block
    forward/backward substitution with the panel inverses from
    :func:`ldlt_factor_unrolled` — 2n^2 MACs of STATIC batched matmuls
    per rhs, versus the ~2 log2(n) full n^3 matmuls a whole-matrix
    log-depth inverse costs (40x the factorization flops at n=256).
    Shapes: L (B, n, n), d (B, n), invb (B, nb, p, p), Bc (B, n, r)."""
    Bb, n, r = Bc.shape
    nb = invb.shape[1]
    npad = nb * panel
    dtype = L.dtype
    if npad != n:
        pad = npad - n
        L = jnp.pad(L, ((0, 0), (0, pad), (0, pad)))
        L = L + jnp.pad(jnp.zeros((n,), dtype), (0, pad),
                        constant_values=1.0) * jnp.eye(npad, dtype=dtype)
        d = jnp.pad(d, ((0, 0), (0, pad)), constant_values=1.0)
        Bc = jnp.pad(Bc, ((0, 0), (0, pad), (0, 0)))

    # forward: y_k = invb_k (b_k - L[k, :k] y[:k]) — static slices, one
    # batched matmul per panel step
    ys = []
    for k in range(nb):
        j0 = k * panel
        bk = Bc[:, j0:j0 + panel, :]
        if k:
            ycat = jnp.concatenate(ys, axis=1)          # (B, j0, r)
            bk = bk - L[:, j0:j0 + panel, :j0] @ ycat
        ys.append(invb[:, k] @ bk)
    y = jnp.concatenate(ys, axis=1)
    safe = jnp.where(jnp.abs(d) > 0, d, jnp.ones((), dtype))
    z = y / safe[..., None]

    # backward with L^T: x_k = invb_k^T (z_k - L[k+1:, k]^T x[k+1:])
    xs = [None] * nb
    for k in reversed(range(nb)):
        j0 = k * panel
        zk = z[:, j0:j0 + panel, :]
        if k < nb - 1:
            xcat = jnp.concatenate(xs[k + 1:], axis=1)  # (B, npad-j1, r)
            zk = zk - jnp.swapaxes(
                L[:, j0 + panel:, j0:j0 + panel], 1, 2) @ xcat
        xs[k] = jnp.swapaxes(invb[:, k], 1, 2) @ zk
    x = jnp.concatenate(xs, axis=1)
    return x[:, :n, :]


def ldlt_solve_inv(L, d, b):
    """Solve (L diag(d) L^T) x = b via the log-depth inverse of L —
    two batched matvecs + a diagonal scale, zero sequential substitution.
    Shapes: L (..., n, n), d (..., n), b (..., n)."""
    Linv = unit_lower_inverse(L)
    y = jnp.einsum("...ij,...j->...i", Linv, b)
    safe = jnp.where(jnp.abs(d) > 0, d, jnp.ones((), L.dtype))
    z = y / safe
    return jnp.einsum("...ji,...j->...i", Linv, z)


# up to this size, single-rhs solves use the log-depth inverse
# (ldlt_solve_inv) instead of two triangular_solve calls.  The bound was
# set for another accelerator and is untuned on the H100.
_TRI_LOOP_MAX = 256


def ldlt_factor_blocks(A, block: int = 128, group: int = 4, rhs=None,
                       pad_to_grid: bool = False):
    """Like :func:`ldlt_factor` but additionally returns the inverses of
    the unit-triangular diagonal SUPERBLOCKS, (nb/group, group*block,
    group*block), for :func:`ldlt_solve_blocks` at the superblock size.

    With the inverses in hand, the triangular solves against the factors
    become block forward/backward substitution made of matmuls instead of
    XLA's full-size ``triangular_solve``.  Two dispatch-latency
    optimizations:

      * the per-panel inverses come from ONE batched log-depth nilpotent
        chain (:func:`unit_lower_inverse`, ~2 log2(block) batched
        matmuls) instead of nb sequential triangular_solve custom calls;
      * ``group`` panels are assembled into each superblock inverse via
        blocked triangular inversion (X_ij = -X_ii L_ij-sums, a static
        g(g-1)/2 set of batched panel matmuls), cutting the SEQUENTIAL
        substitution chain in :func:`ldlt_solve_blocks` from nb to
        nb/group steps of ``group``-times-larger matvecs.

    The want_solver=False path does not consume THIS function: the
    superblock-inverse assembly below is g(g-1)/2 small einsums per
    superblock, so single-shot solves route through
    :func:`ldlt_factor_panels` and the panel-level sweep instead; this
    assembly remains for the factor-once/solve-many condensed path where
    it amortizes.
    """
    n = A.shape[0]
    assert n > block
    nb = -(-n // block)
    g = max(1, min(int(group), nb))
    nb2 = -(-nb // g)
    npad = nb2 * g * block
    sb = g * block
    dtype = A.dtype
    # with ``pad_to_grid`` the factor buffers are ALLOCATED at the
    # superblock grid size (identity tail) inside ldlt_factor, so neither
    # this function nor the caller ever re-materializes a padded copy of
    # the O(n^2) factor
    pt = npad if pad_to_grid else None
    if rhs is None:
        out = ldlt_factor(A, block=block, pad_to=pt,
                          want_panels=pad_to_grid)
        (L, d), rest = out[:2], out[2:]
        yf = None
    else:
        # forward substitution folded into the factorization (the rhs
        # rides the panel triangular solves) — callers finish the solve
        # with :func:`ldlt_solve_blocks_bwd`
        out = ldlt_factor(A, block=block, rhs=rhs, pad_to=pt,
                          want_panels=pad_to_grid)
        (L, d, yf), rest = out[:3], out[3:]
    if pad_to_grid:
        Lp = L
        panels = rest[0]      # stacked during the factor loop — no gather
    else:
        Lp = jnp.zeros((npad, npad), dtype).at[:n, :n].set(L)
        Lp = Lp.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
        idx = jnp.arange(nb2 * g)
        panels = Lp.reshape(nb2 * g, block, nb2 * g, block)[idx, :, idx, :]
    invp = unit_lower_inverse(panels)        # (nb2*g, block, block)
    if g == 1:
        return (L, d, invp) if yf is None else (L, d, invp, yf)
    # sub-diagonal panel blocks within each superblock:
    # Lsub[m, i, j] = L[(m*g+i)-panel-row, (m*g+j)-panel-col], i > j
    L4 = Lp.reshape(nb2, g, block, nb2, g, block)
    m_idx = jnp.arange(nb2)
    Lsub = L4[m_idx, :, :, m_idx, :, :]      # (nb2, g, block, g, block)
    inv4 = invp.reshape(nb2, g, block, block)
    # blocked triangular inverse: X_ii = invp_i,
    # X_ij = -invp_i @ sum_{k=j}^{i-1} L_ik X_kj  (i ascending)
    X = [[None] * g for _ in range(g)]
    for i in range(g):
        X[i][i] = inv4[:, i]
    for i in range(1, g):
        for j in range(i - 1, -1, -1):
            acc = 0.0
            for k in range(j, i):
                acc = acc + jnp.einsum(
                    "mab,mbc->mac", Lsub[:, i, :, k, :], X[k][j])
            X[i][j] = -jnp.einsum("mab,mbc->mac", inv4[:, i], acc)
    zero = jnp.zeros((nb2, block, block), dtype)
    invb = jnp.stack(
        [jnp.concatenate([X[i][j] if j <= i else zero for j in range(g)],
                         axis=2) for i in range(g)], axis=1)
    invb = invb.reshape(nb2, g * block, sb)   # (nb2, sb, sb)
    return (L, d, invb) if yf is None else (L, d, invb, yf)


def ldlt_factor_panels(A, block: int = 128, group: int = 8, rhs=None):
    """Like :func:`ldlt_factor_blocks` but stops at the PANEL inverses —
    no superblock-inverse assembly.  For consumers of the panel-level
    sweeps (:func:`ldlt_solve_panels`, :func:`ldlt_solve_panels_bwd`):
    the blocked-triangular superblock assembly costs g(g-1)/2 small
    batched einsums per superblock, while the panel inverses come from
    one batched log-depth chain.  ``group`` only sets the pad grid."""
    n = A.shape[0]
    assert n > block
    nb = -(-n // block)
    g = max(1, min(int(group), nb))
    npad = -(-nb // g) * g * block
    if rhs is None:
        L, d, panels = ldlt_factor(A, block=block, pad_to=npad,
                                   want_panels=True)
        yf = None
    else:
        L, d, yf, panels = ldlt_factor(A, block=block, rhs=rhs,
                                       pad_to=npad, want_panels=True)
    invp = unit_lower_inverse(panels)        # (npad/block, block, block)
    return (L, d, invp) if yf is None else (L, d, invp, yf)


def ldlt_solve_blocks(L, d, invb, b, block: int = 128):
    """Solve (L diag(d) L^T) x = b via block substitution with the panel
    inverses from :func:`ldlt_factor_blocks` — 2*n^2 MACs of matmuls, no
    triangular_solve custom call.  Accepts L/d already padded to the
    inverse grid (identity tail) and then skips re-materializing the
    padded factor per solve — reg_solve_kkt's hot path solves 3+ times
    per factorization."""
    n = b.shape[0]
    nb = invb.shape[0]
    npad = nb * block
    dtype = L.dtype
    if L.shape[0] == npad:
        Lp, dp = L, d
    else:
        Lp = jnp.zeros((npad, npad), dtype).at[:n, :n].set(L)
        Lp = Lp.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(1.0)
        dp = jnp.zeros((npad,), dtype).at[:n].set(d)
        dp = dp.at[n:].set(1.0)
    bp = jnp.zeros((npad,), dtype).at[:n].set(b)

    def fwd(k, y):
        j0 = k * block
        rowslab = lax.dynamic_slice(Lp, (j0, 0), (block, npad))
        # y fills left-to-right, so columns >= j0 are still exactly zero
        # (and the slab right of the diagonal block is zero in L) — no
        # masked slab copy needed
        acc = rowslab @ y
        bk = lax.dynamic_slice(bp, (j0,), (block,))
        yk = invb[k] @ (bk - acc)
        return lax.dynamic_update_slice(y, yk, (j0,))

    y = lax.fori_loop(0, nb, fwd, jnp.zeros((npad,), dtype))
    safe = jnp.where(jnp.abs(dp) > 0, dp, jnp.ones((), dtype))
    z = y / safe

    x = _bwd_sweep_xla(Lp, z, invb)
    return x[:n]


def _bwd_sweep_xla(Lp, z, invb):
    """Backward superblock sweep as one fori_loop step per superblock;
    ``z`` already diagonal-scaled and padded to (npad,)."""
    nb = invb.shape[0]
    sb = invb.shape[-1]
    npad = Lp.shape[0]
    dtype = Lp.dtype

    def bwd(t, x):
        k = nb - 1 - t
        j0 = k * sb
        colslab = lax.dynamic_slice(Lp, (0, j0), (npad, sb))
        # no row mask needed: x fills top-down, so rows < j0+sb are
        # still exactly zero and self-mask — the r4 form materialized a
        # masked copy of the 20 MB slab every step
        acc = colslab.T @ x
        zk = lax.dynamic_slice(z, (j0,), (sb,))
        xk = invb[k].T @ (zk - acc)
        return lax.dynamic_update_slice(x, xk, (j0,))

    return lax.fori_loop(0, nb, bwd, jnp.zeros((npad,), dtype))


def _bwd_sweep_panels_xla(Lp, z, invp):
    """Backward panel sweep: one fori step per 128-panel."""
    nbp, blk, _ = invp.shape
    npad = Lp.shape[0]

    def bwd(t, x):
        j = nbp - 1 - t
        j0 = j * blk
        colslab = lax.dynamic_slice(Lp, (0, j0), (npad, blk))
        # x fills bottom-up; rows above the diagonal block are zero in L
        # and the diagonal block's rows are zero in x — self-masking
        acc = colslab.T @ x
        zk = lax.dynamic_slice(z, (j0,), (blk,))
        xj = invp[j].T @ (zk - acc)
        return lax.dynamic_update_slice(x, xj, (j0,))

    return lax.fori_loop(0, nbp, bwd, jnp.zeros((npad,), Lp.dtype))


def _fwd_sweep_panels_xla(Lp, invp, b):
    """Forward panel substitution y with L y = b given panel inverses."""
    nbp, blk, _ = invp.shape
    npad = Lp.shape[0]

    def fwd(j, y):
        j0 = j * blk
        rowslab = lax.dynamic_slice(Lp, (j0, 0), (blk, npad))
        acc = rowslab @ y          # y fills left-to-right: self-masking
        bk = lax.dynamic_slice(b, (j0,), (blk,))
        yk = invp[j] @ (bk - acc)
        return lax.dynamic_update_slice(y, yk, (j0,))

    return lax.fori_loop(0, nbp, fwd, jnp.zeros((npad,), Lp.dtype))


def ldlt_solve_panels(Lp, dp, invp, b):
    """Solve (L diag(d) L^T) x = b from panel-grid factors (Lp/dp padded
    to the panel grid, invp the 128-panel inverses).  Used on the rare
    refinement/gate paths of reg_solve_kkt."""
    n = b.shape[0]
    npad = Lp.shape[0]
    dtype = Lp.dtype
    bp = jnp.zeros((npad,), dtype).at[:n].set(b)
    y = _fwd_sweep_panels_xla(Lp, invp, bp)
    safe = jnp.where(jnp.abs(dp) > 0, dp, jnp.ones((), dtype))
    z = y / safe
    return _bwd_sweep_panels_xla(Lp, z, invp)[:n]


def ldlt_solve_panels_bwd(Lp, dp, invp, y):
    """Finish a solve whose forward substitution was folded into the
    factorization: diagonal scale + panel-level backward sweep."""
    npad = Lp.shape[0]
    n = y.shape[0]
    dtype = Lp.dtype
    yp = jnp.zeros((npad,), dtype).at[:n].set(y)
    safe = jnp.where(jnp.abs(dp) > 0, dp, jnp.ones((), dtype))
    z = yp / safe
    return _bwd_sweep_panels_xla(Lp, z, invp)


def ldlt_solve_blocks_bwd(Lp, dp, invb, y):
    """Finish a solve whose FORWARD substitution was folded into the
    factorization (``ldlt_factor_blocks(..., rhs=...)``): diagonal scale
    + the backward block sweep of :func:`ldlt_solve_blocks`.  ``Lp``/
    ``dp`` must already be padded to the superblock grid; ``y`` is the
    (n,) forward-substituted rhs."""
    nb = invb.shape[0]
    sb = invb.shape[-1]
    npad = nb * sb
    n = y.shape[0]
    dtype = Lp.dtype
    yp = jnp.zeros((npad,), dtype).at[:n].set(y)
    safe = jnp.where(jnp.abs(dp) > 0, dp, jnp.ones((), dtype))
    z = yp / safe
    x = _bwd_sweep_xla(Lp, z, invb)
    return x[:n]


def ldlt_solve(L, d, b):
    """Solve (L diag(d) L^T) x = b reusing the factors."""
    dtype = L.dtype
    safe = jnp.where(jnp.abs(d) > 0, d, jnp.ones((), dtype))
    if L.shape[0] <= _TRI_LOOP_MAX and b.ndim == 1:
        # log-depth inverse instead of a 2n-step substitution chain of
        # tiny dependent ops
        return ldlt_solve_inv(L, d, b)
    y = solve_triangular(L, b, lower=True, unit_diagonal=True)
    z = y / safe
    return solve_triangular(L.T, z, lower=False, unit_diagonal=True)


def ldlt_inertia_ok(d, target_neg: int, eps):
    """Inertia/conditioning test on the pivots.

    Mirrors the reference decision (pyipm.py:1379-1381): bad if the matrix is
    ill-conditioned (rcond <= eps, here min|d|/max|d| on the pivots) or the
    number of negative eigenvalues differs from M+N negative pivots."""
    ad = jnp.abs(d)
    finite = jnp.all(jnp.isfinite(d))
    rcond = jnp.min(ad) / jnp.maximum(jnp.max(ad), jnp.finfo(d.dtype).tiny)
    neg = jnp.sum(d < 0)
    return finite & (rcond > eps) & (neg == target_neg)


# ----------------------------------------------------------------------
# inertia-corrected KKT solve
def reg_solve_kkt(
    H,
    g,
    delta,
    mu,
    *,
    nvar: int,
    neq: int,
    nineq: int,
    eps: float,
    reg_coef: float,
    eta: float,
    beta: float,
    delta0: float,
    max_retries: int = 40,
    method: str = "ldlt",
    block: int = 128,
    ir_steps: int = 1,
    want_solver: bool = False,
    group: int = 8,          # panels per superblock; untuned on the H100
):
    """Regularize H for correct inertia and solve H dz = g.

    Replicates ``reghess`` (reference pyipm.py:1373-1406):
      1. If ill-conditioned or inertia != (M+N negative eigenvalues):
         a. ill-conditioned with eq constraints → subtract
            reg_coef*eta*mu^beta*I from the (M,M) zero block
            (pyipm.py:1383-1389);
         b. shift the primal D-block by delta*I, escalating delta*=10 until
            the inertia is correct (pyipm.py:1390-1403); delta warm-starts
            across iterations (halved, floored at delta0, pyipm.py:1395).
      2. Solve the corrected system (pyipm.py:1720-1721).

    Returns (dz, delta_new, n_retries); with ``want_solver=True`` (ldlt
    method only) additionally returns a closure solving further
    right-hand sides against the cached factors (usable within the same
    trace, e.g. for refinement against a larger outer system).
    """
    D, M, N = nvar, neq, nineq
    K = D + 2 * N + M
    dtype = H.dtype
    target = M + N
    idx = jnp.arange(K)
    ex = (idx < D).astype(dtype)                       # primal-block diag mask
    eeq = ((idx >= D + N) & (idx < D + N + M)).astype(dtype)
    eps_ = jnp.asarray(eps, dtype)
    delta0_ = jnp.asarray(delta0, dtype)

    if method == "lu":
        assert not want_solver
        return _reg_solve_eigh(
            H, g, delta, mu, ex=ex, eeq=eeq, target=target, eps=eps_,
            reg_coef=reg_coef, eta=eta, beta=beta, delta0=delta0_,
            max_retries=max_retries, has_eq=M > 0,
        )
    return _reg_solve_ldlt(
        H, g, delta, mu, ex=ex, eeq=eeq, target=target, eps=eps_,
        reg_coef=reg_coef, eta=eta, beta=beta, delta0=delta0_,
        max_retries=max_retries, has_eq=M > 0, block=block,
        ir_steps=ir_steps, want_solver=want_solver, group=group,
    )


def _eq_reg_term(mu, reg_coef, eta, beta, dtype):
    """reg_coef * eta * mu**beta (reference pyipm.py:1388-1389)."""
    mu_ = jnp.asarray(mu, dtype)
    return (
        jnp.asarray(reg_coef, dtype)
        * jnp.asarray(eta, dtype)
        * jnp.power(jnp.maximum(mu_, jnp.zeros((), dtype)),
                    jnp.asarray(beta, dtype))
    )


def _reg_solve_eigh(H, g, delta, mu, *, ex, eeq, target, eps, reg_coef,
                    eta, beta, delta0, max_retries, has_eq):
    """Reference-parity path: eigendecomposition per retry + LU solve."""
    dtype = H.dtype

    def inertia(Hm):
        w = jnp.linalg.eigvalsh(Hm)
        aw = jnp.abs(w)
        rcond = jnp.min(aw) / jnp.maximum(jnp.max(aw), jnp.finfo(dtype).tiny)
        neg = jnp.sum(w < -eps)
        return rcond, neg

    rcond0, neg0 = inertia(H)
    bad = (rcond0 <= eps) | (neg0 != target)

    def fix(args):
        H0, delta_in = args
        if has_eq:
            reg = _eq_reg_term(mu, reg_coef, eta, beta, dtype)
            Hb = jnp.where(rcond0 <= eps, 1.0, 0.0) * (-reg) * jnp.diag(eeq) + H0
        else:
            Hb = H0
        d1 = jnp.where(delta_in == 0, delta0,
                       jnp.maximum(delta_in / 2, delta0))

        def cond_fn(c):
            dlt, neg, t = c
            return (neg != target) & (t < max_retries)

        def body_fn(c):
            dlt, _, t = c
            dlt = dlt * 10.0
            _, neg = inertia(Hb + dlt * jnp.diag(ex))
            return dlt, neg, t + 1

        _, neg1 = inertia(Hb + d1 * jnp.diag(ex))
        d_f, _, t_f = lax.while_loop(cond_fn, body_fn,
                                     (d1, neg1, jnp.zeros((), jnp.int32)))
        return Hb + d_f * jnp.diag(ex), d_f, t_f

    def keep(args):
        H0, delta_in = args
        return H0, delta_in, jnp.zeros((), jnp.int32)

    Hf, delta_new, retries = lax.cond(bad, fix, keep, (H, delta))
    dz = jnp.linalg.solve(Hf, g)
    return dz, delta_new, retries


def ruiz_scale(H, iters: int = 3):
    """Ruiz equilibration: symmetric diagonal scaling d with
    D H D ≈ unit row/col inf-norms (D = diag(d)).

    Congruence preserves inertia (Sylvester), so inertia counting on the
    scaled matrix is exact, while the factorization operates on a matrix
    whose entries span far fewer orders of magnitude — essential in
    float32, where the raw interior-point KKT matrix has Sigma = lda/s
    entries growing like 1/mu near convergence."""
    dtype = H.dtype
    d = jnp.ones((H.shape[0],), dtype)
    Hs = H
    for _ in range(iters):
        r = jnp.sqrt(jnp.max(jnp.abs(Hs), axis=1))
        r = jnp.where(r > 0, r, jnp.ones((), dtype))
        Hs = Hs / r[:, None] / r[None, :]
        d = d / r
    return Hs, d


def _reg_solve_ldlt(H, g, delta, mu, *, ex, eeq, target, eps, reg_coef,
                    eta, beta, delta0, max_retries, has_eq, block,
                    ir_steps=1, want_solver=False, group=8):
    """Fast path: Ruiz-equilibrated LDL^T, one factorization per retry,
    inertia from pivot signs, factors reused for the solve, plus iterative
    refinement in the ORIGINAL (unscaled) coordinates.

    Both tricks exist for float32: equilibration bounds the
    dynamic range the triangular solves see, and each refinement step (two
    matvecs + two cached triangular solves, no refactorization) recovers
    the residual to roundoff when cond*eps < 1.  The refined iterate is
    kept only when it reduces the residual, so refinement cannot
    destabilize a well-conditioned solve.  The delta-shift semantics are
    unchanged from the reference (H + delta*I on the primal block,
    pyipm.py:1390-1403): in scaled coordinates the shift becomes
    delta * diag(d^2) on that block, which is the same matrix congruence.
    """
    dtype = H.dtype
    K = H.shape[0]
    if K <= 128:
        # small systems route through the custom_vmap wrappers so that
        # vmapped (scenario-batched) solves dispatch to the instance-last
        # kernels on CUDA (ops/triton_ldlt.py)
        from pyipm_jax.ops.triton_ldlt import (
            ldlt_factor_small, ldlt_solve_small,
        )

        def factor(Hm):
            return tuple(ldlt_factor_small(Hm))

        def fsolve(facs, rhs):
            return ldlt_solve_small(facs[0], facs[1], rhs)

        main_first_solve = None            # no fwd-fold on the small path
    else:
        # large systems: blocked factorization + block substitution
        # against inverted diagonal blocks (no triangular_solve custom
        # calls; the substitution block size comes from the returned
        # inverse shape).  The MAIN rhs (scaled g, identical across escalation/gate
        # refactorizations) rides the factorization's panel triangular
        # solves — the forward substitution sweep of the first solve
        # costs nothing (rhs_fold is bound after ruiz_scale below,
        # before the first factor() call).  Factor buffers come out
        # ALREADY padded to the grid (identity tail), so the 3+ solves
        # per factorization (main rhs + refinement + gate) never
        # re-materialize a padded copy of the O(K^2) factor.
        if not want_solver:
            # single-shot path: PANEL inverses only.  The superblock-
            # inverse assembly buys nothing here — the main solve is one
            # panel sweep, and refinement/gate solves are behind
            # almost-never-taken lax.conds.
            def factor(Hm):
                L_, d_, invp_, yf_ = ldlt_factor_panels(
                    Hm, block=block, group=group, rhs=rhs_fold)
                return (L_, d_, invp_, yf_)

            def fsolve(facs, rhs):
                return ldlt_solve_panels(facs[0], facs[1], facs[2], rhs)

            def main_first_solve(facs):
                """First solve of the main rhs: backward sweep only
                (forward substitution came folded out of the
                factorization).  The folded rhs facs[3] lives on the
                padded grid (zero tail); slice back to the K real rows."""
                with jax.named_scope("ipm-kkt-solve"):
                    return dsc * ldlt_solve_panels_bwd(
                        facs[0], facs[1], facs[2], facs[3])[:K]
        else:
            # factor-once/solve-many path (ops/condensed.py): ~5 solves
            # per factorization amortize the superblock-inverse assembly
            def factor(Hm):
                L_, d_, invb_, yf_ = ldlt_factor_blocks(
                    Hm, block=block, group=group, rhs=rhs_fold,
                    pad_to_grid=True)
                assert L_.shape[0] == invb_.shape[0] * invb_.shape[-1]
                return (L_, d_, invb_, yf_)

            def fsolve(facs, rhs):
                return ldlt_solve_blocks(facs[0], facs[1], facs[2], rhs,
                                         block=facs[2].shape[-1])

            def main_first_solve(facs):
                """First solve of the main rhs: backward sweep only
                (forward substitution came folded out of the
                factorization).  The folded rhs facs[3] lives on the
                padded grid (zero tail); slice back to the K real rows."""
                with jax.named_scope("ipm-kkt-solve"):
                    return dsc * ldlt_solve_blocks_bwd(
                        facs[0], facs[1], facs[2], facs[3])[:K]

    def pivots(facs):
        # slice off the identity padding tail (large branch pads d to
        # the superblock grid): inertia/rcond must see REAL pivots only
        return facs[1][:K]

    Hs, dsc = ruiz_scale(H)
    shift_diag = (dsc * dsc) * ex       # scaled-space image of diag(ex)
    rhs_fold = dsc * g                  # main rhs in scaled coordinates
    #                                     (folded into large-path factors)

    def scaled_solve(facs, rhs):
        """Solve H_f x = rhs via the scaled factors: x = D y,
        (D H_f D) y = D rhs."""
        with jax.named_scope("ipm-kkt-solve"):
            return dsc * fsolve(facs, dsc * rhs)

    _factor_raw = factor

    def factor(Hm):
        with jax.named_scope("ipm-kkt-factor"):
            return _factor_raw(Hm)

    facs0 = factor(Hs)
    d0 = pivots(facs0)
    # Trigger the regularization machinery as the reference does
    # (pyipm.py:1381): on wrong inertia OR ill-conditioning — but measure
    # conditioning on the RUIZ-SCALED pivots.  The raw interior-point KKT
    # matrix is intrinsically ill-conditioned (cond ~ 1/mu) near
    # convergence even when perfectly solvable, and triggering on that in
    # float32 would delta-shift every late iteration (capping accuracy at
    # delta0 = sqrt(eps) ≈ 3.5e-4 > Ktol); after equilibration, tiny
    # scaled pivots indicate genuine rank deficiency (e.g. a singular
    # equality Jacobian), which is exactly what the eq-block
    # regularization inside the fix branch exists for.
    ok0 = ldlt_inertia_ok(d0, target, eps)

    # Escalation as ONE while_loop seeded with the good factorization —
    # NOT a fix/keep lax.cond around it (the r4 structure).  Two reasons:
    # (a) under vmap (the headline's per-instance condensed solves)
    # lax.cond lowers to select and BOTH branches execute, so every
    # iteration of a healthy batched fleet paid the fix branch's d1
    # refactorization; a while_loop whose cond is false at entry costs
    # one predicate evaluation instead.  (b) the cond shipped the O(K^2)
    # factor buffers through its operand/result boundary.
    if has_eq:
        # conditioning trigger analog of the reference's rcond test:
        # eq-block regularization applies only when the FIRST
        # factorization is both inertia-wrong and ill-conditioned
        ad0 = jnp.abs(d0)
        rcond0 = jnp.min(ad0) / jnp.maximum(jnp.max(ad0),
                                            jnp.finfo(dtype).tiny)
        illcond0 = (~jnp.all(jnp.isfinite(d0))) | (rcond0 <= eps)
        reg = _eq_reg_term(mu, reg_coef, eta, beta, dtype)
        eq_applied = jnp.where((~ok0) & illcond0, reg,
                               jnp.zeros((), dtype))
    else:
        eq_applied = jnp.zeros((), dtype)
    d1 = jnp.where(delta == 0, delta0, jnp.maximum(delta / 2, delta0))

    def esc_cond(c):
        # entry (t == 0) triggers on the full inertia+conditioning test
        # like the reference (pyipm.py:1381); CONTINUATION exits on
        # correct inertia alone (pyipm.py:1399) — exiting on conditioning
        # too would never be met for an intrinsically ill-conditioned KKT
        # system and would escalate delta to overflow.
        dlt, facs_, t = c
        dv = pivots(facs_)
        bad = (~jnp.all(jnp.isfinite(dv))) | (jnp.sum(dv < 0) != target)
        return jnp.where(t == 0, ~ok0, bad) & (t < max_retries)

    def esc_body(c):
        dlt, _, t = c
        dlt = jnp.where(t == 0, d1, dlt * 10.0)
        facs_ = factor(Hs + dlt * jnp.diag(shift_diag)
                       - eq_applied * jnp.diag((dsc * dsc) * eeq))
        return dlt, facs_, t + 1

    d_f, facs, t_esc = lax.while_loop(
        esc_cond, esc_body,
        (jnp.zeros((), dtype), facs0, jnp.zeros((), jnp.int32)))
    fixed = t_esc > 0
    # warm-start delta: the escalated shift where fixing happened, the
    # incoming warm start where the first factorization was kept;
    # retries counts x10 escalations beyond the initial d1 attempt
    # (the r4 fix-branch accounting)
    delta_new = jnp.where(fixed, d_f, delta)
    delta_applied = jnp.where(fixed, d_f, jnp.zeros((), dtype))
    retries = jnp.maximum(t_esc - 1, 0)
    applied_shifts = (delta_applied, eq_applied)

    # skip-refinement threshold: when the unrefined solve's normwise
    # backward error is already below eps^0.75 (f32: ~2e-5, well under
    # the sqrt(eps)~3.5e-4 residual gate), the refinement solve + matvec
    # buy nothing the line search can see — skip them.  eps^0.75 sits a
    # decade-plus above the ~eps backward error of a stable
    # factorization, so the skip fires exactly on the healthy steady
    # state (measured: every bench-config call) while any element-growth
    # pathology still takes the refinement path and then the gate.
    ir_skip_tol = eps ** 0.75
    hnorm_H = jnp.linalg.norm(H)
    tiny_ = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    def solve_refined(facs_, dlt_a, eq_a, rhs, first=None):
        """Cached-factor solve + guarded iterative refinement against the
        SHIFTED system H + dlt_a*diag(ex) - eq_a*diag(eeq), applied as
        O(K) diagonal corrections to the H matvec — the shifted matrix is
        never materialized (r4 built a full K^2 Hf per call).  ``first``
        overrides the initial solve (the fwd-folded backward-only path).
        Returns (solution, final residual norm, norm bound of the
        shifted matrix).  The residual is CARRIED across steps — one
        matvec per step, not two."""
        def mv(y_):
            return H @ y_ + dlt_a * (ex * y_) - eq_a * (eeq * y_)

        # Frobenius bound by triangle inequality — exact enough for the
        # tolerance scales it feeds (skip + gate tests)
        hn = (hnorm_H + dlt_a * jnp.sqrt(jnp.sum(ex))
              + eq_a * jnp.sqrt(jnp.sum(eeq)))
        y = first(facs_) if first is not None else scaled_solve(facs_, rhs)
        r = rhs - mv(y)
        rn = jnp.linalg.norm(r)

        def do_refine(c):
            y, r, rn = c
            for _ in range(max(ir_steps, 1)):
                y_new = y + scaled_solve(facs_, r)
                r_new = rhs - mv(y_new)
                rn_new = jnp.linalg.norm(r_new)
                better = rn_new < rn
                y = jnp.where(better, y_new, y)
                r = jnp.where(better, r_new, r)
                rn = jnp.where(better, rn_new, rn)
            return y, r, rn

        if K > 128:
            # unbatched large path: lax.cond executes ONE branch
            # outside vmap, so the skip really saves the work
            need = rn > ir_skip_tol * (
                hn * jnp.linalg.norm(y) + jnp.linalg.norm(rhs) + tiny_)
            y, r, rn = lax.cond(need, do_refine, lambda c: c, (y, r, rn))
        else:
            # small/batched path (vmapped condensed solves): under vmap
            # cond runs both branches anyway — keep it straight-line
            y, r, rn = do_refine((y, r, rn))
        return y, rn, hn

    dz, rn, Hnorm = solve_refined(facs, delta_applied, eq_applied, g,
                                  first=main_first_solve)

    # ------------------------------------------------------------------
    # Residual gate (adversarial robustness): an UNPIVOTED LDL^T with a
    # nearly-singular leading block can pass the inertia/conditioning
    # tests with finite pivots yet suffer catastrophic element growth —
    # backward error O(eps/pivot^2) instead of O(eps) — producing a
    # direction the line search must then reject.  Detect it from the
    # normwise backward error of the refined solve and escalate the
    # primal-block shift (the reference's own remedy space, reghess
    # pyipm.py:1390-1403): delta ~ sqrt(eps)*|H| bounds the growth at the
    # tiny pivot.  Never triggers on stable factorizations (backward
    # error ~ eps << sqrt(eps) even for ill-conditioned KKT systems).
    gate_tol = jnp.sqrt(eps)
    eq_applied0 = applied_shifts[1]

    def backward_err(rn_, dz_):
        return rn_ / (Hnorm * jnp.linalg.norm(dz_)
                      + jnp.linalg.norm(g) + tiny_)

    def gate_cond(c):
        dlt, _, dz_, rn_, t = c
        return (backward_err(rn_, dz_) > gate_tol) & (t < max_retries)

    def gate_body(c):
        dlt, facs_, dz_, rn_, t = c
        dlt = jnp.where(dlt == 0, delta0, dlt) * 10.0
        f_new = factor(Hs + dlt * jnp.diag(shift_diag)
                       - eq_applied0 * jnp.diag((dsc * dsc) * eeq))
        dz_new, rn_new, _ = solve_refined(f_new, dlt, eq_applied0, g,
                                          first=main_first_solve)
        return dlt, f_new, dz_new, rn_new, t + 1

    if want_solver:
        d_gate, facs, dz, rn, t_gate = lax.while_loop(
            gate_cond, gate_body,
            (applied_shifts[0], facs, dz, rn,
             jnp.zeros((), jnp.int32)))
        gated = t_gate > 0
        delta_new = jnp.where(gated, d_gate, delta_new)
        retries = retries + t_gate
        applied_shifts = (jnp.where(gated, d_gate, applied_shifts[0]),
                          eq_applied0)

        def apply_factors(rhs):
            return scaled_solve(facs, rhs)

        # applied_shifts = (delta actually added to the primal block,
        # eq-reg actually subtracted from the eq block) — needed by callers
        # refining against the regularized system (ops/condensed.py)
        return dz, delta_new, retries, apply_factors, applied_shifts

    # want_solver=False: the gate almost never fires (backward error ~eps
    # for stable factorizations), but a bare while_loop would still carry
    # the O(K^2) factor buffers through its boundary on every call.  Put
    # the whole escalation loop behind a scalar lax.cond so the common
    # path's only extra cost is the backward-error test itself.
    def run_gate(_):
        d_g, _f, dz_g, _rn, t_g = lax.while_loop(
            gate_cond, gate_body,
            (applied_shifts[0], facs, dz, rn,
             jnp.zeros((), jnp.int32)))
        return dz_g, d_g, t_g

    def skip_gate(_):
        return dz, applied_shifts[0], jnp.zeros((), jnp.int32)

    need_gate = backward_err(rn, dz) > gate_tol
    dz, d_gate, t_gate = lax.cond(need_gate, run_gate, skip_gate, None)
    gated = t_gate > 0
    delta_new = jnp.where(gated, d_gate, delta_new)
    retries = retries + t_gate
    return dz, delta_new, retries


# ----------------------------------------------------------------------
def batched_reg_factor(H, delta, mu, *, neq: int, eps: float,
                       reg_coef: float, eta: float, beta: float,
                       delta0: float, max_retries: int = 40,
                       block: int = 128):
    """Batched inertia-corrected LDL^T factorization — the per-block form
    of :func:`_reg_solve_ldlt`'s factor phase, used by the distributed
    Schur path (parallel/schur.py) on its (B, n, n) per-block condensed
    KKT systems (layout [x-block (n-neq); eq-block (neq)], target inertia
    = ``neq`` negative pivots; see ops/condensed.py).

    Semantics per block mirror the reference's reghess decision-for-
    decision (reference pyipm.py:1373-1406): Ruiz equilibration, pivot-sign
    inertia, eq-block regularization on ill-conditioning, per-block
    delta-escalation (x10) with warm-started ``delta`` (B,) carried across
    iterations.  Blocks whose first factorization already has correct
    inertia keep it — the escalation loop only replaces factors of bad
    blocks.

    Returns ``(solve_fn, delta_new, retries, applied)``:
      solve_fn(Bc (B, n, r)) -> (B, n, r) multi-rhs solve against the
        cached factors in ORIGINAL (unscaled) coordinates;
      delta_new (B,) warm-start shifts; retries () i32 escalation count;
      applied = (delta_applied (B,), eq_applied (B,)) — the shifts
        actually in the factored matrices, for callers refining against
        the regularized system (the same contract as reg_solve_kkt's
        ``want_solver`` path).
    """
    Bn, n, _ = H.shape
    dtype = H.dtype
    d = n - neq
    idx = jnp.arange(n)
    ex = (idx < d).astype(dtype)
    eeq = (idx >= d).astype(dtype)
    eps_ = jnp.asarray(eps, dtype)
    delta0_ = jnp.asarray(delta0, dtype)
    tiny = jnp.finfo(dtype).tiny

    Hs, dsc = jax.vmap(ruiz_scale)(H)                    # (B,n,n), (B,n)
    shift_diag = (dsc * dsc) * ex[None, :]               # (B, n)
    eq_diag = (dsc * dsc) * eeq[None, :]

    if n <= 128:
        # batched small blocks: small-system factorization + ONE
        # log-depth inverse per factorization reused by every multi-rhs
        # solve — main rhs + border columns + refinement + SOC, ~5 solves
        # per factorization (the inverse is ~2 log2(n) tiny matmuls here)
        from pyipm_jax.ops.triton_ldlt import ldlt_factor_small

        def factor(Hm):                                  # (B,n,n)
            L, dv = jax.vmap(ldlt_factor_small)(Hm)
            Linv = unit_lower_inverse(L)
            return L, dv, Linv

        def fsolve(facs, Bc):                            # (B,n,r)
            _, dv, Linv = facs
            safe = jnp.where(jnp.abs(dv) > 0, dv, jnp.ones((), dtype))
            y = jnp.einsum("bij,bjr->bir", Linv, Bc)
            z = y / safe[..., None]
            return jnp.einsum("bji,bjr->bir", Linv, z)
    elif n <= 512:
        # batched mid blocks: statically-unrolled panel factorization
        # whose panel inverses feed block forward/backward substitution,
        # without a whole-matrix log-depth inverse's ~2 log2(n) full-size
        # matmuls per factorization.  _PANEL and the n <= 128 / n <= 512
        # switches were set for another accelerator and are untuned on
        # the H100.
        _PANEL = 32

        def factor(Hm):
            return ldlt_factor_unrolled(Hm, panel=_PANEL,
                                        want_panel_inv=True)

        def fsolve(facs, Bc):
            L, dv, invb = facs
            return ldlt_solve_unrolled_blocks(L, dv, invb, Bc,
                                              panel=_PANEL)
    else:
        # large blocks: bounded-compile-size blocked factorization under
        # vmap + batched triangular solves (the n^2 inverse would cost
        # ~log2(n) extra factorizations here)
        def factor(Hm):
            L, dv = jax.vmap(lambda A: ldlt_factor(A, block=block))(Hm)
            return L, dv

        def fsolve(facs, Bc):
            L, dv = facs
            safe = jnp.where(jnp.abs(dv) > 0, dv, jnp.ones((), dtype))
            y = solve_triangular(L, Bc, lower=True, unit_diagonal=True)
            z = y / safe[..., None]
            return solve_triangular(
                jnp.swapaxes(L, -1, -2), z, lower=False,
                unit_diagonal=True)

    def pivots(facs):
        return facs[1]

    def inertia_ok(dv):                                  # (B, n) -> (B,)
        ad = jnp.abs(dv)
        finite = jnp.all(jnp.isfinite(dv), axis=-1)
        rcond = (jnp.min(ad, axis=-1)
                 / jnp.maximum(jnp.max(ad, axis=-1), tiny))
        neg = jnp.sum(dv < 0, axis=-1)
        return finite & (rcond > eps_) & (neg == neq)

    def tree_where(mask, a, b):
        return jax.tree.map(
            lambda u, v: jnp.where(
                mask.reshape((-1,) + (1,) * (u.ndim - 1)), u, v), a, b)

    def shift_ok(dv):
        """Escalation-loop exit test: correct inertia + finite pivots
        ALONE, like the single-device loop (see _reg_solve_ldlt cond_fn:
        exiting on conditioning as well would never be met for a
        genuinely rank-deficient block and would escalate delta to
        overflow, 40 wasted factorizations per iteration)."""
        finite = jnp.all(jnp.isfinite(dv), axis=-1)
        return finite & (jnp.sum(dv < 0, axis=-1) == neq)

    facs0 = factor(Hs)
    ok0 = inertia_ok(pivots(facs0))
    zero_b = jnp.zeros((Bn,), dtype)

    def fix(_):
        if neq:
            dv0 = pivots(facs0)
            ad0 = jnp.abs(dv0)
            rcond0 = (jnp.min(ad0, axis=-1)
                      / jnp.maximum(jnp.max(ad0, axis=-1), tiny))
            illcond = ((~jnp.all(jnp.isfinite(dv0), axis=-1))
                       | (rcond0 <= eps_))
            reg = _eq_reg_term(mu, reg_coef, eta, beta, dtype)
            eq_shift = jnp.where((~ok0) & illcond, reg, zero_b)  # (B,)
        else:
            eq_shift = zero_b
        Hb = Hs - eq_shift[:, None, None] * jax.vmap(jnp.diag)(eq_diag)

        # per-block warm-started entry shift, only where inertia is wrong
        d1 = jnp.where(~ok0,
                       jnp.where(delta == 0, delta0_,
                                 jnp.maximum(delta / 2, delta0_)),
                       zero_b)

        def shifted(dlt):
            return Hb + dlt[:, None, None] * jax.vmap(jnp.diag)(shift_diag)

        facs1 = factor(shifted(d1))
        facs1 = tree_where(ok0, facs0, facs1)  # good blocks keep factors
        bad1 = (~ok0) & (~shift_ok(pivots(facs1)))

        def cond_fn(c):
            _, _, bad, t = c
            return jnp.any(bad) & (t < max_retries)

        def body_fn(c):
            dlt, facs, bad, t = c
            dlt = jnp.where(bad, dlt * 10.0, dlt)
            newfacs = factor(shifted(dlt))
            facs = tree_where(bad, newfacs, facs)
            bad = bad & (~shift_ok(pivots(facs)))
            return dlt, facs, bad, t + 1

        d_f, facs, _, retries = lax.while_loop(
            cond_fn, body_fn, (d1, facs1, bad1, jnp.zeros((), jnp.int32)))

        # warm start carries forward; applied shift is d_f where fixed,
        # 0 where the first factorization was kept
        delta_new = jnp.where(ok0, delta, d_f)
        delta_applied = jnp.where(ok0, zero_b, d_f)
        return facs, delta_new, delta_applied, eq_shift, retries

    def keep(_):
        return (facs0, delta, zero_b, zero_b, jnp.zeros((), jnp.int32))

    # skip the entire retry phase when every block's first factorization
    # already has correct inertia (the steady state of a converging
    # solve) — the single-device lax.cond(~ok0, fix, keep) behavior
    facs, delta_new, delta_applied, eq_shift, retries = lax.cond(
        jnp.any(~ok0), fix, keep, None)

    def solve_fn(Bc):
        # original coordinates: x = D (scaled_solve(D rhs)), batched
        return dsc[..., None] * fsolve(facs, dsc[..., None] * Bc)

    return solve_fn, delta_new, retries, (delta_applied, eq_shift)


# ----------------------------------------------------------------------
# misc
def lstsq_minnorm(A, b):
    """Minimum-norm least-squares solve (reference fallback at
    pyipm.py:1477, 1529 via ``np.linalg.lstsq``).

    Implemented via lightly-regularized normal equations instead of SVD:
    under vmap, ``lax.cond`` evaluates both branches, so the second-order
    correction path executes every iteration for the whole batch — an SVD
    there would dominate the step cost, while this is two matmuls and a
    small dense solve.  The Tikhonov term keeps the solve
    defined for rank-deficient Jacobians (where the reference's lstsq
    returns the min-norm solution; ours is within O(sqrt(eps)) of it)."""
    m, n = A.shape
    dtype = A.dtype
    reg = jnp.sqrt(jnp.finfo(dtype).eps)

    def sym_solver(G):
        """Factor once, solve many — the refinement step reuses the
        factors, so the SPD factorization cost is paid ONCE per lstsq
        (this path executes every batched iteration: under vmap the SOC's
        lax.cond runs both branches).  jnp.linalg.solve lowers to a
        batched-LU custom call whose sequential pivot loop dominated
        whole-solver profiles; route small systems through the unrolled LDL^T + log-depth-inverse
        path."""
        k = G.shape[0]
        if k > 128:
            lu, piv = jax.scipy.linalg.lu_factor(G)
            return lambda rhs: jax.scipy.linalg.lu_solve((lu, piv), rhs)
        from pyipm_jax.ops.triton_ldlt import (
            ldlt_factor_small, ldlt_solve_small,
        )
        L, dv = ldlt_factor_small(G)
        return lambda rhs: ldlt_solve_small(L, dv, rhs)

    def reg_solve(G, rhs, k):
        """(G + reg*s*I)^{-1} rhs with GUARDED refinement: the Tikhonov
        term biases the solution by O(reg/eig_min) relative; each
        refinement step against the UNregularized G contracts that bias by
        reg/(eig_min+reg), so a few steps recover even moderately
        ill-conditioned systems (each step is three matvecs against the
        hoisted factors — the factorization is paid once).  On
        rank-deficient G with inconsistent rhs the correction explodes
        along null(G) (amplified by 1/reg), so each refined iterate is
        kept only where it reduces ||G y - rhs|| — the deficient case
        keeps the stable biased solution, whose deviation from the
        reference's exact min-norm lstsq stays O(sqrt(eps)) (bounded by
        tests/test_components.py)."""
        scale = jnp.maximum(jnp.trace(G) / k, jnp.ones((), dtype))
        Greg = G + reg * scale * jnp.eye(k, dtype=dtype)
        solve = sym_solver(Greg)
        y = solve(rhs)
        r = rhs - G @ y
        rn = jnp.linalg.norm(r)

        # The residual is CARRIED between steps (one matvec per step, not
        # two), and a rejected step ends the loop: with y/r unchanged the
        # next step would deterministically recompute and reject the
        # identical candidate, so ``stalled`` exits instead of wasting
        # solve+matvec work — this runs every batched SOC iteration (under
        # vmap lax.cond takes both branches).
        def cond_fn(c):
            i, _, _, _, stalled = c
            return (i < 3) & ~stalled

        def body_fn(c):
            i, y, r, rn, _ = c
            y1 = y + solve(r)
            r1 = rhs - G @ y1
            rn1 = jnp.linalg.norm(r1)
            better = rn1 < rn
            y = jnp.where(better, y1, y)
            r = jnp.where(better, r1, r)
            rn = jnp.where(better, rn1, rn)
            return i + 1, y, r, rn, ~better

        _, y, _, _, _ = lax.while_loop(
            cond_fn, body_fn,
            (jnp.zeros((), jnp.int32), y, r, rn,
             jnp.zeros((), jnp.bool_)))
        return y

    if m <= n:
        # underdetermined: x = A^T (A A^T + reg*s*I)^{-1} b
        x = A.T @ reg_solve(A @ A.T, b, m)
    else:
        # overdetermined: x = (A^T A + reg*s*I)^{-1} A^T b
        x = reg_solve(A.T @ A, A.T @ b, n)
    return x
