"""Batched dense linear algebra (the Cholesky hot path).

`cholesky_batched` exists for backends whose `jnp.linalg.cholesky`
factors a batch of matrices one after another.  XLA's GPU Cholesky does
not: on an H100 (700 W) it is the faster of the two — 0.62 ms against
4.6 ms at [64, 256, 256] and 1.9 ms against 6.7 ms at [1024, 256, 256]
(PERF.md).  Whether `cholesky` should keep dispatching here at all is an
open ROADMAP item; this module is unchanged until that is decided.

`cholesky_batched` is a right-looking PANEL algorithm expressed in plain
XLA ops so every step is batch-parallel:

  - the [b, r, r] diagonal block factors via a masked `lax.scan` over r
    column steps (each step is [b, r]/[b, r, r] elementwise work across
    the WHOLE batch — no per-matrix loop);
  - the panel below solves against the diagonal factor with
    `triangular_solve`;
  - the trailing update A22 -= L21 L21ᵀ is a batched matmul.

tests/test_linalg.py holds the agreement battery: random PSD batches,
f64 reference, jitter edge cases.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _chol_unblocked(A):
    """Batched unblocked Cholesky of [b, r, r] via a masked column scan.

    Each of the r steps normalizes column j across the whole batch and
    applies the rank-1 trailing update to columns > j (masked full-width
    ops — no dynamic shapes).  Rows above the diagonal of the returned
    factor are zero.
    """
    r = A.shape[-1]
    idx = jnp.arange(r)

    def step(A, j):
        dj = jnp.take_along_axis(
            jnp.diagonal(A, axis1=-2, axis2=-1), j[None, None], axis=-1
        )[..., 0]                                    # [b] A[:, j, j]
        # non-positive pivot -> sqrt(neg) = NaN, propagating like XLA's
        # cholesky (consumers' NaN-retry logic depends on this)
        col = jnp.take_along_axis(A, j[None, None, None], axis=-1)[..., 0]
        col = col / jnp.sqrt(dj)[:, None]            # [b, r]
        col = jnp.where(idx[None, :] >= j, col, 0.0)
        upd = col[:, :, None] * col[:, None, :]      # [b, r, r]
        # jnp.where (not *mask): NaN * 0 = NaN would leak into the
        # already-factored region
        A = A - jnp.where(idx[None, None, :] > j, upd, 0.0)
        return A, col

    _, cols = lax.scan(step, A, jnp.arange(r))
    return jnp.moveaxis(cols, 0, -1)                 # columns j -> [b, r, r]


@partial(jax.jit, static_argnames=("panel",))
def cholesky_batched(M, panel: int = 64):
    """Lower-triangular Cholesky factor of a batch of PSD matrices.

    M: [..., D, D] (any leading batch shape).  Matches
    `jnp.linalg.cholesky` to f32 tolerance, including NaN propagation on
    non-PSD input.  D that doesn't divide by `panel` pads with an
    identity block (factored exactly, then sliced away).
    """
    batch_shape = M.shape[:-2]
    D = M.shape[-1]
    A = M.reshape((-1, D, D))
    if D <= panel:
        return _chol_unblocked(A).reshape(M.shape)

    if D % panel:
        pad = panel - D % panel
        eye_pad = jnp.zeros((A.shape[0], D + pad, D + pad), A.dtype)
        eye_pad = eye_pad.at[:, :D, :D].set(A)
        eye_pad = eye_pad.at[:, D:, D:].set(
            jnp.eye(pad, dtype=A.dtype)[None]
        )
        L = cholesky_batched(eye_pad, panel=panel)[:, :D, :D]
        return L.reshape(M.shape)
    b = A.shape[0]
    out_panels = []
    for p in range(0, D, panel):
        diag = A[:, p:p + panel, p:p + panel]
        L11 = _chol_unblocked(diag)
        below = A[:, p + panel:, p:p + panel]        # [b, D-p-r, r]
        # L21 solves L21 @ L11ᵀ = A21
        L21 = lax.linalg.triangular_solve(
            L11, below, left_side=False, lower=True, transpose_a=True,
        )
        # trailing update: A22 -= L21 @ L21ᵀ  (batched matmul; f32
        # precision — the result feeds further factorization steps and
        # reduced-precision drift here compounds into the trailing panels)
        if p + panel < D:
            A22 = A[:, p + panel:, p + panel:]
            A22 = A22 - jnp.einsum(
                "bij,bkj->bik", L21, L21, precision="float32"
            )
            A = A.at[:, p + panel:, p + panel:].set(A22)
        col = jnp.concatenate(
            [jnp.zeros((b, p, panel), A.dtype), L11, L21], axis=1
        )
        out_panels.append(col)
    L = jnp.concatenate(out_panels, axis=-1)
    # zero the strict upper triangle via where (a *mask product would
    # turn a propagating NaN times zero into NaN above the diagonal,
    # where XLA's cholesky keeps exact zeros)
    i = jnp.arange(D)
    L = jnp.where((i[:, None] >= i[None, :])[None], L, 0.0)
    return L.reshape(M.shape)


def cholesky(M, panel: int = 64):
    """Size-dispatching Cholesky: the blocked batch algorithm for large
    batch x dim products, XLA's native path for small problems (where
    LAPACK-style custom calls are already fast, e.g. the CPU test tier).
    See the module docstring for how the two compare on the H100."""
    import numpy as _np

    D = M.shape[-1]
    b = int(_np.prod(M.shape[:-2], dtype=_np.int64)) if M.ndim > 2 else 1
    if D < 32 or b * D < 2048:
        return jnp.linalg.cholesky(M)
    return cholesky_batched(M, panel=panel)
