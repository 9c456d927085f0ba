"""Fused Gaussian cluster assignment (the blocked-Gibbs hot op), Pallas/Triton.

No reference analog (the reference's hot loop is scalar C++ virtual
dispatch, SURVEY.md §3.2).  For every row n it draws

    z_n = argmax_k [ base_k − ½‖(x_n − μ_k) B_kᵀ‖² + G_nk ]

i.e. a categorical sample over K Gaussian clusters by the Gumbel-max
trick, with the Gumbel noise G drawn outside by `jax.random.gumbel`.  The
plain XLA version (`gaussian_assign_reference`, equivalently
`niw.logpdf_batch` + argmax) writes and re-reads an [N, D] product for
each of the K clusters.  This kernel keeps that product on chip:

  - the grid runs over row blocks only; the loop over the K clusters runs
    inside the block, with the running (max, argmax) carried in registers;
  - for each cluster, y = (x − μ_k) B_kᵀ is accumulated over contraction
    chunks of D and output panels of B_k, so a full [D, D] B_k (256 KB at
    D = 256) never has to sit in shared memory at once; ‖y‖² is reduced
    per panel and y is never stored;
  - the whole of `binv` ([K, D, D], 16.8 MB at K = 64, D = 256) fits in
    the 50 MB L2, so every row block re-reads it from L2, not HBM.

HBM traffic ≈ read X and the [N, K] noise once, write z once.

Precision: the in-kernel dot runs in TF32 (`allow_tf32=True`), the same
precision XLA gives the plain version's default-precision f32 matmul on
the GPU.  ‖y‖² is a sum of squares with no cancellation, so the TF32
input rounding (~5e-4 relative) moves a well-separated row's score by far
less than its margin.

Inputs (precomputed in XLA from the likelihood's posterior draws):
  X      [N, D]     rows
  mu     [K, D]     cluster means
  binv   [K, D, D]  B_k = L_k^{-1} with L_k = chol(Σ_k): ‖(x−μ)Bᵀ‖² is the
                    Mahalanobis quadratic form
  base   [K]        log w_k − ½ log|Σ_k| − d/2 log 2π  (+ any extra logits)
  gumbel [N, K]     standard Gumbel noise

Returns z [N] int32.  `interpret=True` runs the same kernel through the
Pallas interpreter (CPU tests).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_N = 128  # rows per block


def _block_config(d_pad: int):
    """(output panel, contraction chunk, num_warps, num_stages) for a padded D.

    The [BLOCK_N, panel] f32 accumulator lives in registers (128 per
    thread at D = 256 with 8 warps); one pipeline stage holds a
    [BLOCK_N, chunk] row chunk and a [panel, chunk] slice of B_k in shared
    memory (64 KB at D = 256), so three stages fit in the 227 KB a block
    may use.
    """
    panel = min(d_pad, 256)
    chunk = min(d_pad, 32)
    num_warps = 8 if d_pad >= 128 else 4
    return panel, chunk, num_warps, 3


def _assign_kernel(x_ref, mu_ref, binv_ref, base_ref, g_ref, z_ref, *,
                   n_rows, n_clusters, panel, chunk):
    d_pad = x_ref.shape[1]
    row0 = pl.program_id(0) * BLOCK_N
    rows = row0 + jnp.arange(BLOCK_N)
    valid = rows < n_rows

    def cluster(k, carry):
        best, arg = carry
        quad = jnp.zeros((BLOCK_N,), jnp.float32)
        for p0 in range(0, d_pad, panel):

            def contract(q, acc):
                q0 = pl.multiple_of(q * chunk, chunk)
                x = plgpu.load(
                    x_ref.at[pl.ds(row0, BLOCK_N), pl.ds(q0, chunk)],
                    mask=valid[:, None], other=0.0,
                )
                dev = x - mu_ref[k, pl.ds(q0, chunk)][None, :]
                b = binv_ref[k, pl.ds(p0, panel), pl.ds(q0, chunk)]
                return acc + pl.dot(dev, b, trans_b=True, allow_tf32=True)

            y = jax.lax.fori_loop(
                0, d_pad // chunk, contract,
                jnp.zeros((BLOCK_N, panel), jnp.float32),
            )
            quad = quad + jnp.sum(y * y, axis=1)
        g = plgpu.load(g_ref.at[k, pl.ds(row0, BLOCK_N)], mask=valid,
                       other=0.0)
        lp = base_ref[k] - 0.5 * quad + g
        take = lp > best
        return jnp.where(take, lp, best), jnp.where(take, k, arg)

    best0 = jnp.full((BLOCK_N,), -jnp.inf, jnp.float32)
    arg0 = jnp.zeros((BLOCK_N,), jnp.int32)
    _, arg = jax.lax.fori_loop(0, n_clusters, cluster, (best0, arg0))
    plgpu.store(z_ref.at[pl.ds(row0, BLOCK_N)], arg, mask=valid)


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


@partial(jax.jit, static_argnames=("interpret",))
def fused_gaussian_assign(X, mu, binv, base, gumbel, interpret: bool = False):
    """Sample z_n ~ Cat(softmax_k(base_k − ½ Mahalanobis²)) for all rows.

    Same draw as `gaussian_assign_reference(X, mu, binv, base, gumbel)`,
    row for row up to ties and the stated precision.  D is zero-padded to
    a power of two of at least 16 (Triton's dot operand minimum); padded
    columns add nothing to ‖y‖².  N and K need no padding: the last row
    block is masked and the cluster loop runs exactly K times.
    """
    n, d = X.shape
    k = mu.shape[0]
    d_pad = _pow2_at_least(d, 16)
    X = jnp.asarray(X, jnp.float32)
    mu = jnp.asarray(mu, jnp.float32)
    binv = jnp.asarray(binv, jnp.float32)
    if d_pad != d:
        X = jnp.pad(X, ((0, 0), (0, d_pad - d)))
        mu = jnp.pad(mu, ((0, 0), (0, d_pad - d)))
        binv = jnp.pad(binv, ((0, 0), (0, d_pad - d), (0, d_pad - d)))
    panel, chunk, num_warps, num_stages = _block_config(d_pad)
    kernel = partial(_assign_kernel, n_rows=n, n_clusters=k, panel=panel,
                     chunk=chunk)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n,), jnp.int32),
        grid=(pl.cdiv(n, BLOCK_N),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="fused_gaussian_assign",
    )(
        X, mu, binv,
        jnp.asarray(base, jnp.float32),
        # [K, N]: the block reads one contiguous row run per cluster
        jnp.asarray(gumbel, jnp.float32).T,
    )


@jax.jit
def gaussian_assign_reference(X, mu, binv, base, gumbel):
    """Plain XLA version of the same draw: the [N, K] score table from a scan
    of per-cluster matmuls (peak memory [N, D] + [N, K], like
    niw.logpdf_batch), plus the given Gumbel noise, then argmax."""

    def per_cluster(_, mb):
        mu_k, binv_k, base_k = mb
        y = (X - mu_k) @ binv_k.T
        return None, base_k - 0.5 * jnp.sum(y * y, axis=-1)

    _, cols = jax.lax.scan(per_cluster, None, (mu, binv, base))  # [K, N]
    return jnp.argmax(cols.T + gumbel, axis=-1).astype(jnp.int32)
