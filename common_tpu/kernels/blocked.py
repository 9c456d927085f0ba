"""Blocked (uncollapsed) Gibbs — the data-parallel sweep kernel.

No reference analog: the reference's only assignment kernel is the
sequential collapsed Gibbs loop (kernels:gibbs.pyx).  This kernel is the
accelerator performance path promised in SURVEY.md §7: a truncated
stick-breaking DP mixture (Ishwaran & James blocked Gibbs; cf. the
parallel-DP literature in PAPERS.md) in which *every row is resampled in
parallel*:

  1. θ_k ~ p(θ | stats_k)      posterior draws for all K slots at once
                               (empty slots draw from the prior — exactly
                               what truncation requires);
  2. stick weights             v_k ~ Beta(1 + n_k, α + Σ_{j>k} n_j),
                               log w = log v + cumΣ log(1−v)  (CRP analog);
                               fixed-K: w ~ Dirichlet(α + n);
  3. score                     [N, K] log-lik table via `logpdf_batch`
                               (matmul-formulated per likelihood);
  4. assign                    per-row Gumbel-argmax categorical draws;
  5. restat                    counts + suffstats rebuilt by segment-sums /
                               per-cluster matmuls (`stats_from_assignments`).

Steps 3–5 are O(N·K·F) *parallel* work with zero sequential dependence —
this is what scales to 1M rows and shards over a device mesh
(parallel/sharded.py).  Validated against the exact-enumeration oracle
(truncation error is negligible for K_max ≫ E[K⁺]).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from common_tpu import state as state_mod
from common_tpu.likelihoods.niw import scatter_product
from common_tpu.state import MixtureState


def stick_break_log_weights(key, counts, alpha):
    """log mixture weights from a truncated stick-breaking posterior draw.

    v_k ~ Beta(1 + n_k, α + Σ_{j>k} n_j); the last stick takes the rest
    (ensures Σ w = 1 under truncation).
    """
    counts = counts.astype(jnp.float32)
    k = counts.shape[-1]
    total_after = jnp.cumsum(counts[::-1])[::-1] - counts  # Σ_{j>k} n_j
    v = jax.random.beta(key, 1.0 + counts, alpha + total_after)
    v = jnp.clip(v, 1e-7, 1.0 - 1e-7)
    logv = jnp.log(v)
    log1mv = jnp.log1p(-v)
    cum = jnp.concatenate([jnp.zeros_like(log1mv[:1]), jnp.cumsum(log1mv[:-1])])
    logw = logv + cum
    # final stick absorbs the remainder: w_K = Π (1 - v_j), j < K
    logw = logw.at[k - 1].set(jnp.sum(log1mv[:-1]))
    return logw


def dirichlet_log_weights(key, counts, alphas):
    """Fixed-K: log w with w ~ Dirichlet(α + n) (blocked finite mixture)."""
    w = jax.random.dirichlet(key, alphas + counts.astype(jnp.float32))
    return jnp.log(jnp.clip(w, 1e-30))


def sweep_parts(state: MixtureState, data, key):
    """The (θ, log w, [N,K] log-lik) pieces of one blocked sweep.

    Factored out so the sharded multi-chip path (parallel/sharded.py) can
    reuse the exact same math with its own reduction placement.
    """
    kth, kv = jax.random.split(key)
    liks = state.likelihoods()

    thetas = [
        lik.sample_params(jax.random.fold_in(kth, f), hyper, stats_f)
        for f, (lik, hyper, stats_f) in enumerate(
            zip(liks, state.hypers, state.stats)
        )
    ]
    if state.fixed:
        logw = dirichlet_log_weights(
            kv, state.counts, state.cluster_hp["alphas"]
        )
    else:
        logw = stick_break_log_weights(
            kv, state.counts, state.cluster_hp["alpha"].astype(jnp.float32)
        )

    def loglik_table(data_cols):
        ll = jnp.zeros((), jnp.float32)
        for (x, mask), lik, th in zip(data_cols, liks, thetas):
            ll = ll + lik.logpdf_batch(th, x, jnp.asarray(mask, jnp.float32))
        return ll

    return thetas, logw, loglik_table


@jax.jit
def sweep(state: MixtureState, data, key) -> MixtureState:
    """One full blocked-Gibbs sweep: all rows reassigned in parallel."""
    thetas, logw, loglik_table = sweep_parts(state, data, key)
    logp = logw[None, :] + loglik_table(data)  # [N, K]

    kz = jax.random.fold_in(key, 2)
    g = jax.random.gumbel(kz, logp.shape, logp.dtype)
    z = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)

    return restat(state, data, z, thetas)


def restat(state: MixtureState, data, z, thetas=None) -> MixtureState:
    """Rebuild counts + suffstats from a full assignment vector.

    thetas: optional per-feature explicit parameter draws to persist into
    latent stat leaves (bbnc's p) so subsequent collapsed-style scoring
    sees the current latents.
    """
    K = state.k_max
    counts = jax.ops.segment_sum(
        jnp.ones_like(z), z, num_segments=K
    ).astype(jnp.int32)
    new_stats = []
    for f, ((x, mask), lik, hyper, stats_f) in enumerate(
        zip(data, state.likelihoods(), state.hypers, state.stats)
    ):
        s = lik.stats_from_assignments(hyper, x, mask, z, K)
        if thetas is not None and lik.latent_leaves:
            s = {
                k: (thetas[f][k] if k in lik.latent_leaves else s[k])
                for k in s
            }
        new_stats.append(s)
    return dataclasses.replace(
        state, assignments=z, counts=counts, stats=tuple(new_stats)
    )


def assign(state: MixtureState, data, key) -> MixtureState:
    """Runner-kernel alias ('assign_blocked')."""
    return sweep(state, data, key)


# ---------------------------------------------------------------------------
# multi-chain sweep: the chain axis folded into the matmul K-dimension
# ---------------------------------------------------------------------------
def _chain_score_table(mu, prec, logdet, logw, x):
    """[N, C, K] blocked-Gibbs score table for C chains sharing one X.

    The vmapped per-chain path issues C·K small [N, D] @ [D, D] matmuls,
    which at small D (D = K = 16) keep the matrix units nearly idle.  Here
    the Gaussian quadratic form is EXPANDED,
        −½(x−μ)ᵀP(x−μ) = −½ xᵀPx + xᵀPμ − ½ μᵀPμ,    P = Σ⁻¹,
    so scoring all C·K clusters is two WIDE matmuls against shared
    row features:  XX @ Pᵀ  with XX = [N, D²] the once-per-call outer-
    product features, and  X @ Qᵀ  — K-dimension C·K instead of C
    separate scans.  precision="float32" on both: the expansion has a
    genuine cancellation (xᵀPx ≈ μᵀPμ for tight clusters) that a reduced-
    precision (TF32 or bf16) matmul amplifies into logp errors.

    mu [C, K, D], prec [C, K, D, D], logdet [C, K] (log|Sigma|) — the
    layout `sample_params_prec` returns (vmapped over chains).
    """
    C, K, D = mu.shape
    P = prec.reshape(C * K, D, D)
    q = jnp.einsum(
        "mde,me->md", P, mu.reshape(C * K, D), precision="float32"
    )                                                     # Σ⁻¹μ [CK, D]
    r = jnp.sum(q * mu.reshape(C * K, D), axis=-1)        # μᵀΣ⁻¹μ [CK]
    base = (
        logw.reshape(C * K)
        - 0.5 * logdet.reshape(C * K)
        - 0.5 * D * jnp.log(2.0 * jnp.pi)
        - 0.5 * r
    )

    xx = jnp.einsum("nd,ne->nde", x, x).reshape(-1, D * D)  # [N, D²]
    quad = jnp.matmul(
        xx, P.reshape(C * K, D * D).T, precision="float32"
    )                                                      # [N, CK]
    lin = jnp.matmul(x, q.T, precision="float32")          # [N, CK]
    logp = base[None, :] - 0.5 * quad + lin
    return logp.reshape(-1, C, K)


_FALLBACK_WARNED = False


def sweep_chains(states: MixtureState, data, key,
                 d_max_xx: int = 64,
                 xx_budget_bytes: float = 2e9) -> MixtureState:
    """One blocked sweep of C stacked chains sharing one dataset.

    `states`: a chain-stacked MixtureState (leading axis C on every leaf,
    e.g. from vmapped `initialize`); `data` the SHARED ((x, mask),)
    columns.  Mathematically identical per chain to `sweep` (same theta /
    stick-weight draws, same Gumbel-argmax conditional) but all C·K
    cluster scores come from two wide matmuls over shared row features,
    and the C suffstat rebuilds are two more ([N,CK]ᵀ @ X and
    [N,CK]ᵀ @ XX) — the chain axis lands in the matmul K-dimension
    instead of C separate small-matmul scans.

    Requirements: a single `niw` feature and D² row features affordable:
    D <= d_max_xx AND N·D²·4 bytes <= xx_budget_bytes (the [N, D²]
    outer-product feature matrix is materialized; at D=64 it costs
    16 KB/row — 16 GB at 1M rows).  Anything else (e.g. the 1M×256
    headline shape) runs vmapped per-chain `sweep`s, with a one-time
    warning.
    """
    global _FALLBACK_WARNED
    C = states.counts.shape[0]
    if states.lik_names == ("niw",):
        _n, _d = data[0][0].shape[-2], data[0][0].shape[-1]
        xx_bytes = 4.0 * _n * _d * _d
        wide_ok = _d <= d_max_xx and xx_bytes <= xx_budget_bytes
    else:
        _d, xx_bytes, wide_ok = None, 0.0, False
    if not wide_ok:
        if not _FALLBACK_WARNED:
            import warnings

            warnings.warn(
                f"sweep_chains: running vmapped per-chain sweeps "
                f"(lik={states.lik_names}, D={_d}, [N,D²] "
                f"{xx_bytes/1e9:.1f} GB vs budget "
                f"{xx_budget_bytes/1e9:.1f} GB)",
                stacklevel=2,
            )
            _FALLBACK_WARNED = True
        return jax.vmap(lambda s, k: sweep(s, data, k))(
            states, jax.random.split(key, C)
        )
    x, mask = data[0]
    N, D = x.shape
    K = states.k_max
    lik = states.likelihoods()[0]
    kth, kv, kz = jax.random.split(key, 3)

    thetas = jax.vmap(lik.sample_params_prec)(
        jax.random.split(kth, C), states.hypers[0], states.stats[0]
    )  # {mu: [C,K,D], prec: [C,K,D,D], logdet: [C,K]}
    if states.fixed:
        logw = jax.vmap(dirichlet_log_weights)(
            jax.random.split(kv, C), states.counts,
            states.cluster_hp["alphas"],
        )
    else:
        logw = jax.vmap(stick_break_log_weights)(
            jax.random.split(kv, C), states.counts,
            states.cluster_hp["alpha"].astype(jnp.float32),
        )  # [C, K]

    m = jnp.asarray(mask, x.dtype)
    logp = _chain_score_table(
        thetas["mu"], thetas["prec"], thetas["logdet"], logw, x
    )
    g = jax.random.gumbel(kz, (N, C, K), logp.dtype)
    z = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)   # [N, C]
    # fully-masked rows: assign from the weights alone
    z_prior = jnp.argmax(logw[None, :, :] + g, axis=-1).astype(jnp.int32)
    z = jnp.where(m[:, None] > 0, z, z_prior)

    # restat: all C chains in two wide matmuls against shared (X, XX)
    onehot = (z[:, :, None] == jnp.arange(K)[None, None, :]).astype(x.dtype)
    counts = jnp.sum(onehot, axis=0).astype(jnp.int32)    # [C, K]
    w = (onehot * m[:, None, None]).reshape(N, C * K)
    n_stat = jnp.sum(w, axis=0).reshape(C, K)
    sum_x = jnp.matmul(w.T, x, precision="float32").reshape(C, K, D)
    xx = jnp.einsum("nd,ne->nde", x, x).reshape(N, D * D)
    sum_xxT = scatter_product(w, xx).reshape(C, K, D, D)
    sum_xxT = 0.5 * (sum_xxT + jnp.swapaxes(sum_xxT, -1, -2))
    stats = {"n": n_stat, "sum_x": sum_x, "sum_xxT": sum_xxT}
    return dataclasses.replace(
        states, assignments=z.T, counts=counts, stats=(stats,)
    )


# ---------------------------------------------------------------------------
# fused fast path (single-feature NIW): score + Gumbel + argmax in one kernel
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("interpret",))
def sweep_fused(state: MixtureState, data, key,
                interpret: bool = False) -> MixtureState:
    """`sweep` with the [N, K] score table fused away (ops/gaussian_assign.py).

    Draws θ, the weights and the Gumbel noise with the same keys as
    `sweep`, and gives masked rows the same prior assignment from the
    shared noise, so `sweep_fused(s, d, k)` and `sweep(s, d, k)` agree row
    for row up to ties and the kernel's TF32 precision.  Supports a single
    ``niw`` feature, with DP (stick-breaking) or fixed-K (Dirichlet)
    weights; other models use `sweep` (runner kernel ``assign_blocked``).
    `interpret=True` runs the kernel through the Pallas interpreter.
    """
    if state.lik_names != ("niw",):
        raise ValueError(
            "sweep_fused supports a single niw feature, got "
            f"{state.lik_names}; use blocked.sweep (runner kernel "
            "'assign_blocked')"
        )
    from jax.scipy.linalg import solve_triangular

    from common_tpu.ops.gaussian_assign import fused_gaussian_assign

    x, mask = data[0]
    n, d = x.shape
    thetas, logw, _ = sweep_parts(state, data, key)
    mu, chol = thetas[0]["mu"], thetas[0]["cov_chol"]  # [K, D], [K, D, D]
    eye = jnp.eye(d, dtype=chol.dtype)
    binv = jax.vmap(lambda c: solve_triangular(c, eye, lower=True))(chol)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1
    )
    base = logw - 0.5 * logdet - 0.5 * d * jnp.log(2.0 * jnp.pi)
    g = jax.random.gumbel(
        jax.random.fold_in(key, 2), (n, logw.shape[0]), logw.dtype
    )
    z = fused_gaussian_assign(x, mu, binv, base, g, interpret=interpret)
    # fully-masked rows carry no likelihood: assign from the weights alone
    z_prior = jnp.argmax(logw[None, :] + g, axis=-1).astype(jnp.int32)
    z = jnp.where(jnp.asarray(mask) > 0, z, z_prior)
    return restat(state, data, z, thetas)
