"""Sequential Monte Carlo for DP mixtures (sequential imputation).

No reference analog: the reference has no SMC anywhere; this is the
north-star config-5 kernel (BASELINE.json: "1M-row DPMM with SMC,
particles sharded across N≥2 hosts, collective resampling").

Algorithm (sequential imputation with the optimal one-step proposal —
the classic SIS scheme for CRP mixtures, cf. MacEachern–Clyde–Liu 1999):
particles are partial clustering states; rows are absorbed one at a time;
each particle seats row n from its exact conditional
softmax(CRP prior + predictive), and its weight gains the row's
*predictive* log p(x_n | x_{<n}, particle) = logsumexp(scores) − log(α+n).
Adaptive systematic resampling fires when ESS < threshold·P, optionally
followed by collapsed-Gibbs rejuvenation moves on a random subset of
already-seated rows.  The running sum of pre-reset mean weights is an
unbiased (in Z) marginal-likelihood estimator — validated against the
exact-enumeration evidence in tests.

Vectorized design: particles are a vmapped state pytree (leading axis P);
one `lax.scan` over rows drives all P particles in lock-step, so the inner
work is a [P, K, F] vectorized scoring block per row.  Resampling is a
shared-key systematic draw + gather.  Multi-device: particles shard over a
`Mesh('particles')` axis via `shard_map`; resampling all_gathers the [P]
log-weights (tiny), computes identical global indices everywhere, and
exchanges particle state with an all_gather + local slice — the simple
collective-resampling layout (a ppermute pipelined exchange is the
memory-lean refinement; at DPMM state sizes the gather is bandwidth-cheap).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import logsumexp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from common_tpu import state as state_mod
from common_tpu import validator
from common_tpu.kernels import gibbs
from common_tpu.state import MixtureState

PARTICLES = "particles"


# ---------------------------------------------------------------------------
# weights / resampling
# ---------------------------------------------------------------------------
def log_ess(log_w):
    """log effective sample size of unnormalized log-weights."""
    return 2.0 * logsumexp(log_w) - logsumexp(2.0 * log_w)


def systematic_resample(key, log_w):
    """Systematic resampling: [P] parent indices from one uniform draw."""
    p = log_w.shape[-1]
    w = jax.nn.softmax(log_w)
    cdf = jnp.cumsum(w)
    u = (jax.random.uniform(key) + jnp.arange(p)) / p
    return jnp.clip(jnp.searchsorted(cdf, u), 0, p - 1).astype(jnp.int32)


def _gather_particles(particles: MixtureState, idx):
    return jax.tree_util.tree_map(lambda l: l[idx], particles)


# ---------------------------------------------------------------------------
# particle initialization
# ---------------------------------------------------------------------------
def init_particles(
    defn,
    data,
    key,
    n_particles: int,
    cluster_hp: Optional[Dict[str, Any]] = None,
    feature_hps: Optional[Sequence[Dict[str, Any]]] = None,
    fixed: bool = False,
) -> MixtureState:
    """P empty particles (no rows seated): broadcast one empty state."""
    validator.validate_positive(n_particles, "n_particles")
    empty = state_mod.initialize(
        defn, data, key,
        cluster_hp=cluster_hp, feature_hps=feature_hps,
        assignment=-np.ones(defn.n, np.int32), fixed=fixed,
    )
    return jax.tree_util.tree_map(
        lambda l: jnp.broadcast_to(l, (n_particles, *l.shape)), empty
    )


# ---------------------------------------------------------------------------
# core row step
# ---------------------------------------------------------------------------
def _seat_row(p_state: MixtureState, data, eid, t, key):
    """Seat row eid in one particle; return (state, predictive logp)."""
    logp = state_mod.score_value(p_state, data, eid)  # [K]
    g = jax.random.gumbel(key, logp.shape, logp.dtype)
    gid = jnp.argmax(logp + g)
    new_state = state_mod.add_value(p_state, data, eid, gid)
    if p_state.fixed:
        norm = jnp.sum(p_state.cluster_hp["alphas"]) + t
    else:
        norm = p_state.cluster_hp["alpha"].astype(jnp.float32) + t
    incr = logsumexp(logp) - jnp.log(norm)
    return new_state, incr


def _rejuvenate(particles: MixtureState, data, key, eid, n_moves):
    """n_moves collapsed-Gibbs updates of random already-seated rows."""

    def per_particle(p_state, k):
        def body(st, i):
            ki = jax.random.fold_in(k, i)
            row = jax.random.randint(ki, (), 0, jnp.maximum(eid + 1, 1))
            st, _ = gibbs._row_sweep_step(data, 1, ki, st, row)
            return st, None

        p_state, _ = jax.lax.scan(body, p_state, jnp.arange(n_moves))
        return p_state

    n_p = particles.counts.shape[0]
    return jax.vmap(per_particle)(particles, jax.random.split(key, n_p))


# ---------------------------------------------------------------------------
# single-device run
# ---------------------------------------------------------------------------
class SMCResult(NamedTuple):
    particles: MixtureState   # leading axis P
    log_w: jax.Array          # [P] final unnormalized log-weights
    logz: jax.Array           # marginal-likelihood estimate log p(data)
    n_resamples: jax.Array
    # ESS after each absorption step: one entry PER ROW ([N]) for
    # run()/run_sharded(), one entry PER BLOCK ([ceil(N/block)]) for
    # run_blocked()/run_blocked_sharded().
    ess_trace: jax.Array


# The row-sequential path is O(N) sequential device steps (one scan step
# per row), the wrong algorithm at scale: `run_blocked` (O(N/B) steps) is
# the config-5 path.  This cap points large problems there; pass
# allow_large=True to run the row-sequential scan anyway.
ROW_SCAN_CAP = 20_000


@partial(jax.jit, static_argnames=("ess_threshold", "rejuvenation_moves",
                                   "allow_large"))
def run(
    particles: MixtureState,
    data,
    key,
    ess_threshold: float = 0.5,
    rejuvenation_moves: int = 0,
    allow_large: bool = False,
) -> SMCResult:
    """Run SMC over all rows. `particles` from `init_particles` ([P] axis)."""
    n_p = particles.counts.shape[0]
    n = particles.assignments.shape[-1]
    if n > ROW_SCAN_CAP and not allow_large:
        raise ValueError(
            f"row-sequential SMC over {n} rows exceeds the safety cap "
            f"({ROW_SCAN_CAP}): it takes one sequential device step per "
            "row. Use run_blocked for at-scale SMC (O(N/block) steps), or "
            "pass allow_large=True."
        )
    log_p = jnp.log(float(n_p))

    def row_step(carry, eid):
        particles, log_w, logz, n_res = carry
        k_row = jax.random.fold_in(key, eid)
        keys = jax.random.split(jax.random.fold_in(k_row, 0), n_p)
        t = eid.astype(jnp.float32)
        particles, incr = jax.vmap(
            lambda p, k: _seat_row(p, data, eid, t, k)
        )(particles, keys)
        log_w = log_w + incr

        ess = jnp.exp(log_ess(log_w))
        do_res = ess < ess_threshold * n_p

        def resample(args):
            particles, log_w, logz, n_res = args
            idx = systematic_resample(jax.random.fold_in(k_row, 1), log_w)
            particles = _gather_particles(particles, idx)
            logz = logz + logsumexp(log_w) - log_p
            log_w = jnp.zeros_like(log_w)
            if rejuvenation_moves > 0:
                particles = _rejuvenate(
                    particles, data, jax.random.fold_in(k_row, 2),
                    eid, rejuvenation_moves,
                )
            return particles, log_w, logz, n_res + 1

        particles, log_w, logz, n_res = jax.lax.cond(
            do_res, resample, lambda a: a, (particles, log_w, logz, n_res)
        )
        return (particles, log_w, logz, n_res), ess

    init = (
        particles,
        jnp.zeros(n_p),
        jnp.zeros(()),
        jnp.zeros((), jnp.int32),
    )
    (particles, log_w, logz, n_res), ess_trace = jax.lax.scan(
        row_step, init, jnp.arange(n)
    )
    logz = logz + logsumexp(log_w) - log_p
    return SMCResult(particles, log_w, logz, n_res, ess_trace)


def posterior_sample(key, result: SMCResult) -> MixtureState:
    """Draw one particle ~ final weights (a posterior partition sample)."""
    i = jax.random.categorical(key, result.log_w)
    return jax.tree_util.tree_map(lambda l: l[i], result.particles)


def posterior_partition_weights(result: SMCResult):
    """(assignments [P, N], normalized weights [P]) for posterior summaries."""
    w = jax.nn.softmax(result.log_w)
    return result.particles.assignments, w


# ---------------------------------------------------------------------------
# block-SMC: the config-5 at-scale path (O(N/B) device steps)
# ---------------------------------------------------------------------------
# The row-sequential scheme above is O(N) sequential device steps — 10^6
# steps at the BASELINE config-5 scale.  Block-SMC absorbs rows in
# blocks of B via the *blocked* conditional (truncated stick-breaking,
# same target family as kernels/blocked.py):
#
#   extended target  γ_b(z_{1:bB}, w, θ) = p(w) p(θ) Π_i w_{z_i} f(x_i|θ)
#   per block:  (1) Gibbs refresh (w, θ) ~ p(· | z_past, x_past)  [no
#               weight change — invariant move];  (2) propose
#               z_i ~ Cat_k(w_k f_k(x_i)) independently over the block
#               (the locally-optimal proposal given (w, θ));  weight
#               gain = Π_i Σ_k w_k f_k(x_i)  — exact for this proposal,
#               so the running Z estimate stays unbiased for the
#               truncated-SB evidence (→ DP evidence as K_max grows;
#               Ishwaran–James truncation bound 4n·exp(−(K−1)/α)).
#
# Resampling is the same systematic scheme; rejuvenation redraws (w, θ)
# and re-assigns `rejuvenation_blocks` random already-seated blocks — a
# partially-collapsed blocked-Gibbs move, invariant for the current
# target.  Only conjugate likelihoods (additive suffstats) are supported.


def _check_block_smc_support(state: MixtureState):
    for lik in state.likelihoods():
        if getattr(lik, "latent_leaves", None) or not lik.conjugate:
            raise ValueError(
                f"block-SMC requires conjugate likelihoods with additive "
                f"suffstats; got {lik.name}"
            )


def _pad_cols(data, n_pad):
    out = []
    for x, m in data:
        pad = n_pad - x.shape[0]
        xp = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        mp = jnp.pad(jnp.asarray(m, jnp.float32), (0, pad))
        out.append((xp, mp))
    return tuple(out)


def _seat_block(p_state: MixtureState, blk_cols, valid, key):
    """Seat one block in one particle: returns (state, z_blk, log-weight).

    The incremental weight is Rao-Blackwellized over the θ draw.  θ
    enters the PROPOSAL only:
    z_i ~ Cat_k(w_k f_θ,k(x_i)).  The weight targets the θ-COLLAPSED
    extended distribution γ_b(z_{1:bB}, w) = p(w) Π_i w_{z_i} ·
    Π_k marglik(x's in k), so

        log incr = Σ_i logsumexp_k(log w_k + log f_θ,k(x_i))
                 − Σ_i log f_θ,z_i(x_i)
                 + Σ_k [marglik(stats_k + block) − marglik(stats_k)]

    (the w_{z_i} prior factor cancels against the proposal's numerator).
    E_q[exp(incr)] = p(x_block | z_past, w, x_past) EXACTLY, for ANY θ
    draw — so the per-block weight variance no longer scales with
    B · var(θ misfit).  The old weight Σ_i logsumexp(logp) conditioned
    8192 rows on ONE θ draw per particle; its Jensen bias accumulated to
    logz 4–11× below the Gibbs joint-score lower bound at scale
    (reproduced in tests/test_smc.py medium-scale bound test).
    """
    from common_tpu.kernels import blocked

    thetas, logw, table = blocked.sweep_parts(p_state, blk_cols, key)
    loglik = table(blk_cols)                 # [B, K] log f_θ,k(x_i)
    logp = logw[None, :] + loglik            # [B, K] proposal logits
    g = jax.random.gumbel(
        jax.random.fold_in(key, 2), logp.shape, logp.dtype
    )
    z = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)
    loglik_z = jnp.take_along_axis(loglik, z[:, None], axis=-1)[:, 0]
    incr = jnp.sum(
        jnp.where(valid, logsumexp(logp, axis=-1) - loglik_z, 0.0)
    )

    K = p_state.k_max
    vz = jnp.where(valid, z, K)  # pad rows land in a discarded segment
    counts = p_state.counts + jax.ops.segment_sum(
        jnp.ones_like(vz), vz, num_segments=K + 1
    )[:K].astype(p_state.counts.dtype)
    new_stats = []
    for (xb, mb), lik, hyper, s_f in zip(
        blk_cols, p_state.likelihoods(), p_state.hypers, p_state.stats
    ):
        mb2 = jnp.asarray(mb, jnp.float32) * valid.astype(jnp.float32)
        s_blk = lik.stats_from_assignments(hyper, xb, mb2, z, K)
        s_new = {k: s_f[k] + s_blk[k] for k in s_f}
        ml_new = lik.marginal_loglik(hyper, s_new)   # [K]
        ml_old = lik.marginal_loglik(hyper, s_f)     # [K]
        incr = incr + jnp.sum(
            jnp.where(s_new["n"] > 0, ml_new, 0.0)
            - jnp.where(s_f["n"] > 0, ml_old, 0.0)
        )
        new_stats.append(s_new)
    return (
        dataclasses.replace(p_state, counts=counts, stats=tuple(new_stats)),
        z,
        incr,
    )


def _draw_log_weights(p_state: MixtureState, key):
    """w ~ p(w | z) under the block family's weight prior (invariant move)."""
    from common_tpu.kernels import blocked

    if p_state.fixed:
        return blocked.dirichlet_log_weights(
            key, p_state.counts, p_state.cluster_hp["alphas"]
        )
    return blocked.stick_break_log_weights(
        key, p_state.counts, p_state.cluster_hp["alpha"].astype(jnp.float32)
    )


def _warmup_row(p_state: MixtureState, data, eid, key):
    """Seat ONE row under the θ-collapsed extended target γ(z, w).

    Per row: refresh w ~ p(w | z_past) (an invariant Gibbs move — θ is
    collapsed, so w ⊥ x | z), then propose z from the OPTIMAL collapsed
    proposal q(k) ∝ w_k · pred_k(x_row).  The incremental weight for the
    extended target γ ∝ p(w) Π_i w_{z_i} Π_k marglik_k is then exactly

        incr = logsumexp_k(log w_k + log pred_k(x_row))

    independent of the sampled z (classic optimal-proposal SIS, here on
    the truncated stick-breaking/Dirichlet weight family instead of the
    CRP so the warmup target composes exactly with `_seat_block`'s).
    """
    logw = _draw_log_weights(p_state, jax.random.fold_in(key, 0))
    pred = jnp.zeros_like(logw)
    for (x, mask), lik, hyper, stats_f in zip(
        data, p_state.likelihoods(), p_state.hypers, p_state.stats
    ):
        s = lik.pred_logpdf(hyper, stats_f, x[eid])
        pred = pred + s * jnp.asarray(mask[eid], s.dtype)
    logp = logw + pred
    g = jax.random.gumbel(
        jax.random.fold_in(key, 1), logp.shape, logp.dtype
    )
    gid = jnp.argmax(logp + g)
    new_state = state_mod.add_value(p_state, data, eid, gid)
    return new_state, logsumexp(logp)


def _rejuv_block(p_state: MixtureState, blk_cols, z_old, valid, key):
    """Re-assign one already-seated block given fresh (w, θ) draws."""
    from common_tpu.kernels import blocked

    thetas, logw, table = blocked.sweep_parts(p_state, blk_cols, key)
    logp = logw[None, :] + table(blk_cols)
    g = jax.random.gumbel(
        jax.random.fold_in(key, 2), logp.shape, logp.dtype
    )
    z_new = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)

    K = p_state.k_max
    vz_new = jnp.where(valid, z_new, K)
    vz_old = jnp.where(valid, z_old, K)
    dc = (
        jax.ops.segment_sum(jnp.ones_like(vz_new), vz_new,
                            num_segments=K + 1)[:K]
        - jax.ops.segment_sum(jnp.ones_like(vz_old), vz_old,
                              num_segments=K + 1)[:K]
    )
    counts = p_state.counts + dc.astype(p_state.counts.dtype)
    new_stats = []
    for (xb, mb), lik, hyper, s_f in zip(
        blk_cols, p_state.likelihoods(), p_state.hypers, p_state.stats
    ):
        mb2 = jnp.asarray(mb, jnp.float32) * valid.astype(jnp.float32)
        s_new = lik.stats_from_assignments(hyper, xb, mb2, z_new, K)
        s_old = lik.stats_from_assignments(hyper, xb, mb2, z_old, K)
        new_stats.append({k: s_f[k] + s_new[k] - s_old[k] for k in s_f})
    return (
        dataclasses.replace(p_state, counts=counts, stats=tuple(new_stats)),
        z_new,
    )


@partial(jax.jit, static_argnames=("block", "ess_threshold",
                                   "rejuvenation_blocks", "warmup"))
def run_blocked(
    particles: MixtureState,
    data,
    key,
    block: int = 4096,
    ess_threshold: float = 0.5,
    rejuvenation_blocks: int = 1,
    warmup: int = 512,
) -> SMCResult:
    """Block-SMC over all rows (config 5): warmup rows + O(N/block) steps.

    `particles` from `init_particles` ([P] leading axis).  The evidence
    estimate targets the truncated stick-breaking model (the blocked-Gibbs
    family's target); validated against exact enumeration, against the
    row-sequential SMC, and against the collapsed-Gibbs joint-score lower
    bound at medium scale in tests/test_smc.py.

    Design (a plain θ-conditional weight put logz 4–11× below the Gibbs
    joint bound at scale):

    * Incremental weights are Rao-Blackwellized over the per-block θ draw
      (see `_seat_block`) — θ is proposal-only, the weight uses the
      collapsed marginal-likelihood ratio.
    * The first min(warmup, n) rows are seated ROW-SEQUENTIALLY under the
      same θ-collapsed extended target (see `_warmup_row`), because a
      one-shot importance weight for a whole block proposed from a
      prior-θ draw on a near-empty state has O(block)-variance no
      Rao-Blackwellization can remove.  Measured at n=8192 d=16 P=16
      B=512: no fix logz ≈ −870k, RB only ≈ −265k, RB+warmup ≈ −208k vs
      Gibbs joint bound −220k (row-sequential SMC: −208k).
    * Rejuvenation now runs every block step (and every `block` warmup
      rows), decoupled from resampling — with low-variance weights
      resampling is rare, and rejuvenation gated on it left the final
      cloud degenerate.

    rejuvenation_blocks: how many random already-seated `block`-row
    windows get a blocked-Gibbs re-assignment per step.  The log-Z
    estimate is unbiased at ANY setting (including 0).  For posterior
    summaries computed from the final particle CLOUD (e.g. weighted
    co-assignment), raise it (tests/test_cross_sampler.py pins 6).

    The returned SMCResult.ess_trace has one entry per warmup row
    followed by one per block (length min(warmup, n) + ceil((n−W)/block)).
    """
    _check_block_smc_support(particles)
    n_p = particles.counts.shape[0]
    n = particles.assignments.shape[-1]
    w_rows = min(warmup, n)
    nb = max(0, -(-(n - w_rows) // block))
    n_pad = w_rows + nb * block
    data_p = _pad_cols(data, n_pad)
    particles = dataclasses.replace(
        particles,
        assignments=jnp.pad(
            particles.assignments, ((0, 0), (0, n_pad - n)),
            constant_values=-1,
        ),
    )
    log_p = jnp.log(float(n_p))
    k_warm, k_block = jax.random.split(key)

    def get_window(off):
        cols = tuple(
            (
                jax.lax.dynamic_slice_in_dim(x, off, block),
                jax.lax.dynamic_slice_in_dim(m, off, block),
            )
            for x, m in data_p
        )
        valid = (off + jnp.arange(block)) < n
        return cols, valid

    def write_block(parts, z_blk, off):
        return dataclasses.replace(
            parts,
            assignments=jax.vmap(
                lambda a, zb: jax.lax.dynamic_update_slice(a, zb, (off,))
            )(parts.assignments, z_blk),
        )

    def rejuvenate(parts, kb, seated):
        """blocked-Gibbs re-assignment of random seated `block`-windows.

        `seated` = number of rows seated so far; windows are row-granular
        (any [roff, roff+block) ⊆ the seated prefix), so warmup rows get
        rejuvenated too.
        """
        for r in range(rejuvenation_blocks):
            kr = jax.random.fold_in(kb, 100 + r)
            roff = jax.random.randint(
                kr, (), 0, jnp.maximum(seated - block + 1, 1)
            )
            rcols, rvalid = get_window(roff)
            z_old = jax.vmap(
                lambda a: jax.lax.dynamic_slice(a, (roff,), (block,))
            )(parts.assignments)
            keys_r = jax.random.split(jax.random.fold_in(kr, 1), n_p)
            parts, z_new = jax.vmap(
                lambda p, zo, k: _rejuv_block(p, rcols, zo, rvalid, k)
            )(parts, z_old, keys_r)
            parts = write_block(parts, z_new, roff)
        return parts

    def maybe_resample(parts, log_w, logz, n_res, k_res):
        ess = jnp.exp(log_ess(log_w))
        do_res = ess < ess_threshold * n_p

        def resample(args):
            parts, log_w, logz, n_res = args
            idx = systematic_resample(k_res, log_w)
            parts = _gather_particles(parts, idx)
            logz = logz + logsumexp(log_w) - log_p
            return parts, jnp.zeros_like(log_w), logz, n_res + 1

        parts, log_w, logz, n_res = jax.lax.cond(
            do_res, resample, lambda a: a, (parts, log_w, logz, n_res)
        )
        return parts, log_w, logz, n_res, ess

    # ---- phase 1: row-sequential warmup under the extended target ----
    def warm_step(carry, eid):
        parts, log_w, logz, n_res = carry
        kr = jax.random.fold_in(k_warm, eid)
        keys = jax.random.split(jax.random.fold_in(kr, 0), n_p)
        parts, incr = jax.vmap(
            lambda p, k: _warmup_row(p, data_p, eid, k)
        )(parts, keys)
        log_w = log_w + incr
        parts, log_w, logz, n_res, ess = maybe_resample(
            parts, log_w, logz, n_res, jax.random.fold_in(kr, 1)
        )
        if rejuvenation_blocks > 0 and w_rows > block:
            parts = jax.lax.cond(
                (eid + 1) % block == 0,
                lambda p: rejuvenate(p, jax.random.fold_in(kr, 2), eid + 1),
                lambda p: p,
                parts,
            )
        return (parts, log_w, logz, n_res), ess

    init = (
        particles,
        jnp.zeros(n_p),
        jnp.zeros(()),
        jnp.zeros((), jnp.int32),
    )
    if w_rows > 0:
        init, warm_ess = jax.lax.scan(warm_step, init, jnp.arange(w_rows))
    else:
        warm_ess = jnp.zeros((0,))

    # ---- phase 2: blocks ----
    def block_step(carry, b):
        parts, log_w, logz, n_res = carry
        off = w_rows + b * block
        cols, valid = get_window(off)
        kb = jax.random.fold_in(k_block, b)
        keys = jax.random.split(jax.random.fold_in(kb, 0), n_p)
        parts, z_blk, incr = jax.vmap(
            lambda p, k: _seat_block(p, cols, valid, k)
        )(parts, keys)
        parts = write_block(parts, z_blk, off)
        log_w = log_w + incr
        parts, log_w, logz, n_res, ess = maybe_resample(
            parts, log_w, logz, n_res, jax.random.fold_in(kb, 1)
        )
        if rejuvenation_blocks > 0:
            parts = rejuvenate(parts, kb, off + block)
        return (parts, log_w, logz, n_res), ess

    if nb > 0:
        (particles, log_w, logz, n_res), blk_ess = jax.lax.scan(
            block_step, init, jnp.arange(nb)
        )
    else:
        (particles, log_w, logz, n_res), blk_ess = init, jnp.zeros((0,))
    ess_trace = jnp.concatenate([warm_ess, blk_ess])
    logz = logz + logsumexp(log_w) - log_p
    particles = dataclasses.replace(
        particles, assignments=particles.assignments[:, :n]
    )
    return SMCResult(particles, log_w, logz, n_res, ess_trace)


def run_blocked_sharded(
    mesh: Mesh,
    particles: MixtureState,
    data,
    key,
    block: int = 4096,
    ess_threshold: float = 0.5,
    rejuvenation_blocks: int = 1,
    warmup: int = 512,
) -> SMCResult:
    """Block-SMC with the particle axis sharded over `mesh`.

    Same collective-resampling layout as `run_sharded`: the [P] log-weight
    vector is all_gathered (bytes) for a globally identical ESS check and
    parent-index draw; particle state moves via all_gather + local slice.
    Mirrors `run_blocked`'s weight/warmup/rejuvenation design —
    see its docstring.
    """
    _check_block_smc_support(particles)
    n_dev = mesh.devices.size
    n_p = particles.counts.shape[0]
    if n_p % n_dev:
        raise ValueError(f"n_particles {n_p} must divide over {n_dev} devices")
    p_local = n_p // n_dev
    n = particles.assignments.shape[-1]
    w_rows = min(warmup, n)
    nb = max(0, -(-(n - w_rows) // block))
    n_pad = w_rows + nb * block
    data = _pad_cols(data, n_pad)
    particles = dataclasses.replace(
        particles,
        assignments=jnp.pad(
            particles.assignments, ((0, 0), (0, n_pad - n)),
            constant_values=-1,
        ),
    )
    log_p = jnp.log(float(n_p))

    def local_run(parts_blk, data_blk, key):
        shard = jax.lax.axis_index(PARTICLES)
        k_warm, k_block = jax.random.split(key)

        def get_window(off):
            cols = tuple(
                (
                    jax.lax.dynamic_slice_in_dim(x, off, block),
                    jax.lax.dynamic_slice_in_dim(m, off, block),
                )
                for x, m in data_blk
            )
            valid = (off + jnp.arange(block)) < n
            return cols, valid

        def write_block(parts, z_blk, off):
            return dataclasses.replace(
                parts,
                assignments=jax.vmap(
                    lambda a, zb: jax.lax.dynamic_update_slice(a, zb, (off,))
                )(parts.assignments, z_blk),
            )

        def rejuvenate(parts, kb, seated):
            for r in range(rejuvenation_blocks):
                kr = jax.random.fold_in(kb, 100 + r)
                roff = jax.random.randint(
                    kr, (), 0, jnp.maximum(seated - block + 1, 1)
                )
                rcols, rvalid = get_window(roff)
                z_old = jax.vmap(
                    lambda a: jax.lax.dynamic_slice(a, (roff,), (block,))
                )(parts.assignments)
                keys_r = jax.random.split(
                    jax.random.fold_in(kr, 11 + shard), p_local
                )
                parts, z_new = jax.vmap(
                    lambda p, zo, k: _rejuv_block(p, rcols, zo, rvalid, k)
                )(parts, z_old, keys_r)
                parts = write_block(parts, z_new, roff)
            return parts

        def maybe_resample(parts, log_w, logz, n_res, k_res):
            log_w_all = jax.lax.all_gather(log_w, PARTICLES, tiled=True)
            ess = jnp.exp(log_ess(log_w_all))
            do_res = ess < ess_threshold * n_p

            def resample(args):
                parts, log_w, logz, n_res = args
                idx = systematic_resample(k_res, log_w_all)
                local_idx = jax.lax.dynamic_slice_in_dim(
                    idx, shard * p_local, p_local
                )
                parts_all = jax.tree_util.tree_map(
                    lambda l: jax.lax.all_gather(l, PARTICLES, tiled=True),
                    parts,
                )
                parts = jax.tree_util.tree_map(
                    lambda l: l[local_idx], parts_all
                )
                logz = logz + logsumexp(log_w_all) - log_p
                return parts, jnp.zeros_like(log_w), logz, n_res + 1

            parts, log_w, logz, n_res = jax.lax.cond(
                do_res, resample, lambda a: a, (parts, log_w, logz, n_res)
            )
            return parts, log_w, logz, n_res, ess

        def warm_step(carry, eid):
            parts, log_w, logz, n_res = carry
            kr = jax.random.fold_in(k_warm, eid)
            keys = jax.random.split(
                jax.random.fold_in(kr, 10 + shard), p_local
            )
            parts, incr = jax.vmap(
                lambda p, k: _warmup_row(p, data_blk, eid, k)
            )(parts, keys)
            log_w = log_w + incr
            parts, log_w, logz, n_res, ess = maybe_resample(
                parts, log_w, logz, n_res, jax.random.fold_in(kr, 1)
            )
            if rejuvenation_blocks > 0 and w_rows > block:
                parts = jax.lax.cond(
                    (eid + 1) % block == 0,
                    lambda p: rejuvenate(
                        p, jax.random.fold_in(kr, 2), eid + 1
                    ),
                    lambda p: p,
                    parts,
                )
            return (parts, log_w, logz, n_res), ess

        def block_step(carry, b):
            parts, log_w, logz, n_res = carry  # log_w: local [p_local]
            off = w_rows + b * block
            cols, valid = get_window(off)
            kb = jax.random.fold_in(k_block, b)
            k_shard = jax.random.fold_in(kb, 10 + shard)
            keys = jax.random.split(k_shard, p_local)
            parts, z_blk, incr = jax.vmap(
                lambda p, k: _seat_block(p, cols, valid, k)
            )(parts, keys)
            parts = write_block(parts, z_blk, off)
            log_w = log_w + incr
            parts, log_w, logz, n_res, ess = maybe_resample(
                parts, log_w, logz, n_res, jax.random.fold_in(kb, 1)
            )
            if rejuvenation_blocks > 0:
                parts = rejuvenate(parts, kb, off + block)
            return (parts, log_w, logz, n_res), ess

        init = (
            parts_blk,
            jnp.zeros(p_local),
            jnp.zeros(()),
            jnp.zeros((), jnp.int32),
        )
        if w_rows > 0:
            init, warm_ess = jax.lax.scan(warm_step, init, jnp.arange(w_rows))
        else:
            warm_ess = jnp.zeros((0,))
        if nb > 0:
            (parts, log_w, logz, n_res), blk_ess = jax.lax.scan(
                block_step, init, jnp.arange(nb)
            )
        else:
            (parts, log_w, logz, n_res), blk_ess = init, jnp.zeros((0,))
        ess_trace = jnp.concatenate([warm_ess, blk_ess])
        log_w_all = jax.lax.all_gather(log_w, PARTICLES, tiled=True)
        logz = logz + logsumexp(log_w_all) - log_p
        parts = dataclasses.replace(
            parts, assignments=parts.assignments[:, :n]
        )
        return parts, log_w, logz, n_res, ess_trace

    pspec = jax.tree_util.tree_map(lambda _: P(PARTICLES), particles)
    dspec = jax.tree_util.tree_map(lambda _: P(), data)
    sharded = jax.shard_map(
        local_run,
        mesh=mesh,
        in_specs=(pspec, dspec, P()),
        out_specs=(pspec, P(PARTICLES), P(), P(), P()),
        check_vma=False,
    )
    parts, log_w, logz, n_res, ess_trace = jax.jit(
        sharded, static_argnames=()
    )(particles, data, key)
    return SMCResult(parts, log_w, logz, n_res, ess_trace)


# ---------------------------------------------------------------------------
# multi-device: particles sharded over a mesh axis, collective resampling
# ---------------------------------------------------------------------------
def make_particle_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (PARTICLES,))


def shard_particles(mesh: Mesh, particles: MixtureState, data):
    """Place particles sharded on the particle axis; data replicated."""
    ps = NamedSharding(mesh, P(PARTICLES))
    rep = NamedSharding(mesh, P())
    particles = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, ps), particles
    )
    data = jax.tree_util.tree_map(lambda l: jax.device_put(l, rep), data)
    return particles, data


def run_sharded(
    mesh: Mesh,
    particles: MixtureState,
    data,
    key,
    ess_threshold: float = 0.5,
) -> SMCResult:
    """SMC with the particle axis sharded over `mesh` (collective resampling).

    Inside `shard_map` each device advances its local particle block; at a
    resampling event the [P] log-weight vector is all_gathered (bytes),
    every device computes the same systematic parent indices from the same
    folded key, and particle state moves via all_gather + local slice.
    ESS check uses the *global* weights via psum of the softmax moments,
    so the resample decision is identical on every shard.
    """
    n_dev = mesh.devices.size
    n_p = particles.counts.shape[0]
    if n_p % n_dev:
        raise ValueError(f"n_particles {n_p} must divide over {n_dev} devices")
    p_local = n_p // n_dev
    n = particles.assignments.shape[-1]
    log_p = jnp.log(float(n_p))

    def local_run(particles_blk, data_blk, key):
        shard = jax.lax.axis_index(PARTICLES)

        def row_step(carry, eid):
            parts, log_w, logz, n_res = carry  # log_w: local [p_local]
            k_row = jax.random.fold_in(key, eid)
            k_shard = jax.random.fold_in(k_row, 10 + shard)
            keys = jax.random.split(k_shard, p_local)
            t = eid.astype(jnp.float32)
            parts, incr = jax.vmap(
                lambda p, k: _seat_row(p, data_blk, eid, t, k)
            )(parts, keys)
            log_w = log_w + incr

            log_w_all = jax.lax.all_gather(
                log_w, PARTICLES, tiled=True
            )  # [P]
            ess = jnp.exp(log_ess(log_w_all))
            do_res = ess < ess_threshold * n_p

            def resample(args):
                parts, log_w, logz, n_res = args
                idx = systematic_resample(
                    jax.random.fold_in(k_row, 1), log_w_all
                )  # [P] global parent ids, identical on every shard
                local_idx = jax.lax.dynamic_slice_in_dim(
                    idx, shard * p_local, p_local
                )
                parts_all = jax.tree_util.tree_map(
                    lambda l: jax.lax.all_gather(l, PARTICLES, tiled=True),
                    parts,
                )
                parts = jax.tree_util.tree_map(
                    lambda l: l[local_idx], parts_all
                )
                logz = logz + logsumexp(log_w_all) - log_p
                return parts, jnp.zeros_like(log_w), logz, n_res + 1

            parts, log_w, logz, n_res = jax.lax.cond(
                do_res, resample, lambda a: a, (parts, log_w, logz, n_res)
            )
            return (parts, log_w, logz, n_res), ess

        init = (
            particles_blk,
            jnp.zeros(p_local),
            jnp.zeros(()),
            jnp.zeros((), jnp.int32),
        )
        (parts, log_w, logz, n_res), ess_trace = jax.lax.scan(
            row_step, init, jnp.arange(n)
        )
        log_w_all = jax.lax.all_gather(log_w, PARTICLES, tiled=True)
        logz = logz + logsumexp(log_w_all) - log_p
        return parts, log_w, logz, n_res, ess_trace

    pspec = jax.tree_util.tree_map(lambda _: P(PARTICLES), particles)
    dspec = jax.tree_util.tree_map(lambda _: P(), data)
    sharded = jax.shard_map(
        local_run,
        mesh=mesh,
        in_specs=(pspec, dspec, P()),
        out_specs=(pspec, P(PARTICLES), P(), P(), P()),
        check_vma=False,
    )
    parts, log_w, logz, n_res, ess_trace = jax.jit(sharded)(
        particles, data, key
    )
    return SMCResult(parts, log_w, logz, n_res, ess_trace)
