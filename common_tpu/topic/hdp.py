"""HDP-LDA topic model — the `lda` sibling-repo capability.

Reference analog: the `lda` sibling repo (`lda:microscopes/lda/model.pyx`,
`lda:src/lda/state.cpp` [MED]) implements HDP-LDA over `common`'s variadic
dataview with a collapsed direct-assignment Gibbs sampler (Teh et al. 2006
"Hierarchical Dirichlet Processes", §5.3 posterior-representation scheme).

Model (truncated to K topics; truncation error vanishes for K ≫ K_active):

  beta        ~ stick-break(gamma)          global topic weights  [K+1]
                (last entry = unrepresented remainder mass)
  theta_d     ~ Dirichlet(alpha * beta_1:K) per-doc proportions
  phi_k       ~ Dirichlet(eta)              topic-word dists      [K, V]
  z_t | theta ~ Cat(theta_{d_t});  w_t | z ~ Cat(phi_{z_t})

Vectorized design: the corpus is the variadic dataview's flat CSR layout
(tokens [T], doc_ids [T], mask [T]); all counts are segment-sums over the
token axis, shardable along tokens.  Two samplers:

  - `collapsed_sweep` — direct-assignment collapsed Gibbs given beta:
    `lax.scan` over tokens, per-token [K]-vectorized predictive
    (n_dk^-t + alpha*beta_k)(n_kw^-t + eta)/(n_k^-t + V*eta).
    The correctness oracle (validated against exact z-enumeration).
  - `blocked_sweep` — uncollapsed parallel sweep: draw phi | z, theta | z,
    then reassign EVERY token in parallel (gather log theta + log phi,
    Gumbel-argmax) and rebuild counts with segment-sums.  This is the
    1M-doc perf path and what shards over the mesh (sweep_sharded).

Between sweeps `sample_beta` resamples the global weights from table
counts m_dk drawn by the Chinese-restaurant-table (CRT) construction
m = Σ_i Bernoulli(a/(a+i)), vectorized over (doc, topic) with a masked
scan over the max per-doc-topic count.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

from common_tpu import validator


class TokenData(NamedTuple):
    """Flat corpus (pytree): word id, doc id, validity per token slot."""

    words: jax.Array    # [T] int32
    doc_ids: jax.Array  # [T] int32 (== D for padding slots)
    mask: jax.Array     # [T] float 0/1


def token_data(view) -> TokenData:
    """From a variadic_dataview (or anything with tokens/doc_ids/token_mask)."""
    return TokenData(
        jnp.asarray(view.tokens, jnp.int32),
        jnp.asarray(view.doc_ids, jnp.int32),
        jnp.asarray(view.token_mask, jnp.float32),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HDPState:
    """Truncated-HDP latent state (counts are derived but carried)."""

    z: jax.Array           # [T] int32 topic per token
    beta: jax.Array        # [K+1] global weights (last = remainder)
    doc_topic: jax.Array   # [D, K]
    topic_word: jax.Array  # [K, V]
    topic_total: jax.Array  # [K]
    hypers: Dict[str, jax.Array]  # alpha, gamma, eta

    @property
    def n_topics(self) -> int:
        return self.topic_word.shape[0]

    @property
    def n_docs(self) -> int:
        return self.doc_topic.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.topic_word.shape[1]

    def active_topics(self):
        return jnp.sum(self.topic_total > 0)


def _counts(z, data: TokenData, D, K, V):
    """All three count tables from (z, corpus) via flat-index segment-sums.

    O(T) memory: invalid/padding tokens route to a scratch segment (no
    [T, K] one-hot is ever materialized — at config-4 scale, 50M tokens x
    K would not fit)."""
    valid = data.mask > 0
    zi = jnp.where(valid, z, K)
    ones = jnp.ones_like(data.words, jnp.float32)
    d_safe = jnp.minimum(data.doc_ids, D)
    flat_dk = jnp.where(valid, d_safe * K + zi, D * K)
    dk = jax.ops.segment_sum(
        ones, flat_dk, num_segments=D * K + 1
    )[: D * K].reshape(D, K)
    flat_kw = jnp.where(valid, zi * V + data.words, K * V)
    kw = jax.ops.segment_sum(
        ones, flat_kw, num_segments=K * V + 1,
    )[: K * V].reshape(K, V)
    return dk, kw, jnp.sum(kw, axis=-1)


def initialize(
    view,
    n_topics: int,
    vocab_size: int,
    key,
    alpha: float = 1.0,
    gamma: float = 1.0,
    eta: float = 0.1,
    n_docs: Optional[int] = None,
) -> HDPState:
    """Random z init + one beta draw (lda's state.initialize analog)."""
    validator.validate_positive(n_topics, "n_topics")
    validator.validate_positive(vocab_size, "vocab_size")
    data = token_data(view) if not isinstance(view, TokenData) else view
    D = int(n_docs) if n_docs is not None else int(view.size())
    kz, kb = jax.random.split(key)
    z = jax.random.randint(kz, data.words.shape, 0, n_topics, jnp.int32)
    dk, kw, kt = _counts(z, data, D, n_topics, vocab_size)
    state = HDPState(
        z=z,
        beta=jnp.full(n_topics + 1, 1.0 / (n_topics + 1)),
        doc_topic=dk,
        topic_word=kw,
        topic_total=kt,
        hypers={
            "alpha": jnp.asarray(alpha),
            "gamma": jnp.asarray(gamma),
            "eta": jnp.asarray(eta),
        },
    )
    return sample_beta(state, kb)


# ---------------------------------------------------------------------------
# collapsed direct-assignment Gibbs (oracle)
# ---------------------------------------------------------------------------
@jax.jit
def collapsed_sweep(state: HDPState, data: TokenData, key) -> HDPState:
    """One sequential collapsed sweep over tokens, beta held fixed."""
    K = state.n_topics
    V = state.vocab_size
    alpha = state.hypers["alpha"]
    eta = state.hypers["eta"]
    ab = alpha * state.beta[:K]

    def step(carry, t):
        z, dk, kw, kt = carry
        d = data.doc_ids[t]
        w = data.words[t]
        m = data.mask[t]
        old = z[t]
        onehot_old = jax.nn.one_hot(old, K, dtype=jnp.float32) * m
        dk_t = dk.at[d].add(-onehot_old)
        kw_t = kw.at[old, w].add(-m)
        kt_t = kt - onehot_old

        logp = (
            jnp.log(dk_t[d] + ab)
            + jnp.log(kw_t[:, w] + eta)
            - jnp.log(kt_t + V * eta)
        )
        g = jax.random.gumbel(jax.random.fold_in(key, t), (K,))
        new = jnp.argmax(logp + g).astype(jnp.int32)
        # masked tokens: keep old assignment, counts unchanged
        new = jnp.where(m > 0, new, old)

        onehot_new = jax.nn.one_hot(new, K, dtype=jnp.float32) * m
        dk_t = dk_t.at[d].add(onehot_new)
        kw_t = kw_t.at[new, w].add(m)
        kt_t = kt_t + onehot_new
        return (z.at[t].set(new), dk_t, kw_t, kt_t), None

    (z, dk, kw, kt), _ = jax.lax.scan(
        step,
        (state.z, state.doc_topic, state.topic_word, state.topic_total),
        jnp.arange(data.words.shape[0]),
    )
    return dataclasses.replace(
        state, z=z, doc_topic=dk, topic_word=kw, topic_total=kt
    )


# ---------------------------------------------------------------------------
# beta resampling via CRT table counts
# ---------------------------------------------------------------------------
def crt_sample(key, counts, conc, max_count: int):
    """m ~ CRT(n, a): number of tables from n customers at concentration a.

    m = Σ_{i=0}^{n−1} Bernoulli(a / (a + i)), computed as a masked scan of
    max_count Bernoulli batches (exact; zero counts give zero tables).
    counts/conc broadcast elementwise.
    """
    counts = jnp.asarray(counts)
    conc = jnp.broadcast_to(jnp.asarray(conc), counts.shape)

    def body(m, i):
        p = conc / (conc + i.astype(conc.dtype))
        b = jax.random.bernoulli(jax.random.fold_in(key, i), p)
        return m + jnp.where(i.astype(counts.dtype) < counts, b, False).astype(
            jnp.int32
        ), None

    m, _ = jax.lax.scan(
        body, jnp.zeros(counts.shape, jnp.int32), jnp.arange(max_count)
    )
    return m


@partial(jax.jit, static_argnames=("max_count",))
def _sample_beta_jit(state: HDPState, key, max_count: int) -> HDPState:
    K = state.n_topics
    alpha = state.hypers["alpha"]
    gamma = state.hypers["gamma"]
    km, kb = jax.random.split(key)
    ab = alpha * state.beta[:K]
    m_dk = crt_sample(km, state.doc_topic, ab[None, :], max_count)
    m_k = jnp.sum(m_dk, axis=0).astype(jnp.float32)
    conc = jnp.concatenate([m_k + 1e-8, gamma[None]])
    beta = jax.random.dirichlet(kb, conc)
    # unused topics draw conc ~1e-8 and can underflow to exactly 0, which
    # poisons score_joint (gammaln(alpha*0) = inf); floor + renormalize
    beta = jnp.clip(beta, 1e-12)
    beta = beta / jnp.sum(beta)
    return dataclasses.replace(state, beta=beta)


def sample_beta(state: HDPState, key, max_count: Optional[int] = None):
    """beta | z: CRT table counts per (doc, topic), then Dirichlet.

    (beta_1..K, beta_rest) ~ Dir(m_·1, …, m_·K, gamma) — Teh et al. §5.3.
    max_count caps the CRT scan; defaults to max doc-topic count (host
    round-trip) — pass it explicitly inside jit-ed loops.
    """
    if max_count is None:
        max_count = max(int(jnp.max(state.doc_topic)), 1)
    return _sample_beta_jit(state, key, max_count)


# ---------------------------------------------------------------------------
# concentration resampling (alpha, gamma) — Teh et al. 2006 §6 / appendix A
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("max_count",))
def _sample_concentrations_jit(
    state: HDPState,
    key,
    max_count: int,
    a_alpha: float,
    b_alpha: float,
    a_gamma: float,
    b_gamma: float,
) -> HDPState:
    K = state.n_topics
    alpha = state.hypers["alpha"].astype(jnp.float32)
    gamma = state.hypers["gamma"].astype(jnp.float32)
    km, kw, ks, ka, ke, kp, kg, kb = jax.random.split(key, 8)

    # shared table counts: m_dk ~ CRT(n_dk, alpha*beta_k) — drawn once and
    # reused by alpha, gamma, AND the beta redraw (the §5.3 joint move).
    ab = alpha * state.beta[:K]
    m_dk = crt_sample(km, state.doc_topic, ab[None, :], max_count)
    m_k = jnp.sum(m_dk, axis=0).astype(jnp.float32)
    m_tot = jnp.sum(m_k)

    # --- alpha | m, n  (auxiliary-variable Gibbs, Teh appendix A) ---------
    # p(alpha | m··, n_1..D) ∝ Gamma(alpha; a, b) alpha^{m··}
    #                          Π_d Γ(alpha) / Γ(alpha + n_d)
    # w_d ~ Beta(alpha+1, n_d);  s_d ~ Bernoulli(n_d / (n_d + alpha));
    # alpha ~ Gamma(a + m·· − Σ s_d,  b − Σ log w_d).
    n_d = jnp.sum(state.doc_topic, axis=-1)          # [D] tokens per doc
    has = n_d > 0                                     # empty/pad docs drop out
    n_safe = jnp.maximum(n_d, 1.0)
    w = jax.random.beta(kw, alpha + 1.0, n_safe)
    s = jax.random.bernoulli(ks, n_d / (n_d + alpha))
    sum_log_w = jnp.sum(jnp.where(has, jnp.log(jnp.clip(w, 1e-30)), 0.0))
    sum_s = jnp.sum(jnp.where(has, s, False).astype(jnp.float32))
    new_alpha = jax.random.gamma(ka, a_alpha + m_tot - sum_s) / (
        b_alpha - sum_log_w
    )

    # --- gamma | m  (Escobar–West 1995 on the top-level restaurant: -------
    # m·· customers seated at K⁺ "dishes")
    kplus = jnp.maximum(jnp.sum(m_k > 0).astype(jnp.float32), 1.0)
    m_safe = jnp.maximum(m_tot, 1.0)
    eta = jax.random.beta(ke, gamma + 1.0, m_safe)
    log_eta = jnp.log(jnp.clip(eta, 1e-30))
    odds = (a_gamma + kplus - 1.0) / (m_safe * (b_gamma - log_eta))
    pick_high = jax.random.uniform(kp) < odds / (1.0 + odds)
    shape = jnp.where(pick_high, a_gamma + kplus, a_gamma + kplus - 1.0)
    new_gamma = jax.random.gamma(kg, shape) / (b_gamma - log_eta)

    # --- beta | m, gamma ---------------------------------------------------
    beta = jax.random.dirichlet(
        kb, jnp.concatenate([m_k + 1e-8, new_gamma[None]])
    )
    beta = jnp.clip(beta, 1e-12)  # see _sample_beta_jit: 0 poisons score_joint
    beta = beta / jnp.sum(beta)
    hypers = dict(state.hypers)
    hypers["alpha"] = new_alpha.astype(state.hypers["alpha"].dtype)
    hypers["gamma"] = new_gamma.astype(state.hypers["gamma"].dtype)
    return dataclasses.replace(state, beta=beta, hypers=hypers)


def sample_concentrations(
    state: HDPState,
    key,
    max_count: Optional[int] = None,
    a_alpha: float = 1.0,
    b_alpha: float = 1.0,
    a_gamma: float = 1.0,
    b_gamma: float = 1.0,
) -> HDPState:
    """Resample (alpha, gamma, beta) | z under Gamma(a, b) hyperpriors.

    The reference lda repo holds concentrations fixed per run but Teh et
    al. 2006's scheme (which it implements the state machinery for)
    resamples them; this is the vectorized version: one CRT draw of the
    table counts m_dk feeds (i) the auxiliary-variable alpha move over
    docs, (ii) an Escobar–West gamma move over the top-level restaurant
    (m·· customers, K⁺ dishes), and (iii) the Dirichlet beta redraw —
    all fused in a single jitted program.
    """
    if max_count is None:
        max_count = max(int(jnp.max(state.doc_topic)), 1)
    return _sample_concentrations_jit(
        state, key, max_count,
        float(a_alpha), float(b_alpha), float(a_gamma), float(b_gamma),
    )


# ---------------------------------------------------------------------------
# blocked (uncollapsed) sweep — the parallel perf path
# ---------------------------------------------------------------------------
def _draw_phi_theta(state: HDPState, key):
    from common_tpu.utils import fastrand

    kphi, kth = jax.random.split(key)
    eta = state.hypers["eta"]
    alpha = state.hypers["alpha"]
    K = state.n_topics
    phi = jax.random.dirichlet(kphi, state.topic_word + eta)        # [K, V]
    conc = state.doc_topic + alpha * state.beta[:K][None, :]
    # fixed-rounds Marsaglia-Tsang Dirichlet (utils/fastrand.py): the
    # [D, K] theta draw is 32M small-shape gammas at config-4 scale;
    # fastrand is ~10x cheaper than jax.random's rejection while_loop on
    # an H100 and KS-validated to the same distribution
    # (tests/test_fastrand.py)
    theta = fastrand.dirichlet(kth, conc)                            # [D, K]
    return phi, theta


@partial(jax.jit, static_argnames=("chunk",))
def blocked_sweep(state: HDPState, data: TokenData, key,
                  chunk: Optional[int] = None) -> HDPState:
    """phi, theta | z, then ALL tokens reassigned in parallel.

    chunk: optional token-block size — the [T, K] score table is then
    built blockwise inside a scan so peak memory is [chunk, K] (the
    config-4 path: 50M tokens x K=32 would otherwise need ~6 GB for the
    table alone).  Same sampler either way (per-chunk fold_in keys).
    """
    kd, kz = jax.random.split(key)
    phi, theta = _draw_phi_theta(state, kd)
    log_phi = jnp.log(jnp.clip(phi, 1e-30))     # [K, V]
    log_theta = jnp.log(jnp.clip(theta, 1e-30))  # [D, K]

    D = state.n_docs
    T = data.words.shape[0]
    if chunk is None or chunk >= T:
        logp = (
            log_theta[jnp.minimum(data.doc_ids, D - 1)]  # [T, K]
            + log_phi[:, data.words].T                   # [T, K]
        )
        g = jax.random.gumbel(kz, logp.shape, logp.dtype)
        z = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)
        z = jnp.where(data.mask > 0, z, state.z)
    else:
        pad = (-T) % chunk
        d_ids = jnp.pad(data.doc_ids, (0, pad)).reshape(-1, chunk)
        words = jnp.pad(data.words, (0, pad)).reshape(-1, chunk)
        masks = jnp.pad(data.mask, (0, pad)).reshape(-1, chunk)
        z_olds = jnp.pad(state.z, (0, pad)).reshape(-1, chunk)

        def body(c, blk):
            di, w, m, z_old = blk
            logp = (
                log_theta[jnp.minimum(di, D - 1)]
                + log_phi[:, w].T
            )
            g = jax.random.gumbel(
                jax.random.fold_in(kz, c), logp.shape, logp.dtype
            )
            zc = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)
            return c + 1, jnp.where(m > 0, zc, z_old)

        _, z = jax.lax.scan(body, 0, (d_ids, words, masks, z_olds))
        z = z.reshape(-1)[:T]

    dk, kw, kt = _counts(z, data, D, state.n_topics, state.vocab_size)
    return dataclasses.replace(
        state, z=z, doc_topic=dk, topic_word=kw, topic_total=kt
    )


def densify_corpus(view, max_len: "Optional[int]" = None):
    """(words [D, L], mask [D, L]) from a ragged variadic_dataview.

    Bridges real (ragged) corpora to the dense doc-major fast path
    (`blocked_sweep_dense`, ~3.6x the flat chunked sweep): docs pad to
    L = max(doc length) (or `max_len`, truncating longer docs — only do
    that deliberately).  Worth it when length skew is modest; for
    pathological skew (padding factor >> 2) stay on the flat layout.
    Returns numpy-backed jnp arrays; pair with `dense_token_data` for
    state initialization.
    """
    import numpy as _np

    ptr = _np.asarray(view.row_ptr)
    toks = _np.asarray(view.tokens)
    lens = _np.diff(ptr)
    D = len(lens)
    L = int(lens.max()) if max_len is None else int(max_len)
    # One vectorized scatter (no per-doc Python loop, which costs minutes
    # of host time at 1M docs): token
    # t of doc i lands at flat position i*L + (t - ptr[i]); a single
    # repeat builds that affine shift per token (~6 s at 1M docs / 50M
    # tokens on this box).  Truncation (max_len < longest doc) takes a
    # second repeat to drop overflow tokens — the deliberate-use case.
    keep_len = _np.minimum(lens, L)
    mask = (_np.arange(L)[None, :] < keep_len[:, None]).astype(_np.float32)
    adj = _np.repeat(_np.arange(D, dtype=_np.int64) * L - ptr[:-1], lens)
    dst = _np.arange(len(toks), dtype=_np.int64) + adj
    words = _np.zeros(D * L, _np.int32)
    if (lens > L).any():
        offs = dst - _np.repeat(_np.arange(D, dtype=_np.int64) * L, lens)
        keep = offs < L
        words[dst[keep]] = toks[keep]
    else:
        words[dst] = toks
    return jnp.asarray(words.reshape(D, L)), jnp.asarray(mask)


def dense_token_data(words, mask=None) -> TokenData:
    """TokenData from a rectangular doc-major [D, L] corpus (docs padded to
    equal length; mask 0 = padding).  The flat token order is row-major, so
    a state initialized from this view is layout-compatible with
    `blocked_sweep_dense`."""
    words = jnp.asarray(words, jnp.int32)
    D, L = words.shape
    if mask is None:
        mask = jnp.ones((D, L), jnp.float32)
    doc_ids = jnp.repeat(jnp.arange(D, dtype=jnp.int32), L)
    return TokenData(
        words.reshape(-1), doc_ids, jnp.asarray(mask, jnp.float32).reshape(-1)
    )


@partial(jax.jit, static_argnames=("doc_chunk",))
def blocked_sweep_dense(state: HDPState, words, mask, key,
                       doc_chunk: Optional[int] = None) -> HDPState:
    """Rectangular doc-major fast path of `blocked_sweep`.

    words/mask: [D, L] (docs padded to equal length; the state must have
    been initialized from `dense_token_data(words, mask)` so `state.z` is
    row-major-flat).  Identical sampler — same (phi, theta) draws, same
    per-token conditional — with the per-token theta gather (T rows)
    turned into a per-doc broadcast, and doc_topic from a one-hot
    reduction over L instead of a T-update scatter into D*K segments.
    On an H100 at 100k docs x 50 tokens it is not the faster one (3.7 ms
    against 2.9 ms for `blocked_sweep`; PERF.md).  Peak memory is
    [doc_chunk, L, K].

    doc_chunk=None derives a bounded chunk from (L, K): ~2^26 f32
    elements (256 MB) per intermediate tensor, so the default call stays
    HBM-safe at any corpus size (doc_chunk=D at the config-4 scale
    materializes ~6.4 GB tensors).  Pass an explicit
    doc_chunk to trade memory for fewer scan steps.
    """
    D, L = words.shape
    K, V = state.n_topics, state.vocab_size
    kd, kz = jax.random.split(key)
    phi, theta = _draw_phi_theta(state, kd)
    log_phi_t = jnp.log(jnp.clip(phi, 1e-30)).T      # [V, K] contiguous rows
    log_theta = jnp.log(jnp.clip(theta, 1e-30))      # [D, K]

    if doc_chunk is None:
        doc_chunk = max(1024, (1 << 26) // max(L * K, 1))
    if doc_chunk >= D:
        doc_chunk = D
    pad_d = (-D) % doc_chunk
    wp = jnp.pad(words, ((0, pad_d), (0, 0))).reshape(-1, doc_chunk, L)
    mp = jnp.pad(jnp.asarray(mask, jnp.float32),
                 ((0, pad_d), (0, 0))).reshape(-1, doc_chunk, L)
    zo = jnp.pad(state.z.reshape(D, L),
                 ((0, pad_d), (0, 0))).reshape(-1, doc_chunk, L)
    th = jnp.pad(log_theta, ((0, pad_d), (0, 0))).reshape(-1, doc_chunk, K)

    def body(c, blk):
        w, m, z_old, th_c = blk
        logp = th_c[:, None, :] + log_phi_t[w]        # [dc, L, K]
        g = jax.random.gumbel(
            jax.random.fold_in(kz, c), logp.shape, logp.dtype
        )
        zc = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)
        zc = jnp.where(m > 0, zc, z_old)
        zi = jnp.where(m > 0, zc, K)                  # masked -> discarded
        oh = (zi[..., None] == jnp.arange(K)).astype(jnp.float32)
        return c + 1, (zc, jnp.sum(oh, axis=1))

    _, (z3, dk3) = jax.lax.scan(body, 0, (wp, mp, zo, th))
    z = z3.reshape(-1, L)[:D].reshape(-1)
    dk = dk3.reshape(-1, K)[:D]

    valid = jnp.asarray(mask, jnp.float32).reshape(-1) > 0
    zi = jnp.where(valid, z, K)
    flat_kw = jnp.where(valid, zi * V + words.reshape(-1), K * V)
    kw = jax.ops.segment_sum(
        jnp.ones_like(z, jnp.float32), flat_kw, num_segments=K * V + 1
    )[: K * V].reshape(K, V)
    return dataclasses.replace(
        state, z=z, doc_topic=dk, topic_word=kw,
        topic_total=jnp.sum(kw, axis=-1),
    )


# ---------------------------------------------------------------------------
# multi-device: token-sharded blocked sweep (config-4 layout)
# ---------------------------------------------------------------------------
def shard_corpus(mesh, state: HDPState, data: TokenData):
    """Place the token axis sharded over the mesh's 'data' axis; state
    (count tables, beta) replicated — the 'sharded token counts' layout."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    tok = NamedSharding(mesh, P(mesh.axis_names[-1]))
    rep = NamedSharding(mesh, P())
    data = TokenData(*(jax.device_put(l, tok) for l in data))
    state = jax.tree_util.tree_map(lambda l: jax.device_put(l, rep), state)
    state = dataclasses.replace(state, z=jax.device_put(state.z, tok))
    return state, data


def shard_dense_corpus(mesh, state: HDPState, words, mask):
    """Place a dense [D, L] corpus + state for `make_sharded_sweep_dense`:
    words/mask/z/doc_topic sharded by docs over the mesh's last axis,
    everything else replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[-1]
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    state = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, rep), state
    )
    state = dataclasses.replace(
        state,
        z=jax.device_put(state.z, sh),
        doc_topic=jax.device_put(state.doc_topic, sh),
    )
    return state, jax.device_put(words, sh), jax.device_put(mask, sh)


def make_sharded_sweep_dense(mesh, state: HDPState, words, mask):
    """Multi-chip dense doc-major sweep: DOCS sharded over the mesh's last
    axis (the fast-path analog of `make_sharded_sweep`'s token sharding).

    words/mask: [D, L] rectangular corpus (state initialized from
    `dense_token_data`, so z is row-major-flat and shards into contiguous
    doc blocks).  Per-doc theta draws and the doc_topic table are fully
    shard-local; phi draws replicate (same key on every shard); the
    topic_word/topic_total rebuild is the only collective (`psum` over
    the doc axis, riding ICI).  D must divide by the shard count.
    """
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[-1]
    nsh = mesh.shape[axis]
    D, K, V = state.n_docs, state.n_topics, state.vocab_size
    L = words.shape[1]
    if D % nsh:
        raise ValueError(f"n_docs {D} must divide over {nsh} shards")
    state_spec = dataclasses.replace(
        jax.tree_util.tree_map(lambda _: P(), state),
        z=P(axis), doc_topic=P(axis),
    )

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(state_spec, P(axis), P(axis), P()),
        out_specs=state_spec,
        check_vma=False,
    )
    def sweep(state, w_blk, m_blk, key):
        shard = jax.lax.axis_index(axis)
        kd, kz = jax.random.split(key)
        d_loc = w_blk.shape[0]
        # phi: replicated draw (same key everywhere); theta: local docs
        eta = state.hypers["eta"]
        alpha = state.hypers["alpha"]
        phi = jax.random.dirichlet(
            jax.random.fold_in(kd, 0), state.topic_word + eta
        )
        conc = state.doc_topic + alpha * state.beta[:K][None, :]
        # fastrand: same per-doc theta fast path as _draw_phi_theta
        from common_tpu.utils import fastrand

        theta = fastrand.dirichlet(
            jax.random.fold_in(jax.random.fold_in(kd, 1), shard), conc
        )  # [d_loc, K]
        log_phi_t = jnp.log(jnp.clip(phi, 1e-30)).T  # [V, K]
        log_theta = jnp.log(jnp.clip(theta, 1e-30))

        logp = log_theta[:, None, :] + log_phi_t[w_blk]  # [d_loc, L, K]
        g = jax.random.gumbel(
            jax.random.fold_in(kz, shard), logp.shape, logp.dtype
        )
        zc = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)
        z_old = state.z.reshape(d_loc, L)
        zc = jnp.where(m_blk > 0, zc, z_old)

        zi = jnp.where(m_blk > 0, zc, K)
        oh = (zi[..., None] == jnp.arange(K)).astype(jnp.float32)
        dk = jnp.sum(oh, axis=1)  # [d_loc, K] — shard-local

        valid = m_blk.reshape(-1) > 0
        zf = zc.reshape(-1)
        flat_kw = jnp.where(valid, zf * V + w_blk.reshape(-1), K * V)
        kw = jax.ops.segment_sum(
            jnp.ones_like(zf, jnp.float32), flat_kw,
            num_segments=K * V + 1,
        )[: K * V].reshape(K, V)
        kw = jax.lax.psum(kw, axis)
        return dataclasses.replace(
            state, z=zf, doc_topic=dk, topic_word=kw,
            topic_total=jnp.sum(kw, axis=-1),
        )

    return sweep


def make_sharded_sweep(mesh, state: HDPState, data: TokenData):
    """Jitted multi-chip blocked sweep: local token reassignment + psum'd
    count-table rebuild over the 'data' mesh axis (ICI collective)."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[-1]
    state_spec = dataclasses.replace(
        jax.tree_util.tree_map(lambda _: P(), state), z=P(axis)
    )
    data_spec = TokenData(P(axis), P(axis), P(axis))
    out_spec = state_spec
    D, K, V = state.n_docs, state.n_topics, state.vocab_size

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(state_spec, data_spec, P()),
        out_specs=out_spec,
        check_vma=False,
    )
    def sweep(state, data_blk, key):
        kd, kz = jax.random.split(key)
        # same key on every shard -> identical replicated phi/theta draws
        phi, theta = _draw_phi_theta(state, kd)
        log_phi = jnp.log(jnp.clip(phi, 1e-30))
        log_theta = jnp.log(jnp.clip(theta, 1e-30))
        logp = (
            log_theta[jnp.minimum(data_blk.doc_ids, D - 1)]
            + log_phi[:, data_blk.words].T
        )
        shard = jax.lax.axis_index(axis)
        g = jax.random.gumbel(
            jax.random.fold_in(kz, shard), logp.shape, logp.dtype
        )
        z = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)
        z = jnp.where(data_blk.mask > 0, z, state.z)

        dk, kw, kt = _counts(z, data_blk, D, K, V)
        dk = jax.lax.psum(dk, axis)
        kw = jax.lax.psum(kw, axis)
        kt = jax.lax.psum(kt, axis)
        return dataclasses.replace(
            state, z=z, doc_topic=dk, topic_word=kw, topic_total=kt
        )

    return sweep


# ---------------------------------------------------------------------------
# scoring / diagnostics
# ---------------------------------------------------------------------------
def score_joint(state: HDPState) -> jax.Array:
    """log p(z, w | beta, hypers): Dirichlet-multinomial in both blocks.

    Σ_d log DM(n_d· | alpha*beta) + Σ_k log DM(n_k· | eta·1_V) — the
    joint-score trace (reference's score_assignment+score_data analog).
    """
    K = state.n_topics
    V = state.vocab_size
    alpha = state.hypers["alpha"]
    eta = state.hypers["eta"]
    ab = alpha * state.beta[:K]

    dk = state.doc_topic
    nd = jnp.sum(dk, axis=-1)
    a0 = jnp.sum(ab)
    doc_term = jnp.sum(
        gammaln(a0) - gammaln(a0 + nd)
        + jnp.sum(gammaln(dk + ab[None, :]) - gammaln(ab)[None, :], axis=-1)
    )
    kw = state.topic_word
    word_term = jnp.sum(
        gammaln(V * eta) - gammaln(V * eta + state.topic_total)
        + jnp.sum(gammaln(kw + eta) - gammaln(eta), axis=-1)
    )
    return doc_term + word_term


def perplexity(state: HDPState, data: TokenData) -> jax.Array:
    """exp(−mean predictive log-lik per token) under posterior-mean phi/theta."""
    K = state.n_topics
    eta = state.hypers["eta"]
    alpha = state.hypers["alpha"]
    phi = (state.topic_word + eta) / (
        state.topic_total + state.vocab_size * eta
    )[:, None]
    conc = state.doc_topic + alpha * state.beta[:K][None, :]
    theta = conc / jnp.sum(conc, axis=-1, keepdims=True)
    D = state.n_docs
    p = jnp.sum(
        theta[jnp.minimum(data.doc_ids, D - 1)] * phi[:, data.words].T, axis=-1
    )
    ll = jnp.sum(jnp.log(jnp.clip(p, 1e-30)) * data.mask)
    return jnp.exp(-ll / jnp.maximum(jnp.sum(data.mask), 1.0))
