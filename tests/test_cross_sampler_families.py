"""Cross-sampler posterior agreement for the IRM and HDP families.

DPMM already has a moderate-scale cross-sampler
agreement test (tests/test_cross_sampler.py); IRM and HDP each carry two
independently-implemented samplers (exact collapsed Gibbs + blocked
uncollapsed) that until now only agreed on tiny-n enumeration problems.
These tests pin their agreement on posterior summaries at a scale where
enumeration is impossible, in the same style: label-invariant
co-assignment / co-topic frequency matrices within ~2x MC error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from common_tpu import models, relational, topic
from common_tpu.data.sparse import sparse_ndarray_dataview
from common_tpu.relational import kernels as irm_kernels


def _mean_coassign(zs):
    zs = np.asarray(zs)
    co = np.zeros((zs.shape[1], zs.shape[1]))
    for z in zs:
        co += z[:, None] == z[None, :]
    return co / len(zs)


@pytest.mark.slow
def test_irm_collapsed_blocked_agree():
    """Collapsed vs blocked IRM on a planted 3-block 72x72 relation."""
    r = np.random.default_rng(0)
    n = 72
    zt = np.repeat(np.arange(3), n // 3)
    p = np.where(zt[:, None] == zt[None, :], 0.75, 0.25)
    rel = (r.random((n, n)) < p).astype(np.float32)

    defn = relational.model_definition([n], [((0, 0), models.bb)], k_max=8)
    views = relational.as_views([sparse_ndarray_dataview(dense=rel)])
    burn_c, keep_c = 30, 80
    burn_b, keep_b = 100, 300

    s = relational.initialize(
        defn, views, jax.random.key(0), cluster_hps=[{"alpha": 1.0}]
    )

    @jax.jit
    def collapsed_chain(s, key):
        def body(state, k):
            state = irm_kernels._assign_jit(state, views, k, 0)
            return state, state.assignments[0]

        return jax.lax.scan(body, s, jax.random.split(key, burn_c + keep_c))

    _, trace_c = collapsed_chain(s, jax.random.key(1))
    co_c = _mean_coassign(np.asarray(trace_c)[burn_c:])

    s = relational.initialize(
        defn, views, jax.random.key(2), cluster_hps=[{"alpha": 1.0}]
    )
    self_rel = (True,)

    @jax.jit
    def blocked_chain(s, key):
        def body(state, k):
            state = irm_kernels._sweep_jit(state, views, k, self_rel)
            return state, state.assignments[0]

        return jax.lax.scan(body, s, jax.random.split(key, burn_b + keep_b))

    _, trace_b = blocked_chain(s, jax.random.key(3))
    co_b = _mean_coassign(np.asarray(trace_b)[burn_b:])

    d = np.abs(co_c - co_b).mean()
    assert d < 0.06, d
    # both recover the planted blocks (sanity floor)
    truth = zt[:, None] == zt[None, :]
    for co in (co_c, co_b):
        assert ((co > 0.5) == truth).mean() > 0.9


@pytest.mark.slow
def test_hdp_collapsed_blocked_agree():
    """Collapsed vs blocked HDP-LDA on a 400-doc corpus: word-level
    topic-co-occurrence and posterior-mean perplexity agreement.

    Token-level co-assignment is too sticky for a useful bound (measured
    round 4: single-chain same-SAMPLER runs disagree by ~0.05 on it), so
    the matrix summary aggregates to the vocabulary level — for each kept
    sweep, row-normalized word-topic counts A [V, K], co = A Aᵀ — and two
    chains per sampler are averaged.  Measured noise floor of that
    estimator: ~0.03 within-sampler, ~0.05 cross (mixing-mode noise);
    bound 0.08 still catches a wrong sampler (~0.3+).  Perplexity is the
    tight scalar check (measured cross-sampler gap ~0.5%)."""
    r = np.random.default_rng(1)
    D, L, K, V = 400, 12, 8, 60
    kb = 3  # planted topic blocks
    topic_of_doc = np.arange(D) % kb
    block = V // kb
    words_np = (
        topic_of_doc[:, None] * block
        + r.integers(0, block, size=(D, L))
    ).astype(np.int32)
    words = jnp.asarray(words_np)
    mask = jnp.ones((D, L), jnp.float32)
    data = topic.dense_token_data(words, mask)
    wflat = words_np.reshape(-1)

    def word_cotopic(zs):
        co = np.zeros((V, V))
        for z in zs:
            A = np.zeros((V, K))
            np.add.at(A, (wflat, z), 1.0)
            A /= np.maximum(A.sum(1, keepdims=True), 1)
            co += A @ A.T
        return co / len(zs)

    def run_sampler(sampler, burn, keep, seed):
        cos, ppls = [], []
        for c in range(2):
            state = topic.initialize(
                data, K, V, jax.random.key(seed + 17 * c), n_docs=D
            )

            @jax.jit
            def chain(state, key):
                def body(st_, k):
                    if sampler == "collapsed":
                        st_ = topic.collapsed_sweep(st_, data, k)
                    else:
                        st_ = topic.blocked_sweep_dense(st_, words, mask, k)
                    st_ = topic.hdp._sample_beta_jit(
                        st_, jax.random.fold_in(k, 1), L
                    )
                    return st_, (st_.z, topic.perplexity(st_, data))

                return jax.lax.scan(
                    body, state, jax.random.split(key, burn + keep)
                )

            _, (tr, ppl) = chain(state, jax.random.key(seed + 17 * c + 5))
            cos.append(word_cotopic(np.asarray(tr)[burn:]))
            ppls.append(float(np.asarray(ppl)[burn:].mean()))
        return (cos[0] + cos[1]) / 2, float(np.mean(ppls))

    co_c, ppl_c = run_sampler("collapsed", 40, 200, 0)
    co_b, ppl_b = run_sampler("blocked", 80, 400, 100)

    d = np.abs(co_c - co_b).mean()
    assert d < 0.08, d
    # posterior-mean per-token perplexity within 1.5% (tight scalar check)
    assert abs(ppl_c - ppl_b) / ppl_c < 0.015, (ppl_c, ppl_b)
    # both recover the planted vocabulary blocks
    wt = np.arange(V) // block
    truth = wt[:, None] == wt[None, :]
    for co in (co_c, co_b):
        assert ((co > 0.5) == truth).mean() > 0.9
