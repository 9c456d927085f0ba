"""Online variational LDA (Hoffman, Blei & Bach 2010) — topic-family SVI.

No reference analog (the lda sibling repo is MCMC-only; SVI is a
north-star requirement).  Mean-field family over a B-doc minibatch:

  q(phi_k)   = Dirichlet(lam_k)          global topic-word      [K, V]
  q(theta_d) = Dirichlet(gamma_d)        local doc-topic        [B, K]
  q(z_dn)    = Cat(phi*)                 implicit (optimal form)

Vectorized design: the per-doc E-step is expressed entirely as [B, K] x
[K, V] matmuls on dense bag-of-words count blocks — Hoffman's
sparse-word trick trades FLOPs for gather-heavy control flow, which is
exactly backwards on matrix units.  One inner iteration is

  norm  = exp(Elogtheta) @ exp(Elogbeta)            [B, V]
  gamma = alpha + exp(Elogtheta) * ((c / norm) @ exp(Elogbeta).T)

and the topic-word statistics come from one more matmul.  The natural-
gradient global step is the usual convex blend
lam <- (1-rho) lam + rho (eta + (D/B) sstats).

`fit_cavi` (full batch, rho=1) maximizes the same bound by coordinate
ascent — the correctness oracle the tests drive (bound increases, topics
recovered); `fit_svi` is the minibatch production path.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

from common_tpu import validator


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LDAPosterior:
    """Variational LDA posterior: q(phi) Dirichlet rows + fixed priors."""

    lam: jax.Array    # [K, V]
    alpha: jax.Array  # [K] doc-topic prior
    eta: jax.Array    # scalar topic-word prior

    @property
    def n_topics(self) -> int:
        return self.lam.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.lam.shape[1]

    def topics(self):
        """Posterior-mean topic-word distributions [K, V]."""
        return self.lam / jnp.sum(self.lam, axis=-1, keepdims=True)


def init(n_topics: int, vocab_size: int, key,
         alpha: float = 0.5, eta: float = 0.1) -> LDAPosterior:
    """Random Gamma(100, 100) init of lam (Hoffman's initialization)."""
    validator.validate_positive(n_topics, "n_topics")
    validator.validate_positive(vocab_size, "vocab_size")
    lam = jax.random.gamma(key, 100.0, (n_topics, vocab_size)) / 100.0
    return LDAPosterior(
        lam=lam,
        alpha=jnp.full(n_topics, float(alpha)),
        eta=jnp.asarray(float(eta)),
    )


def doc_term_matrix(view, vocab_size: int, n_docs: Optional[int] = None):
    """[D, V] bag-of-words counts from a variadic dataview / TokenData."""
    from common_tpu.topic.hdp import TokenData, token_data

    data = view if isinstance(view, TokenData) else token_data(view)
    D = int(n_docs) if n_docs is not None else int(jnp.max(data.doc_ids)) + 1
    valid = data.mask > 0
    flat = jnp.where(
        valid, jnp.minimum(data.doc_ids, D) * vocab_size + data.words,
        D * vocab_size,
    )
    return jax.ops.segment_sum(
        jnp.ones_like(data.words, jnp.float32), flat,
        num_segments=D * vocab_size + 1,
    )[: D * vocab_size].reshape(D, vocab_size)


def _dir_elog(conc):
    """E[log x] under Dirichlet(conc) along the last axis."""
    return digamma(conc) - digamma(jnp.sum(conc, axis=-1, keepdims=True))


def _e_step(elog_beta, counts, alpha, n_inner):
    """Optimal (gamma, sstats) for a count block given E[log beta].

    Returns gamma [B, K] and sstats [K, V] (phi-weighted counts)."""
    e_beta = jnp.exp(elog_beta)                       # [K, V]
    B = counts.shape[0]
    gamma0 = alpha[None, :] + jnp.sum(counts, -1, keepdims=True) / alpha.shape[0]

    def body(gamma, _):
        e_theta = jnp.exp(_dir_elog(gamma))           # [B, K]
        norm = e_theta @ e_beta + 1e-30               # [B, V]
        gamma = alpha[None, :] + e_theta * ((counts / norm) @ e_beta.T)
        return gamma, None

    gamma, _ = jax.lax.scan(body, gamma0, None, length=n_inner)
    e_theta = jnp.exp(_dir_elog(gamma))
    norm = e_theta @ e_beta + 1e-30
    sstats = e_beta * (e_theta.T @ (counts / norm))   # [K, V]
    return gamma, sstats


@partial(jax.jit, static_argnames=("n_inner",))
def step(post: LDAPosterior, counts, total_docs, rho,
         n_inner: int = 25) -> LDAPosterior:
    """One natural-gradient SVI step on a [B, V] count block."""
    elog_beta = _dir_elog(post.lam)
    B = counts.shape[0]
    _, sstats = _e_step(elog_beta, counts, post.alpha, n_inner)
    lam_hat = post.eta + (total_docs / B) * sstats
    lam = (1.0 - rho) * post.lam + rho * lam_hat
    return dataclasses.replace(post, lam=lam)


@partial(jax.jit, static_argnames=("n_inner",))
def bound(post: LDAPosterior, counts, total_docs=None, n_inner: int = 25):
    """Variational bound on log p(counts) for the block (Hoffman's form).

    With total_docs given, the global KL term is scaled by D/B so
    minibatch bounds are comparable across batch sizes.
    """
    elog_beta = _dir_elog(post.lam)
    gamma, _ = _e_step(elog_beta, counts, post.alpha, n_inner)
    elog_theta = _dir_elog(gamma)
    # E_q[log p(w | theta, beta)] with optimal q(z): sum c log phinorm
    phinorm = jnp.exp(elog_theta) @ jnp.exp(elog_beta) + 1e-30
    ll = jnp.sum(counts * jnp.log(phinorm))
    # E[log p(theta|alpha)] - E[log q(theta|gamma)]
    a = post.alpha
    theta_term = jnp.sum(
        gammaln(jnp.sum(a)) - jnp.sum(gammaln(a))
        + jnp.sum((a[None, :] - gamma) * elog_theta, -1)
        + jnp.sum(gammaln(gamma), -1) - gammaln(jnp.sum(gamma, -1))
    )
    # E[log p(beta|eta)] - E[log q(beta|lam)]
    V = post.vocab_size
    eta = post.eta
    beta_term = jnp.sum(
        gammaln(V * eta) - V * gammaln(eta)
        + jnp.sum((eta - post.lam) * elog_beta, -1)
        + jnp.sum(gammaln(post.lam), -1)
        - gammaln(jnp.sum(post.lam, -1))
    )
    B = counts.shape[0]
    scale = 1.0 if total_docs is None else B / total_docs
    return ll + theta_term + scale * beta_term


def fit_cavi(post: LDAPosterior, counts, n_iters: int,
             n_inner: int = 25) -> LDAPosterior:
    """Full-batch coordinate ascent (rho=1): the correctness oracle."""
    D = counts.shape[0]

    @partial(jax.jit, static_argnames=())
    def run(post):
        def body(p, _):
            p = step(p, counts, D, 1.0, n_inner=n_inner)
            return p, bound(p, counts, n_inner=n_inner)

        return jax.lax.scan(body, post, None, length=n_iters)

    return run(post)


def fit_svi(post: LDAPosterior, counts, key, n_iters: int, batch_size: int,
            tau0: float = 64.0, kappa: float = 0.7,
            n_inner: int = 25) -> LDAPosterior:
    """Minibatch natural-gradient SVI with rho_t = (tau0 + t)^-kappa."""
    D = counts.shape[0]
    validator.validate_in_range(kappa, 0.5, 1.0, "kappa")

    @jax.jit
    def run(post, key):
        def body(p, t):
            idx = jax.random.randint(
                jax.random.fold_in(key, t), (batch_size,), 0, D
            )
            rho = (tau0 + t.astype(jnp.float32)) ** (-kappa)
            p = step(p, counts[idx], D, rho, n_inner=n_inner)
            return p, None

        return jax.lax.scan(body, post, jnp.arange(n_iters))[0]

    return run(post, key)


def perplexity(post: LDAPosterior, counts, n_inner: int = 25):
    """exp(− bound / total token count) on a held-out count block."""
    total = jnp.maximum(jnp.sum(counts), 1.0)
    return jnp.exp(-bound(post, counts, n_inner=n_inner) / total)
