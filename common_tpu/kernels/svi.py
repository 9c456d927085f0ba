"""Stochastic variational inference for DP mixtures (truncated sticks).

No reference analog: the reference is MCMC-only; SVI is a north-star
requirement (BASELINE.json: "stochastic VI").

Mean-field family (Blei & Jordan 2006 truncation; Hoffman et al. 2013
natural-gradient updates):

  q(v_k)    = Beta(a_k, b_k),  k < K−1;  v_{K−1} ≡ 1   (stick truncation)
  q(theta_k) = conjugate family at posterior_hyper(prior, vstats_k)
              — i.e. the variational state *is* a pseudo-suffstat pytree,
              so a natural-gradient step is a convex blend of suffstats:
                 vstats ← (1−ρ)·vstats + ρ·(N/B)·Σ_batch r_nk·t(x_n)
  q(z_n)    = Categorical(r_n)  (local; recomputed each E-step)

All expectations (E[log p(x|θ)], KL(q‖prior)) come generically from the
likelihoods' exponential-family structure via likelihoods/expfam.py —
autodiff of each family's log-partition; nothing here is model-specific.
The E-step is one [N|B, K] table per feature built by a single matmul
(suffstats × expected natural params → matrix units), making minibatch SVI the
cheapest per-row kernel in the framework.

The full-batch, ρ=1 special case is exact CAVI: coordinate ascent on the
ELBO, which `elbo()` computes exactly (and tests assert is monotone).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import betaln, digamma, gammaln

from common_tpu import state as state_mod
from common_tpu import validator
from common_tpu.likelihoods import base as lik_base
from common_tpu.likelihoods import expfam
from common_tpu.state import MixtureState


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SVIPosterior:
    """Variational posterior over (sticks/weights, cluster params).

    stick_a/stick_b: [K−1] Beta params of q(v_k) (DP mode), or
    dir_conc: [K] Dirichlet concentration of q(w) (fixed-K mode).
    vstats: per-feature pseudo-suffstat pytrees with leading [K].
    """

    stick_a: jax.Array
    stick_b: jax.Array
    dir_conc: jax.Array
    vstats: Tuple[Dict[str, Any], ...]
    hypers: Tuple[Dict[str, Any], ...]
    cluster_hp: Dict[str, Any]
    lik_names: Tuple[str, ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    fixed: bool = dataclasses.field(metadata=dict(static=True), default=False)

    @property
    def k_max(self) -> int:
        return self.dir_conc.shape[-1]

    def likelihoods(self):
        return tuple(lik_base.get(n) for n in self.lik_names)


def _check_expfam(defn):
    for m in defn.models:
        if not m.likelihood.has_expfam:
            raise ValueError(
                f"SVI requires conjugate exponential-family structure; "
                f"{m.likelihood.name!r} does not provide it"
            )


def init(
    defn,
    data,
    key,
    cluster_hp: Optional[Dict[str, Any]] = None,
    feature_hps: Optional[Sequence[Dict[str, Any]]] = None,
    fixed: bool = False,
    init_scale: float = 1.0,
) -> SVIPosterior:
    """Random soft-assignment init (breaks cluster symmetry).

    Draws r ~ softmax(Gumbel) per row, then runs one full M-step from it —
    the variational analog of state.initialize's CRP prior draw.
    """
    _check_expfam(defn)
    validator.validate_len(data, defn.nfeatures, "data columns")
    K = defn.k_max
    hypers = tuple(
        desc.canonical_hyper(None if feature_hps is None else feature_hps[f])
        for f, desc in enumerate(defn.models)
    )
    if fixed:
        chp = {"alphas": jnp.asarray(
            (cluster_hp or {}).get("alphas", np.ones(K, np.float32))
        )}
    else:
        chp = {"alpha": jnp.asarray((cluster_hp or {}).get("alpha", 1.0))}

    g = jax.random.gumbel(key, (defn.n, K)) * init_scale
    r = jax.nn.softmax(g)
    post = SVIPosterior(
        stick_a=jnp.ones(max(K - 1, 1)),
        stick_b=jnp.ones(max(K - 1, 1)),
        dir_conc=jnp.ones(K),
        vstats=tuple(
            m.likelihood.init_stats(h, (K,))
            for m, h in zip(defn.models, hypers)
        ),
        hypers=hypers,
        cluster_hp=chp,
        lik_names=tuple(m.name for m in defn.models),
        fixed=fixed,
    )
    return update(post, data, r, rho=1.0, scale=1.0)


# ---------------------------------------------------------------------------
# expectations
# ---------------------------------------------------------------------------
def expected_log_weights(post: SVIPosterior):
    """[K] E_q[log w_k]."""
    if post.fixed:
        c = post.dir_conc
        return digamma(c) - digamma(jnp.sum(c))
    if post.k_max == 1:
        return jnp.zeros(1)
    a, b = post.stick_a, post.stick_b
    elog_v = digamma(a) - digamma(a + b)          # [K-1]
    elog_1mv = digamma(b) - digamma(a + b)        # [K-1]
    cum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(elog_1mv)])  # [K]
    return cum + jnp.concatenate([elog_v, jnp.zeros(1)])


def responsibilities(post: SVIPosterior, data):
    """E-step: [N, K] soft assignments from expected scores."""
    logp = expected_log_weights(post)[None, :]
    for (x, mask), lik, hyper, vs in zip(
        data, post.likelihoods(), post.hypers, post.vstats
    ):
        q_k = lik.posterior_hyper(hyper, vs)
        logp = logp + expfam.expected_loglik_table(
            lik, hyper, q_k, x, jnp.asarray(mask, jnp.float32)
        )
    return jax.nn.softmax(logp, axis=-1), logp


# ---------------------------------------------------------------------------
# M-step / natural-gradient update
# ---------------------------------------------------------------------------
def update(post: SVIPosterior, data, r, rho, scale=1.0) -> SVIPosterior:
    """Blend new (scaled) global params in at rate rho (rho=1 → CAVI)."""
    K = post.k_max
    nk = scale * jnp.sum(r, axis=0)  # [K]

    if not post.fixed and K > 1:
        alpha = post.cluster_hp["alpha"].astype(jnp.float32)
        tail = (jnp.cumsum(nk[::-1])[::-1] - nk)[: K - 1]  # Σ_{j>k} n_j
        new_a = 1.0 + nk[: K - 1]
        new_b = alpha + tail
        stick_a = (1.0 - rho) * post.stick_a + rho * new_a
        stick_b = (1.0 - rho) * post.stick_b + rho * new_b
    else:
        stick_a, stick_b = post.stick_a, post.stick_b

    if post.fixed:
        new_conc = post.cluster_hp["alphas"] + nk
        dir_conc = (1.0 - rho) * post.dir_conc + rho * new_conc
    else:
        dir_conc = post.dir_conc

    new_vstats = []
    for (x, mask), lik, hyper, vs in zip(
        data, post.likelihoods(), post.hypers, post.vstats
    ):
        s_new = lik.stats_from_weights(
            hyper, x, jnp.asarray(mask, jnp.float32), r
        )
        new_vstats.append(
            jax.tree_util.tree_map(
                lambda old, new: (1.0 - rho) * old + rho * scale * new,
                vs, s_new,
            )
        )
    return dataclasses.replace(
        post, stick_a=stick_a, stick_b=stick_b, dir_conc=dir_conc,
        vstats=tuple(new_vstats),
    )


# ---------------------------------------------------------------------------
# ELBO (exact, full batch)
# ---------------------------------------------------------------------------
def _beta_kl(a, b, a0, b0):
    """KL(Beta(a,b) ‖ Beta(a0,b0)) elementwise."""
    return (
        betaln(a0, b0) - betaln(a, b)
        + (a - a0) * digamma(a)
        + (b - b0) * digamma(b)
        + (a0 - a + b0 - b) * digamma(a + b)
    )


def _dirichlet_kl(c, c0):
    """KL(Dir(c) ‖ Dir(c0)) over the last axis."""
    cs, c0s = jnp.sum(c, -1), jnp.sum(c0, -1)
    return (
        gammaln(cs) - gammaln(c0s)
        + jnp.sum(gammaln(c0) - gammaln(c), -1)
        + jnp.sum((c - c0) * (digamma(c) - digamma(cs)[..., None]), -1)
    )


def elbo(post: SVIPosterior, data):
    """Exact ELBO at the optimal local q(z) for the current global q."""
    r, logp = responsibilities(post, data)
    # local term: Σ_n log Σ_k exp(logp_nk) == Σ r(logp − log r) at optimum
    local = jnp.sum(jax.scipy.special.logsumexp(logp, axis=-1))

    kl_global = jnp.zeros(())
    if post.fixed:
        kl_global += _dirichlet_kl(post.dir_conc, post.cluster_hp["alphas"])
    elif post.k_max > 1:
        alpha = post.cluster_hp["alpha"].astype(jnp.float32)
        kl_global += jnp.sum(
            _beta_kl(post.stick_a, post.stick_b,
                     jnp.ones_like(post.stick_a), alpha)
        )
    for lik, hyper, vs in zip(post.likelihoods(), post.hypers, post.vstats):
        q_k = lik.posterior_hyper(hyper, vs)
        kl_global += jnp.sum(expfam.kl_k(lik, q_k, hyper))
    return local - kl_global


# ---------------------------------------------------------------------------
# fit loops
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("n_iters",))
def fit_cavi(post: SVIPosterior, data, n_iters: int):
    """Full-batch CAVI: n_iters coordinate-ascent steps; returns ELBO trace."""

    def step(p, _):
        r, _ = responsibilities(p, data)
        p = update(p, data, r, rho=1.0, scale=1.0)
        return p, elbo(p, data)

    return jax.lax.scan(step, post, None, length=n_iters)


@partial(jax.jit, static_argnames=("n_iters", "batch_size", "kappa", "tau"))
def fit_svi(post: SVIPosterior, data, key, n_iters: int, batch_size: int,
            kappa: float = 0.7, tau: float = 10.0):
    """Minibatch natural-gradient SVI with ρ_t = (t + τ)^(−κ)."""
    n = data[0][0].shape[0]
    scale = n / batch_size

    def step(p, t):
        kt = jax.random.fold_in(key, t)
        idx = jax.random.randint(kt, (batch_size,), 0, n)
        batch = tuple(
            (x[idx], jnp.asarray(mask, jnp.float32)[idx]) for x, mask in data
        )
        r, _ = responsibilities(p, batch)
        rho = (t.astype(jnp.float32) + tau) ** (-kappa)
        p = update(p, batch, r, rho=rho, scale=scale)
        return p, rho

    return jax.lax.scan(step, post, jnp.arange(n_iters))


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------
def to_state(post: SVIPosterior, data) -> MixtureState:
    """Hard-assignment MixtureState (argmax r) for query/checkpoint interop."""
    r, _ = responsibilities(post, data)
    z = jnp.argmax(r, axis=-1).astype(jnp.int32)
    K = post.k_max
    counts = jax.ops.segment_sum(
        jnp.ones_like(z), z, num_segments=K
    ).astype(jnp.int32)
    stats = []
    for (x, mask), lik, hyper in zip(data, post.likelihoods(), post.hypers):
        stats.append(lik.stats_from_assignments(
            hyper, x, jnp.asarray(mask, jnp.float32), z, K
        ))
    chp = (
        {"alphas": post.cluster_hp["alphas"]} if post.fixed
        else {"alpha": post.cluster_hp["alpha"]}
    )
    return MixtureState(
        assignments=z, counts=counts, cluster_hp=chp, stats=tuple(stats),
        hypers=post.hypers, lik_names=post.lik_names, fixed=post.fixed,
    )


def predictive_logpdf(post: SVIPosterior, data_row):
    """log p(x_new) under the variational posterior predictive mixture.

    Uses E_q[w_k] weights and each cluster's exact posterior predictive at
    the variational pseudo-stats (the standard VB predictive).
    """
    if post.fixed:
        w = post.dir_conc / jnp.sum(post.dir_conc)
    else:
        a, b = post.stick_a, post.stick_b
        ev = a / (a + b)
        cum = jnp.concatenate([jnp.ones(1), jnp.cumprod(1.0 - ev)])
        w = cum * jnp.concatenate([ev, jnp.ones(1)])
    logp = jnp.log(jnp.clip(w, 1e-30))
    for (x, mask), lik, hyper, vs in zip(
        data_row, post.likelihoods(), post.hypers, post.vstats
    ):
        s = lik.pred_logpdf(hyper, vs, x)
        logp = logp + s * jnp.asarray(mask, s.dtype)
    return jax.scipy.special.logsumexp(logp)
