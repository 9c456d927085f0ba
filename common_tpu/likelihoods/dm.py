"""Dirichlet–Multinomial likelihood (conjugate; rows are count vectors).

Reference analog: ``common:include/microscopes/models/dm.hpp`` (one of the
models implemented directly in the reference rather than adapted from the
`distributions` lib), surfaced as the ``dm(n)`` descriptor in
``common:microscopes/models.py``.

Data: per-row count vector x [C] with total m = Σx.  Suffstats:
(n rows, counts[C], sum_log_coef = Σ_rows log multinomial coefficient).
Hyper: alphas [C].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from common_tpu.likelihoods import base


def _log_multinomial_coef(x):
    m = jnp.sum(x, axis=-1)
    return gammaln(m + 1.0) - jnp.sum(gammaln(x + 1.0), axis=-1)


class DM(base.Likelihood):
    name = "dm"
    conjugate = True
    has_expfam = True

    # conjugate exponential family: T(pi) = log pi (same family as dd)
    def posterior_hyper(self, hyper, stats):
        return {"alphas": hyper["alphas"] + stats["counts"]}

    def nat_params(self, hyper):
        return {"e": hyper["alphas"] - 1.0}

    def log_partition(self, nat):
        a = nat["e"] + 1.0
        return jnp.sum(gammaln(a), axis=-1) - gammaln(jnp.sum(a, axis=-1))

    def suffstat_pair(self, hyper, x, mask):
        m = jnp.asarray(mask, jnp.float32)
        return {"e": m * jnp.asarray(x, jnp.float32)}

    def log_h(self, hyper, x, mask):
        m = jnp.asarray(mask, jnp.float32)
        return m * _log_multinomial_coef(jnp.asarray(x, jnp.float32))

    def default_hyper(self):
        return {"alphas": jnp.ones(2)}

    def init_stats(self, hyper, batch_shape):
        c = hyper["alphas"].shape[-1]
        z = jnp.zeros(batch_shape, jnp.float32)
        return {
            "n": z,
            "counts": jnp.zeros((*batch_shape, c), jnp.float32),
            "sum_log_coef": z,
        }

    def tx(self, hyper, x, mask):
        m = jnp.asarray(mask, jnp.float32)
        xf = jnp.asarray(x, jnp.float32)
        return {
            "n": m,
            "counts": m * xf,
            "sum_log_coef": m * _log_multinomial_coef(xf),
        }

    def marginal_loglik(self, hyper, stats):
        a = hyper["alphas"]
        cnt = stats["counts"]
        a0 = jnp.sum(a, axis=-1)
        total = jnp.sum(cnt, axis=-1)
        return (
            stats["sum_log_coef"]
            + jnp.sum(gammaln(a + cnt) - gammaln(a), axis=-1)
            + gammaln(a0)
            - gammaln(a0 + total)
        )

    def pred_logpdf(self, hyper, stats, x):
        a_n = hyper["alphas"] + stats["counts"]
        xf = jnp.asarray(x, jnp.float32)
        m = jnp.sum(xf, axis=-1)
        a0_n = jnp.sum(a_n, axis=-1)
        return (
            _log_multinomial_coef(xf)
            + jnp.sum(gammaln(a_n + xf) - gammaln(a_n), axis=-1)
            + gammaln(a0_n)
            - gammaln(a0_n + m)
        )

    def sample_params(self, key, hyper, stats):
        a_n = hyper["alphas"] + stats["counts"]
        return {"logp": jnp.log(jax.random.dirichlet(key, a_n))}

    def logpdf(self, theta, x):
        xf = jnp.asarray(x, jnp.float32)
        return _log_multinomial_coef(xf) + jnp.sum(theta["logp"] * xf, axis=-1)

    def logpdf_batch(self, theta, X, mask):
        # [N, C] @ [C, K] — a real matmul for bag-of-words data
        xf = jnp.asarray(X, jnp.float32)
        out = _log_multinomial_coef(xf)[:, None] + xf @ theta["logp"].T
        return out * mask[:, None]

    def sample_value(self, key, theta, total_count: int = 1):
        # multinomial draw via repeated categorical (total_count static)
        idx = jax.random.categorical(
            key, theta["logp"], axis=-1,
            shape=(total_count, *theta["logp"].shape[:-1]),
        )
        c = theta["logp"].shape[-1]
        onehot = jax.nn.one_hot(idx, c, dtype=jnp.float32)
        return jnp.sum(onehot, axis=0)

    def prior_logpdf(self, hyper, theta):
        a = hyper["alphas"]
        a0 = jnp.sum(a, axis=-1)
        return (
            gammaln(a0)
            - jnp.sum(gammaln(a), axis=-1)
            + jnp.sum((a - 1.0) * theta["logp"], axis=-1)
        )


dm = base.register(DM())
