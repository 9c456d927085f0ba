"""Vector Beta–Bernoulli likelihood (conjugate): d independent binary
columns in ONE feature.

No single reference analog: the reference models a binary feature matrix
as d separate scalar ``bb`` features (one BetaBernoulli group per column,
`distributions:include/distributions/models/bb.hpp`), which on an accelerator would
mean d small python-level feature loops per sweep.  ``bbv`` is the
vectorized formulation of the same model — per-column (alpha, beta)
hypers, identical posterior — with all d columns scored in one
matmul-shaped op so the [N, K] table rides the matrix units:

    log p(x | p_k) = x · (log p_k − log(1−p_k)) + Σ_d log(1−p_kd)

i.e. ``X @ W.T + b`` with W = logit(p): one GEMM, whose Gumbel-add and
argmax XLA fuses.

Suffstats: (n [.,], heads [., d]).  Hyper: alpha [d], beta [d].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.special import betaln

from common_tpu.likelihoods import base


class BBV(base.Likelihood):
    name = "bbv"
    conjugate = True
    has_expfam = True

    def posterior_hyper(self, hyper, stats):
        return {
            "alpha": hyper["alpha"] + stats["heads"],
            "beta": hyper["beta"] + stats["n"][..., None] - stats["heads"],
        }

    # conjugate expfam: T(p) = (log p, log(1-p)) per column
    def nat_params(self, hyper):
        return {"a": hyper["alpha"] - 1.0, "b": hyper["beta"] - 1.0}

    def log_partition(self, nat):
        return jnp.sum(betaln(nat["a"] + 1.0, nat["b"] + 1.0), axis=-1)

    def suffstat_pair(self, hyper, x, mask):
        m = jnp.asarray(mask, jnp.float32)
        xf = jnp.asarray(x, jnp.float32)
        return {"a": m * xf, "b": m * (1.0 - xf)}

    def log_h(self, hyper, x, mask):
        xf = jnp.asarray(x, jnp.float32)
        return jnp.zeros(xf.shape[:-1], jnp.float32)

    def default_hyper(self):
        # d is carried by the hyper arrays themselves (cf. dd's alphas)
        return {"alpha": jnp.ones(1), "beta": jnp.ones(1)}

    def validate_hyper(self, hyper):
        missing = {"alpha", "beta"} - set(hyper)
        if missing:
            raise ValueError(
                f"{self.name}: missing hyperparameters {sorted(missing)}"
            )
        a = jnp.asarray(hyper["alpha"])
        b = jnp.asarray(hyper["beta"])
        if a.shape != b.shape or a.ndim != 1:
            raise ValueError(
                f"{self.name}: alpha/beta must be matching [d] vectors, "
                f"got {a.shape} / {b.shape}"
            )
        return {"alpha": a, "beta": b}

    def init_stats(self, hyper, batch_shape):
        d = hyper["alpha"].shape[-1]
        return {
            "n": jnp.zeros(batch_shape, jnp.float32),
            "heads": jnp.zeros((*batch_shape, d), jnp.float32),
        }

    def tx(self, hyper, x, mask):
        m = jnp.asarray(mask, jnp.float32)
        return {"n": m, "heads": m * jnp.asarray(x, jnp.float32)}

    def marginal_loglik(self, hyper, stats):
        a, b = hyper["alpha"], hyper["beta"]
        h = stats["heads"]
        t = stats["n"][..., None] - h
        return jnp.sum(betaln(a + h, b + t) - betaln(a, b), axis=-1)

    def pred_logpdf(self, hyper, stats, x):
        a, b = hyper["alpha"], hyper["beta"]
        h = stats["heads"]
        n = stats["n"][..., None]
        denom = jnp.log(a + b + n)
        lp = jnp.log(a + h) - denom
        lq = jnp.log(b + n - h) - denom
        x = jnp.asarray(x, jnp.float32)
        return jnp.sum(x * lp + (1.0 - x) * lq, axis=-1)

    def sample_params(self, key, hyper, stats):
        a = hyper["alpha"] + stats["heads"]
        b = hyper["beta"] + stats["n"][..., None] - stats["heads"]
        return {"p": jax.random.beta(key, a, b)}

    def logpdf(self, theta, x):
        x = jnp.asarray(x, jnp.float32)
        p = theta["p"]
        return jnp.sum(x * jnp.log(p) + (1.0 - x) * jnp.log1p(-p), axis=-1)

    def logpdf_batch(self, theta, X, mask):
        # matmul form: X @ logit(p).T + Σ_d log(1-p)  → one GEMM
        x = jnp.asarray(X, jnp.float32)
        lp = jnp.log(theta["p"])
        lq = jnp.log1p(-theta["p"])
        return (x @ (lp - lq).T + jnp.sum(lq, axis=-1)[None, :]) * mask[:, None]

    def sample_value(self, key, theta):
        return jax.random.bernoulli(key, theta["p"]).astype(jnp.float32)

    def prior_logpdf(self, hyper, theta):
        a, b = hyper["alpha"], hyper["beta"]
        p = theta["p"]
        return jnp.sum(
            (a - 1.0) * jnp.log(p) + (b - 1.0) * jnp.log1p(-p)
            - betaln(a, b),
            axis=-1,
        )


bbv = base.register(BBV())
