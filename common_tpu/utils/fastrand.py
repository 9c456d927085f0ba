"""Fixed-rounds Gamma/Dirichlet sampling for large draw counts.

`jax.random.gamma` implements Marsaglia–Tsang with a rejection
`while_loop`, which runs every lane until ALL lanes accept, and its
per-iteration control overhead dominates at large draw counts: on an
H100 (700 W) a [1M, 32] Gamma draw takes 32.3 ms through
`jax.random.gamma` and 2.98 ms here (PERF.md).

`gamma` here runs the SAME Marsaglia–Tsang proposal for a fixed number
of unrolled rounds (lax.scan) and takes each lane's first acceptance.
Acceptance per round is >= 0.95 for every shape (after the standard
a < 1 boost, the squeeze operates at a+1 >= 1), so the probability a
lane exhausts `rounds` proposals is <= 0.05^rounds — at the default 6
rounds, < 2e-8, i.e. ~1 draw in 5e7 falls back to the distribution mode
(d = a − 1/3).  That bias is far below statistical resolution at any
sample size this library produces (KS-validated against scipy in
tests/test_fastrand.py); raise `rounds` for more margin.

Reference gamma algorithm: Marsaglia & Tsang (2000), "A simple method
for generating gamma variables"; the a < 1 boost X_a = X_{a+1}·U^{1/a}
is from the same paper.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("rounds",))
def gamma(key, alpha, rounds: int = 6):
    """Gamma(alpha, 1) draws, one per element of `alpha` (any shape).

    Equivalent in distribution to `jax.random.gamma(key, alpha)` up to
    the < 2e-8 per-lane fallback described in the module docstring;
    ~10x faster at [1M, 32] (module docstring).
    """
    a = jnp.asarray(alpha, jnp.float32)
    boost = a < 1.0
    a1 = jnp.where(boost, a + 1.0, a)
    d = a1 - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)

    def body(carry, r):
        x, found = carry
        kr = jax.random.fold_in(key, r)
        z = jax.random.normal(jax.random.fold_in(kr, 0), a.shape)
        u = jax.random.uniform(
            jax.random.fold_in(kr, 1), a.shape, minval=1e-38
        )
        t = 1.0 + c * z
        v = t * t * t
        ok = (v > 0.0) & (
            jnp.log(u)
            < 0.5 * z * z + d - d * v + d * jnp.log(jnp.where(v > 0, v, 1.0))
        )
        take = ok & ~found
        x = jnp.where(take, d * v, x)
        return (x, found | ok), None

    # fallback value = mode d (hit with prob <= 0.05^rounds per lane)
    (x, _), _ = jax.lax.scan(
        body, (d, jnp.zeros(a.shape, bool)), jnp.arange(rounds)
    )
    # a < 1: X_a = X_{a+1} * U^{1/a}  (log-space for tiny a stability)
    u0 = jax.random.uniform(
        jax.random.fold_in(key, rounds), a.shape, minval=1e-38
    )
    xb = x * jnp.exp(jnp.log(u0) / jnp.maximum(a, 1e-6))
    out = jnp.where(boost, xb, x)
    # tiny-a draws can underflow f32 (u^{1/a}); clamp to the smallest
    # normal float so downstream logs stay finite — the same truncation
    # any f32 gamma sampler has at this tail mass (~1.7e-4 at a=0.1)
    return jnp.maximum(out, jnp.finfo(jnp.float32).tiny)


@partial(jax.jit, static_argnames=("rounds",))
def dirichlet(key, conc, rounds: int = 6):
    """Dirichlet draws over the last axis of `conc` (any leading shape)."""
    g = gamma(key, conc, rounds=rounds)
    g = jnp.maximum(g, 1e-30)
    return g / jnp.sum(g, axis=-1, keepdims=True)
