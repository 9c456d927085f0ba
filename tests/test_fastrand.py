"""Distributional validation of the fixed-rounds Gamma/Dirichlet sampler.

utils/fastrand.py replaces jax.random.gamma in hot paths (the HDP
theta draw); these tests pin it to the exact distribution: KS tests
against scipy's gamma CDF across shapes spanning the boost branch
(a < 1) and the plain branch, moment checks, and Dirichlet moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats

from common_tpu.utils import fastrand


@pytest.mark.parametrize("a", [0.1, 0.5, 0.9, 1.0, 1.5, 4.0, 50.0])
def test_gamma_ks_vs_scipy(a):
    n = 20_000
    x = np.asarray(
        fastrand.gamma(jax.random.key(hash(a) % 1000), jnp.full(n, a))
    )
    assert np.isfinite(x).all() and (x > 0).all()
    ks = scipy.stats.kstest(x, "gamma", args=(a,))
    assert ks.pvalue > 1e-3, (a, ks)


def test_gamma_moments_heterogeneous_shapes():
    """One call with a mixed-alpha array: per-alpha means/vars correct."""
    alphas = np.array([0.2, 0.7, 1.3, 3.0, 10.0], np.float32)
    n = 40_000
    conc = jnp.tile(jnp.asarray(alphas), (n, 1))
    x = np.asarray(fastrand.gamma(jax.random.key(3), conc))
    np.testing.assert_allclose(x.mean(0), alphas, rtol=0.05)
    np.testing.assert_allclose(x.var(0), alphas, rtol=0.1)


def test_dirichlet_moments():
    conc = jnp.asarray([0.5, 1.0, 2.0, 4.0], jnp.float32)
    n = 40_000
    d = np.asarray(
        fastrand.dirichlet(jax.random.key(5), jnp.tile(conc, (n, 1)))
    )
    np.testing.assert_allclose(d.sum(-1), 1.0, atol=1e-5)
    a0 = float(conc.sum())
    mean = np.asarray(conc) / a0
    var = mean * (1 - mean) / (a0 + 1)
    np.testing.assert_allclose(d.mean(0), mean, rtol=0.03)
    np.testing.assert_allclose(d.var(0), var, rtol=0.1)


def test_gamma_matches_jax_random_distribution():
    """Same-distribution check against jax.random.gamma (AD test on the
    pooled two-sample ranks via KS)."""
    a = 1.5
    n = 20_000
    x = np.asarray(fastrand.gamma(jax.random.key(7), jnp.full(n, a)))
    y = np.asarray(jax.random.gamma(jax.random.key(8), jnp.full(n, a)))
    ks = scipy.stats.ks_2samp(x, y)
    assert ks.pvalue > 1e-3, ks
