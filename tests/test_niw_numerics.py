"""NIW numerics hardening tiers (SURVEY.md §7 "NIW numerics", f32).

- f64-oracle tolerance tier: after thousands of incremental f32
  add/remove cycles at d=64, per-cluster marginals must still match the
  scipy float64 from-scratch oracle within tier tolerance.
- drift robustness: asymmetric float noise on sum_xxT (the downdate
  failure mode) must not produce NaN predictives.
- jax_debug_nans tier: full sweeps run clean under the NaN-checking mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ref_impls
from common_tpu import models
from common_tpu import state as st
from common_tpu.kernels import gibbs
from common_tpu.likelihoods.niw import niw as niw_lik


def _niw_problem(n, d, k_max, seed=0):
    r = np.random.default_rng(seed)
    centers = r.normal(scale=3.0, size=(4, d))
    z = r.integers(0, 4, n)
    X = (centers[z] + r.normal(size=(n, d))).astype(np.float32)
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    data = ((jnp.asarray(X), jnp.ones(n)),)
    s = st.initialize(defn, data, jax.random.key(seed),
                      cluster_hp={"alpha": 1.0})
    return s, data, X


@pytest.mark.slow
def test_long_add_remove_cycles_match_f64_oracle():
    """2000 random remove/re-add cycles at d=64 in f32, then compare every
    active cluster's marginal_loglik against the scipy f64 oracle."""
    n, d = 120, 64
    s, data, X = _niw_problem(n, d, k_max=8, seed=1)

    @jax.jit
    def churn(s, key):
        def body(stt, t):
            kt = jax.random.fold_in(key, t)
            eid = jax.random.randint(kt, (), 0, n)
            stt = st.remove_value(stt, data, eid)
            gid = jax.random.randint(
                jax.random.fold_in(kt, 1), (), 0, stt.k_max
            )
            stt = st.add_value(stt, data, eid, gid)
            return stt, None

        return jax.lax.scan(body, s, jnp.arange(2000))[0]

    s = churn(s, jax.random.key(2))
    z = np.asarray(s.assignments)
    counts = np.asarray(s.counts)

    hyper = s.hypers[0]
    ml_f32 = np.asarray(niw_lik.marginal_loglik(hyper, s.stats[0]))

    mu0 = np.zeros(d)
    psi = np.eye(d)
    kappa = float(hyper["kappa"])
    nu = float(hyper["nu"])
    for k in range(s.k_max):
        if counts[k] == 0:
            assert ml_f32[k] == 0.0, (k, ml_f32[k])
            continue
        rows = X[z == k].astype(np.float64)
        oracle = ref_impls.niw_marginal(mu0, kappa, psi, nu, rows)
        # tier: |Δ| within 5e-5 relative of a d=64 marginal's magnitude
        assert abs(ml_f32[k] - oracle) < 5e-5 * abs(oracle) + 0.5, (
            k, counts[k], ml_f32[k], oracle,
        )


def test_asymmetric_drift_stays_finite():
    """Inject asymmetric noise into sum_xxT (the f32 downdate failure
    mode): predictives and marginals must stay finite (symmetrize+jitter)."""
    n, d = 60, 16
    s, data, X = _niw_problem(n, d, k_max=4, seed=3)
    r = np.random.default_rng(0)
    noise = 1e-3 * r.normal(size=(s.k_max, d, d)).astype(np.float32)
    stats = dict(s.stats[0])
    stats["sum_xxT"] = stats["sum_xxT"] + jnp.asarray(noise)  # asymmetric!
    hyper = s.hypers[0]

    ml = np.asarray(niw_lik.marginal_loglik(hyper, stats))
    assert np.isfinite(ml[np.asarray(s.counts) > 0]).all(), ml
    pred = np.asarray(niw_lik.pred_logpdf(hyper, stats, jnp.asarray(X[0])))
    assert np.isfinite(pred).all(), pred
    theta = niw_lik.sample_params(jax.random.key(0), hyper, stats)
    assert np.isfinite(np.asarray(theta["cov_chol"])).all()


def test_sweeps_clean_under_debug_nans():
    """The jax_debug_nans CI tier: collapsed sweeps raise on any NaN."""
    s, data, _ = _niw_problem(40, 8, k_max=6, seed=4)
    jax.config.update("jax_debug_nans", True)
    try:
        for i in range(3):
            s = gibbs.assign(s, data, jax.random.key(i))
        score = float(st.score_joint(s))
    finally:
        jax.config.update("jax_debug_nans", False)
    assert np.isfinite(score)


def test_jitter_does_not_shift_small_problems():
    """Hardening must be numerically invisible on clean stats: compare
    marginals with hand-built exact stats to the scipy oracle at d=4."""
    d = 4
    r = np.random.default_rng(5)
    X = r.normal(size=(12, d)).astype(np.float32)
    hyper = {
        "mu0": jnp.zeros(d), "kappa": jnp.asarray(1.0),
        "psi": jnp.eye(d), "nu": jnp.asarray(float(d + 2)),
    }
    stats = {
        "n": jnp.asarray(float(len(X))),
        "sum_x": jnp.asarray(X.sum(0)),
        "sum_xxT": jnp.asarray(X.T @ X),
    }
    got = float(niw_lik.marginal_loglik(hyper, stats))
    want = ref_impls.niw_marginal(
        np.zeros(d), 1.0, np.eye(d), d + 2.0, X.astype(np.float64)
    )
    assert abs(got - want) < 1e-3, (got, want)


def test_debug_tiers_utilities():
    """utils.debug: nan_check raises on NaN; x64 traces f64; replay_key
    reproduces the fold_in chain."""
    from common_tpu.utils import debug

    with pytest.raises(FloatingPointError):
        with debug.nan_check():
            jax.jit(lambda x: jnp.log(x) - jnp.log(x) + jnp.sqrt(x))(
                -1.0
            ).block_until_ready()

    with debug.x64():
        assert jnp.asarray(1.0).dtype == jnp.float64
    assert jnp.asarray(1.0).dtype == jnp.float32

    k1 = debug.replay_key(jax.random.key(0), 3, 7, 11)
    k2 = jax.random.fold_in(
        jax.random.fold_in(jax.random.fold_in(jax.random.key(0), 3), 7), 11
    )
    assert jax.random.uniform(k1) == jax.random.uniform(k2)


def test_f64_tier_marginal_comparison():
    """x64 tier in action: f32 marginal within tolerance of the f64 trace
    of the same computation at d=32."""
    from common_tpu.utils import debug

    d = 32
    r = np.random.default_rng(9)
    X = r.normal(size=(50, d))
    stats32 = {
        "n": jnp.asarray(50.0),
        "sum_x": jnp.asarray(X.sum(0), jnp.float32),
        "sum_xxT": jnp.asarray(X.T @ X, jnp.float32),
    }
    hyper32 = {
        "mu0": jnp.zeros(d), "kappa": jnp.asarray(1.0),
        "psi": jnp.eye(d), "nu": jnp.asarray(float(d + 2)),
    }
    got32 = float(niw_lik.marginal_loglik(hyper32, stats32))
    with debug.x64():
        stats64 = {
            "n": jnp.asarray(50.0, jnp.float64),
            "sum_x": jnp.asarray(X.sum(0), jnp.float64),
            "sum_xxT": jnp.asarray(X.T @ X, jnp.float64),
        }
        hyper64 = {
            "mu0": jnp.zeros(d, jnp.float64),
            "kappa": jnp.asarray(1.0, jnp.float64),
            "psi": jnp.eye(d, dtype=jnp.float64),
            "nu": jnp.asarray(float(d + 2), jnp.float64),
        }
        got64 = float(niw_lik.marginal_loglik(hyper64, stats64))
    assert abs(got32 - got64) < 1e-4 * abs(got64) + 0.1, (got32, got64)


@pytest.mark.parametrize("d", [1, 3, 64])
def test_scatter_product_matches_float64(d):
    """The restat's scatter product against float64, on data far from the
    origin (where a biased product error would not average down); d = 1
    takes the plain-precision branch."""
    from common_tpu.likelihoods.niw import scatter_product

    r = np.random.default_rng(d)
    X = (4.0 + r.normal(size=(3000, d))).astype(np.float32)
    w = (r.random(3000) < 0.5).astype(np.float32)
    got = np.asarray(jax.jit(scatter_product)(
        jnp.asarray(X * w[:, None]), jnp.asarray(X)), np.float64)
    X64 = X.astype(np.float64)
    want = (X64 * w[:, None]).T @ X64
    assert got.shape == (d, d)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
