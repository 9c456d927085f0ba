"""Fused Gaussian assign kernel (ops/gaussian_assign.py) and `sweep_fused`.

CPU tests run the Triton-route kernel through the Pallas interpreter
(`interpret=True`): kernel logic, masking of the last row block, D padding,
the sampling distribution (the Gumbel noise is an input, so it is testable
here) and the sweep plumbing.  `gpu`-marked tests run the compiled kernel
on the card and mirror the kernel phase of chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from common_tpu import models
from common_tpu import state as st
from common_tpu.kernels import blocked
from common_tpu.ops.gaussian_assign import (
    BLOCK_N,
    fused_gaussian_assign,
    gaussian_assign_reference,
)


def _problem(n=900, d=8, k=6, sep=3.0, seed=0, diag=True):
    r = np.random.default_rng(seed)
    mu = r.normal(scale=sep, size=(k, d)).astype(np.float32)
    X = (mu[r.integers(0, k, n)] + r.normal(scale=0.5, size=(n, d))).astype(
        np.float32
    )
    binv = np.stack([np.eye(d, dtype=np.float32) * 2.0] * k)
    if not diag:
        binv = binv + (0.2 / np.sqrt(d)) * r.normal(size=(k, d, d)).astype(
            np.float32
        )
    base = np.zeros(k, np.float32)
    return map(jnp.asarray, (X, mu, binv, base))


def _scores(X, mu, binv, base):
    """float64 [N, K] base − ½‖(x − μ)Bᵀ‖²."""
    X, mu, binv, base = (np.asarray(a, np.float64) for a in (X, mu, binv, base))
    y = np.einsum("nkd,ked->nke", X[:, None, :] - mu[None], binv)
    return base[None, :] - 0.5 * np.sum(y * y, axis=-1)


def test_interpret_matches_reference_well_separated():
    X, mu, binv, base = _problem()
    g = jax.random.gumbel(jax.random.key(0), (900, 6))
    z = fused_gaussian_assign(X, mu, binv, base, g, interpret=True)
    zr = gaussian_assign_reference(X, mu, binv, base, g)
    np.testing.assert_array_equal(np.asarray(z), np.asarray(zr))


def test_interpret_padding_roundtrip():
    # n not a multiple of the row block: the masked tail must neither
    # leak into the output nor read past the rows
    n = 3 * BLOCK_N + 17
    X, mu, binv, base = _problem(n=n)
    g = jax.random.gumbel(jax.random.key(3), (n, 6))
    z = np.asarray(fused_gaussian_assign(X, mu, binv, base, g, interpret=True))
    assert z.shape == (n,)
    assert (z >= 0).all() and (z < 6).all()
    zr = np.asarray(gaussian_assign_reference(X, mu, binv, base, g))
    np.testing.assert_array_equal(z[-17:], zr[-17:])


@pytest.mark.parametrize("d", [2, 8, 64, 256])
def test_kernel_equals_reference_same_gumbel(d):
    """Row for row, given the same noise: n not a multiple of the row
    block, K not a power of two, non-diagonal B_k, and rows close enough
    that the noise decides some of them."""
    n, k = 2 * BLOCK_N + 45, 7
    X, mu, binv, base = _problem(n=n, d=d, k=k, sep=1.0 / np.sqrt(d), seed=d,
                                 diag=False)
    base = jnp.asarray(np.random.default_rng(d).normal(size=k), jnp.float32)
    g = jax.random.gumbel(jax.random.key(d), (n, k))
    z = np.asarray(fused_gaussian_assign(X, mu, binv, base, g, interpret=True))
    lp = _scores(X, mu, binv, base) + np.asarray(g, np.float64)
    # rows whose top two scores differ by more than f32 rounding of a
    # D-term sum (|lp| * 2e-5) have one right answer
    top2 = np.sort(lp, axis=1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2e-5 * np.abs(top2[:, 1]).clip(1.0)
    assert decided.mean() > 0.98
    np.testing.assert_array_equal(z[decided], lp.argmax(1)[decided])
    # the noise is doing work: it changes the argmax of some rows
    assert (lp.argmax(1) != (lp - np.asarray(g)).argmax(1)).any()


def test_interpret_sampling_distribution():
    """Ambiguous rows: per-row frequencies match softmax probabilities.

    300 draws per row, as one call over 300 copies of 64 rows with
    independent noise per copy."""
    d, k, n, reps = 4, 5, 64, 300
    r = np.random.default_rng(1)
    mu = jnp.asarray(r.normal(scale=0.8, size=(k, d)), jnp.float32)
    X = jnp.asarray(r.normal(scale=1.0, size=(n, d)), jnp.float32)
    binv = jnp.asarray(np.stack([np.eye(d, dtype=np.float32)] * k))
    base = jnp.asarray(r.normal(size=k), jnp.float32)
    probs = np.exp(_scores(X, mu, binv, base))
    probs /= probs.sum(1, keepdims=True)

    Xr = jnp.tile(X, (reps, 1))
    g = jax.random.gumbel(jax.random.key(7), (reps * n, k))
    z = np.asarray(fused_gaussian_assign(Xr, mu, binv, base, g,
                                         interpret=True)).reshape(reps, n)
    freq = np.stack([(z == j).mean(0) for j in range(k)], axis=1)
    # binomial se <= sqrt(.25/300) = 0.029: 0.15 is > 5 se per row
    assert np.abs(freq - probs).max() < 0.15
    assert np.abs(freq.mean(0) - probs.mean(0)).max() < 0.03


def test_padded_k_never_selected():
    """Slots with a −inf base (empty / padded clusters) are never chosen,
    whatever their mean and noise."""
    n, d, k = BLOCK_N + 9, 8, 6
    X, mu, binv, base = _problem(n=n, d=d, k=k)
    # slot 5 sits on top of every row; 1 and 5 are closed
    mu = mu.at[5].set(jnp.mean(X, axis=0))
    base = base.at[jnp.asarray([1, 5])].set(-jnp.inf)
    g = 10.0 * jax.random.gumbel(jax.random.key(2), (n, k))
    z = np.asarray(fused_gaussian_assign(X, mu, binv, base, g, interpret=True))
    assert not np.isin(z, [1, 5]).any()


def _recovery_problem(n=600):
    r = np.random.default_rng(2)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    zt = r.integers(0, 3, n)
    X = (centers[zt] + r.normal(scale=0.6, size=(n, 2))).astype(np.float32)
    defn = st.model_definition(n, [models.niw(2)], k_max=8)
    data = ((jnp.asarray(X), jnp.ones(n)),)
    return defn, data, zt


@pytest.mark.parametrize("fixed", [False, True], ids=["dp", "fixed_k"])
def test_sweep_fused_equals_sweep(fixed):
    """Same key: same θ, weights and noise, so the same z row for row."""
    defn, data, _ = _recovery_problem()
    chp = {"alphas": np.full(8, 0.5, np.float32)} if fixed else {"alpha": 1.0}
    s = st.initialize(defn, data, jax.random.key(0), cluster_hp=chp,
                      fixed=fixed)
    for i in range(3):
        key = jax.random.fold_in(jax.random.key(1), i)
        a = blocked.sweep(s, data, key)
        b = blocked.sweep_fused(s, data, key, interpret=True)
        np.testing.assert_array_equal(np.asarray(a.assignments),
                                      np.asarray(b.assignments))
        np.testing.assert_array_equal(np.asarray(a.counts),
                                      np.asarray(b.counts))
        for leaf in ("n", "sum_x", "sum_xxT"):
            np.testing.assert_allclose(np.asarray(a.stats[0][leaf]),
                                       np.asarray(b.stats[0][leaf]),
                                       rtol=1e-6, atol=1e-4)
        s = b


def test_sweep_fused_fixed_k_interpret():
    """The fused path serves fixed-K (Dirichlet-weight) states."""
    defn, data, zt = _recovery_problem()
    s = st.initialize(
        defn, data, jax.random.key(0),
        cluster_hp={"alphas": np.full(8, 0.5, np.float32)}, fixed=True,
    )
    for i in range(3):
        s = blocked.sweep_fused(
            s, data, jax.random.fold_in(jax.random.key(1), i), interpret=True
        )
    assert int(jnp.sum(s.counts)) == 600
    assert np.isfinite(float(st.score_joint(s)))


def test_sweep_fused_masked_rows_take_prior_assignment():
    """A masked row carries no likelihood: it takes argmax(log w + G) with
    the sweep's own noise, as `sweep` gives it."""
    n = 600
    defn, data, _ = _recovery_problem(n)
    mask = np.ones(n, np.float32)
    masked = np.arange(0, n, 7)
    mask[masked] = 0.0
    data = ((data[0][0], jnp.asarray(mask)),)
    s = st.initialize(defn, data, jax.random.key(0),
                      cluster_hp={"alpha": 1.0})
    key = jax.random.key(5)
    out = blocked.sweep_fused(s, data, key, interpret=True)
    _, logw, _ = blocked.sweep_parts(s, data, key)
    g = jax.random.gumbel(jax.random.fold_in(key, 2), (n, 8))
    prior = np.asarray(jnp.argmax(logw[None, :] + g, axis=-1))
    z = np.asarray(out.assignments)
    np.testing.assert_array_equal(z[masked], prior[masked])
    np.testing.assert_array_equal(
        z, np.asarray(blocked.sweep(s, data, key).assignments))
    # masked rows are counted but add nothing to the suffstats
    assert int(np.asarray(out.counts).sum()) == n
    assert float(np.asarray(out.stats[0]["n"]).sum()) == n - len(masked)


@pytest.mark.parametrize("model", ["bb", "bbv"])
def test_sweep_fused_rejects_wrong_model(model):
    if model == "bb":
        defn = st.model_definition(4, [models.bb], k_max=2)
        data = ((jnp.zeros(4), jnp.ones(4)),)
    else:
        defn = st.model_definition(4, [models.bbv(3)], k_max=2)
        data = ((jnp.zeros((4, 3)), jnp.ones(4)),)
    s = st.initialize(defn, data, jax.random.key(0))
    with pytest.raises(ValueError, match="single niw.*assign_blocked"):
        blocked.sweep_fused(s, data, jax.random.key(1))


# ---------------------------------------------------------------------------
# on the card: the compiled kernel (mirrors chip_smoke.py's kernel phase)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_gpu_sampling_distribution():
    import chip_smoke

    mx, mean = chip_smoke.kernel_distribution(jax.random.key(100))
    assert mx < chip_smoke.FREQ_MAX_ABS and mean < chip_smoke.FREQ_MEAN_ABS


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(1_048_576, 64), (1_048_576, 50),
                                 (1_000_003, 64)])
def test_gpu_headline_shape_agreement(n, k):
    import chip_smoke

    a = chip_smoke.kernel_agreement(n, 256, k, jax.random.key(k))
    assert a >= chip_smoke.AGREE_MIN, a


@pytest.mark.gpu
def test_gpu_sweep_fused_recovers_clusters():
    defn, data, zt = _recovery_problem()
    s = st.initialize(defn, data, jax.random.key(0),
                      cluster_hp={"alpha": 1.0})
    for i in range(30):
        s = blocked.sweep_fused(s, data,
                                jax.random.fold_in(jax.random.key(1), i))
    zz = np.asarray(s.assignments)
    co = zz[:, None] == zz[None, :]
    truth = zt[:, None] == zt[None, :]
    assert (co == truth).mean() > 0.95
    assert int(np.asarray(s.counts).sum()) == 600
