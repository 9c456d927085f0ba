"""Checkpoint round-trip + bit-exact resume, and diagnostics sanity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from common_tpu import io as ctio
from common_tpu import models
from common_tpu import state as st
from common_tpu.runner import run_chain
from common_tpu.utils import diagnostics


def _problem(n=12, seed=0):
    r = np.random.default_rng(seed)
    defn = st.model_definition(n, [models.niw(2), models.bb], k_max=6)
    data = (
        (jnp.asarray(r.normal(size=(n, 2)), jnp.float32), jnp.ones(n)),
        (jnp.asarray(r.integers(0, 2, size=n)), jnp.ones(n)),
    )
    return defn, data


def test_checkpoint_roundtrip(tmp_path):
    defn, data = _problem()
    s = st.initialize(defn, data, jax.random.key(0), cluster_hp={"alpha": 1.3})
    key = jax.random.key(7)
    path = str(tmp_path / "ckpt.npz")
    ctio.save(path, s, extra={"key": key, "iter": jnp.asarray(42)})
    s2, extra = ctio.load(path)
    assert s2.lik_names == s.lik_names
    assert s2.fixed == s.fixed
    for a, b in zip(
        jax.tree_util.tree_leaves(s), jax.tree_util.tree_leaves(s2)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(extra["iter"]) == 42
    np.testing.assert_array_equal(
        jax.random.key_data(extra["key"]), jax.random.key_data(key)
    )


def test_resume_is_bit_exact(tmp_path):
    """Running 2N sweeps == running N, checkpointing, resuming N more."""
    defn, data = _problem(seed=1)
    s0 = st.initialize(defn, data, jax.random.key(0), cluster_hp={"alpha": 1.0})
    key = jax.random.key(9)

    def sweeps(s, t0, n):
        for t in range(t0, t0 + n):
            s, _ = run_chain(s, data, jax.random.fold_in(key, t), 1, ["assign"])
        return s

    straight = sweeps(s0, 0, 6)

    half = sweeps(s0, 0, 3)
    blob = ctio.serialize(half, extra={"key": key, "iter": jnp.asarray(3)})
    restored, extra = ctio.deserialize(blob)
    resumed = sweeps(restored, int(extra["iter"]), 3)

    np.testing.assert_array_equal(
        np.asarray(straight.assignments), np.asarray(resumed.assignments)
    )
    np.testing.assert_allclose(
        np.asarray(straight.stats[0]["sum_x"]),
        np.asarray(resumed.stats[0]["sum_x"]),
        rtol=1e-6,
    )


def test_ess_iid_close_to_n():
    r = np.random.default_rng(0)
    x = r.normal(size=(4, 500)).astype(np.float32)
    e = float(diagnostics.ess(x))
    assert 1200 < e < 2800, e  # ~CT for iid


def test_ess_correlated_much_smaller():
    r = np.random.default_rng(1)
    t, rho = 1000, 0.95
    x = np.zeros((2, t), np.float32)
    for c in range(2):
        eps = r.normal(size=t)
        for i in range(1, t):
            x[c, i] = rho * x[c, i - 1] + eps[i]
    e = float(diagnostics.ess(x))
    # AR(1) tau ~ (1+rho)/(1-rho) = 39 -> ess ~ 2000/39 ~ 51
    assert e < 300, e


def test_rhat_mixed_vs_unmixed():
    r = np.random.default_rng(2)
    mixed = r.normal(size=(4, 400)).astype(np.float32)
    assert float(diagnostics.split_rhat(mixed)) < 1.05
    unmixed = mixed + np.arange(4)[:, None] * 5.0
    assert float(diagnostics.split_rhat(unmixed)) > 1.5


def test_summarize_traces():
    r = np.random.default_rng(3)
    out = diagnostics.summarize_traces(r.normal(size=(2, 300)))
    assert set(out) >= {"ess", "rhat", "mean", "std", "nchains", "nsamples"}
    assert out["nchains"] == 2 and out["nsamples"] == 300


# ---------------------------------------------------------------------------
# checkpoint coverage for every latent-state family (reference parity —
# group_manager::serialize covers mixture, irm, lda)
# ---------------------------------------------------------------------------
def _assert_pytree_equal(a, b):
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_irm_roundtrip_and_resume(tmp_path):
    from common_tpu import relational as irm
    from common_tpu.data.sparse import sparse_ndarray_dataview

    r = np.random.default_rng(3)
    n = 6
    rel = (r.random((n, n)) < 0.4).astype(np.float32)
    defn = irm.model_definition([n], [((0, 0), models.bb)], k_max=4)
    views = [sparse_ndarray_dataview(dense=rel)]
    s = irm.initialize(defn, views, jax.random.key(0),
                       cluster_hps=[{"alpha": 1.1}])
    views_t = irm.as_views(views)
    key = jax.random.key(4)

    def sweeps(s, t0, nsweeps):
        for t in range(t0, t0 + nsweeps):
            s = irm.kernels._assign_jit(s, views_t, jax.random.fold_in(key, t), 0)
        return s

    blob = ctio.serialize(sweeps(s, 0, 3), extra={"iter": jnp.asarray(3)})
    restored, extra = ctio.deserialize(blob)
    assert isinstance(restored, irm.IRMState)
    assert restored.lik_names == s.lik_names
    assert restored.rel_domains == s.rel_domains
    resumed = sweeps(restored, int(extra["iter"]), 3)
    straight = sweeps(s, 0, 6)
    _assert_pytree_equal(straight, resumed)


def test_checkpoint_hdp_roundtrip_and_resume(tmp_path):
    from common_tpu import topic
    from common_tpu.data.variadic import variadic_dataview

    rows = [np.array([0, 1, 2, 0]), np.array([2, 2, 1]), np.array([0, 0])]
    view = variadic_dataview(rows)
    data = topic.token_data(view)
    s = topic.initialize(view, 3, 3, jax.random.key(0), alpha=0.7)
    key = jax.random.key(5)

    def sweeps(s, t0, nsweeps):
        for t in range(t0, t0 + nsweeps):
            s = topic.collapsed_sweep(s, data, jax.random.fold_in(key, t))
        return s

    path = str(tmp_path / "hdp.npz")
    ctio.save(path, sweeps(s, 0, 2), extra={"iter": jnp.asarray(2)})
    restored, extra = ctio.load(path)
    assert isinstance(restored, topic.HDPState)
    resumed = sweeps(restored, int(extra["iter"]), 2)
    straight = sweeps(s, 0, 4)
    _assert_pytree_equal(straight, resumed)


@pytest.mark.slow
def test_checkpoint_svi_roundtrip():
    from common_tpu.kernels import svi

    defn, data = _problem(seed=4)
    post = svi.init(defn, data, jax.random.key(2), cluster_hp={"alpha": 1.0})
    post, _ = svi.fit_cavi(post, data, 3)
    blob = ctio.serialize(post)
    restored, _ = ctio.deserialize(blob)
    assert isinstance(restored, svi.SVIPosterior)
    assert restored.lik_names == post.lik_names
    assert restored.fixed == post.fixed
    _assert_pytree_equal(post, restored)
    # restored posterior must produce the identical ELBO
    np.testing.assert_allclose(
        float(svi.elbo(post, data)), float(svi.elbo(restored, data)), rtol=1e-6
    )


def test_checkpoint_smc_particles_roundtrip_and_resume():
    from common_tpu.kernels import smc

    defn, data = _problem(n=8, seed=5)
    particles = smc.init_particles(defn, data, jax.random.key(1), 6,
                                   cluster_hp={"alpha": 1.0})
    key = jax.random.key(6)
    blob = ctio.serialize(particles, extra={"key": key})
    restored, extra = ctio.deserialize(blob)
    _assert_pytree_equal(particles, restored)
    # an SMC run from the restored particle set with the restored key is
    # identical to the original run
    r1 = smc.run(particles, data, key)
    r2 = smc.run(restored, data, extra["key"])
    _assert_pytree_equal(r1.particles, r2.particles)
    np.testing.assert_array_equal(np.asarray(r1.log_w), np.asarray(r2.log_w))
