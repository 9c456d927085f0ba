"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §7 CI recipe — no pod required)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from common_tpu import models, parallel, testutil
from common_tpu import state as st
from common_tpu.kernels import blocked

from test_gibbs_exact import exact_partition_posterior


def _problem(n, d=2, k_max=8, seed=0):
    r = np.random.default_rng(seed)
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    data = ((jnp.asarray(r.normal(size=(n, d)), jnp.float32), jnp.ones(n)),)
    return defn, data


def test_sharded_sweep_counts_and_stats_consistent(cpu_devices):
    n, chains, dshards = 32, 2, 4
    defn, data = _problem(n, k_max=8)
    mesh = parallel.make_mesh(chains, dshards, devices=cpu_devices)
    keys = jax.random.split(jax.random.key(0), 4)  # 2 chains per shard
    state = parallel.initialize_chains(defn, data, keys, cluster_hp={"alpha": 1.0})
    state, sdata = parallel.shard_state(mesh, state, data)
    sweep = parallel.make_sharded_sweep(mesh, state, sdata)
    out = sweep(state, sdata, jax.random.key(1))

    counts = np.asarray(out.counts)
    assert counts.shape == (4, 8)
    np.testing.assert_array_equal(counts.sum(axis=-1), n)

    # global stats == from-scratch stats of the gathered assignment vector
    z = np.asarray(out.assignments)  # [C, N]
    for c in range(4):
        scratch = st.compute_stats(
            defn,
            jax.tree_util.tree_map(lambda l: l[c], out.hypers),
            data,
            jnp.asarray(z[c]),
        )
        for k in scratch[0]:
            np.testing.assert_allclose(
                np.asarray(out.stats[0][k][c]),
                np.asarray(scratch[0][k]),
                rtol=1e-4, atol=1e-4,
            )
        np.testing.assert_array_equal(
            counts[c], np.bincount(z[c], minlength=8)
        )


def test_sharded_sweep_deterministic(cpu_devices):
    n = 16
    defn, data = _problem(n, k_max=4)
    mesh = parallel.make_mesh(2, 4, devices=cpu_devices)
    keys = jax.random.split(jax.random.key(3), 2)
    state = parallel.initialize_chains(defn, data, keys, cluster_hp={"alpha": 1.0})
    state, sdata = parallel.shard_state(mesh, state, data)
    sweep = parallel.make_sharded_sweep(mesh, state, sdata)
    o1 = sweep(state, sdata, jax.random.key(9))
    o2 = sweep(state, sdata, jax.random.key(9))
    np.testing.assert_array_equal(
        np.asarray(o1.assignments), np.asarray(o2.assignments)
    )


def test_chains_are_independent(cpu_devices):
    """Different chains (same data) must produce different trajectories."""
    n = 32
    defn, data = _problem(n, k_max=8, seed=1)
    mesh = parallel.make_mesh(2, 4, devices=cpu_devices)
    keys = jax.random.split(jax.random.key(0), 4)
    state = parallel.initialize_chains(defn, data, keys, cluster_hp={"alpha": 1.0})
    state, sdata = parallel.shard_state(mesh, state, data)
    sweep = parallel.make_sharded_sweep(mesh, state, sdata)
    out = sweep(state, sdata, jax.random.key(5))
    z = np.asarray(out.assignments)
    assert not np.array_equal(z[0], z[1]) or not np.array_equal(z[1], z[2])


@pytest.mark.slow
def test_sharded_blocked_matches_enumeration(cpu_devices):
    """Statistical correctness end-to-end across the mesh: the row-sharded,
    psum-reduced sampler targets the same partition posterior."""
    n = 4
    r = np.random.default_rng(4)
    defn16 = st.model_definition(n, [models.bb], k_max=16)
    data = ((jnp.asarray(r.integers(0, 2, size=n)), jnp.ones(n)),)
    chp = {"alpha": 1.0}
    exact = exact_partition_posterior(
        st.model_definition(n, [models.bb], k_max=5), data, chp
    )

    chains, dshards = 2, 4
    mesh = parallel.make_mesh(chains, dshards, devices=cpu_devices)
    keys = jax.random.split(jax.random.key(11), 4)
    state = parallel.initialize_chains(defn16, data, keys, cluster_hp=chp)
    state, sdata = parallel.shard_state(mesh, state, data)
    sweep = parallel.make_sharded_sweep(mesh, state, sdata)

    from functools import partial

    @partial(jax.jit, static_argnames=("nsweeps",))
    def run(state, key, nsweeps):
        def body(s, t):
            s = sweep(s, sdata, jax.random.fold_in(key, t))
            return s, s.assignments

        return jax.lax.scan(body, state, jnp.arange(nsweeps))

    cache = {}

    def sample_fn(nsweeps):
        per_chain = nsweeps // 4 + 300
        if nsweeps not in cache:
            _, zs = run(state, jax.random.key(13), per_chain)
            zs = np.asarray(zs)[300:]  # [T, C, N]
            cache[nsweeps] = [
                testutil.permutation_canonical(zs[t, c])
                for t in range(zs.shape[0])
                for c in range(zs.shape[1])
            ]
        return cache[nsweeps]

    testutil.assert_discrete_dist_approx(
        sample_fn, exact, nsamples=6000, ntries=3, kl_tol=0.03
    )


@pytest.mark.slow  # ~35 s (median-of-3 ladder); plumbing also
# exercised every bench run
def test_scaling_efficiency_harness(cpu_devices):
    """Measurement plumbing for the BASELINE.md >=0.8 efficiency north
    star: throughputs at 1/2/4 shards are positive and the efficiency
    ratio is well-formed (virtual CPU devices share cores, so no hardware
    scaling assertion here — only that the harness measures)."""
    with jax.default_device(cpu_devices[0]):
        res = parallel.measure_row_scaling(
            n=2048, d=4, k_max=8, sweeps=3,
            shard_counts=(1, 2, 4), devices=cpu_devices,
        )
    assert res["shard_counts"] == [1, 2, 4]
    assert all(v > 0 for v in res["throughput"].values()), res
    assert 0 < res["efficiency"] < 100, res
    assert res["collectives_ok"] is True, res
    assert res["n"] % 4 == 0


@pytest.mark.slow  # ~26 s; per-family enumeration oracles stay fast
def test_multichain_hdp_and_irm():
    """Family-generic chain vmap: independent HDP and IRM chains advance
    in one compiled program and stay independent."""
    from common_tpu import topic
    from common_tpu import relational as irm
    from common_tpu.data.variadic import variadic_dataview
    from common_tpu.data.sparse import sparse_ndarray_dataview

    # --- HDP: 3 chains over one corpus -----------------------------------
    r = np.random.default_rng(0)
    rows = [r.integers(0, 12, size=15) for _ in range(20)]
    view = variadic_dataview(rows)
    data = topic.token_data(view)
    chains = [
        topic.initialize(view, 4, 12, jax.random.key(i)) for i in range(3)
    ]
    batched = parallel.stack_states(chains)
    sweep = jax.jit(parallel.vmap_sweep(topic.blocked_sweep))
    for it in range(3):
        keys = jax.random.split(jax.random.fold_in(jax.random.key(9), it), 3)
        batched = sweep(batched, data, keys)
    total = sum(len(rw) for rw in rows)
    zs = np.asarray(batched.z)
    assert zs.shape[0] == 3
    assert not (zs[0] == zs[1]).all()  # chains diverged
    for c in range(3):
        st_c = parallel.unstack_state(batched, c)
        assert float(jnp.sum(st_c.topic_total)) == total

    # --- IRM: 2 chains over one relation ---------------------------------
    rel = (r.random((8, 8)) < 0.5).astype(np.float32)
    defn = irm.model_definition([8], [((0, 0), models.bb)], k_max=4)
    views = irm.as_views([sparse_ndarray_dataview(dense=rel)])
    ichains = [
        irm.initialize(defn, views, jax.random.key(10 + i),
                       cluster_hps=[{"alpha": 1.0}])
        for i in range(2)
    ]
    ibatched = parallel.stack_states(ichains)
    self_rel = (True,)
    isweep = jax.jit(jax.vmap(
        lambda s, k: irm.kernels._sweep_jit(s, views, k, self_rel),
        in_axes=(0, 0),
    ))
    for it in range(3):
        keys = jax.random.split(jax.random.fold_in(jax.random.key(11), it), 2)
        ibatched = isweep(ibatched, keys)
    counts = np.asarray(ibatched.counts[0])
    assert counts.shape == (2, 4)
    np.testing.assert_array_equal(counts.sum(axis=-1), 8)


def test_init_distributed_failure_policy(monkeypatch):
    """Init failures only degrade to single-process
    when no distributed environment is detectable — and loudly."""
    import warnings

    import pytest

    from common_tpu.parallel import mesh as mesh_mod

    def boom(**kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    for marker in mesh_mod._DIST_ENV_MARKERS:
        monkeypatch.delenv(marker, raising=False)

    # no distributed evidence: falls back, but warns
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert mesh_mod.init_distributed() == 0
    assert any("single-process" in str(x.message) for x in w)

    # explicit multi-process request: re-raises
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        mesh_mod.init_distributed(num_processes=4)
    # explicit coordinator address: re-raises
    with pytest.raises(RuntimeError):
        mesh_mod.init_distributed(coordinator_address="10.0.0.1:8476")
    # coordinator env var present (pod auto-detect case): re-raises
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    with pytest.raises(RuntimeError):
        mesh_mod.init_distributed()

    # already-initialized: benign no-op, no warning
    def already(**kw):
        raise RuntimeError("jax.distributed is already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", already)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert mesh_mod.init_distributed(num_processes=4) == 0
    assert not w
