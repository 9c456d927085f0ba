"""SMC tests: systematic resampling, marginal-likelihood (evidence)
estimate vs exact enumeration, posterior over partitions vs enumeration,
and the particle-sharded multi-device path on the virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import logsumexp as sp_logsumexp

from common_tpu import models, testutil
from common_tpu import state as st
from common_tpu.kernels import smc


def _exact_log_evidence(defn, data, cluster_hp):
    """log p(data) = logsumexp over all partitions of score_joint."""
    key = jax.random.key(0)
    scores = []
    for part in testutil.permutation_iter(defn.n):
        s = st.initialize(
            defn, data, key, cluster_hp=cluster_hp,
            assignment=jnp.asarray(part, jnp.int32),
        )
        scores.append(float(st.score_joint(s)))
    return sp_logsumexp(scores)


def _small_problem(n=6, seed=0):
    r = np.random.default_rng(seed)
    x = r.integers(0, 2, size=n)
    defn = st.model_definition(n, [models.bb], k_max=n + 1)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    return defn, data


def test_systematic_resample_proportional():
    log_w = jnp.log(jnp.asarray([0.1, 0.2, 0.3, 0.4]))
    counts = np.zeros(4)
    for i in range(200):
        idx = np.asarray(smc.systematic_resample(jax.random.key(i), log_w))
        counts += np.bincount(idx, minlength=4)
    freqs = counts / counts.sum()
    assert np.allclose(freqs, [0.1, 0.2, 0.3, 0.4], atol=0.02), freqs


def test_log_ess():
    uniform = jnp.zeros(16)
    assert np.isclose(float(jnp.exp(smc.log_ess(uniform))), 16.0)
    degenerate = jnp.asarray([0.0] + [-np.inf] * 15)
    assert np.isclose(float(jnp.exp(smc.log_ess(degenerate))), 1.0)


def test_smc_evidence_matches_enumeration():
    defn, data = _small_problem(n=6)
    chp = {"alpha": 1.3}
    exact = _exact_log_evidence(defn, data, chp)

    logzs = []
    for seed in range(8):
        parts = smc.init_particles(
            defn, data, jax.random.key(seed), 256, cluster_hp=chp
        )
        res = smc.run(parts, data, jax.random.key(100 + seed))
        logzs.append(float(res.logz))
    logzs = np.asarray(logzs)
    # log of the averaged Z-hats should be close to exact (unbiased in Z)
    log_mean_z = sp_logsumexp(logzs) - np.log(len(logzs))
    assert abs(log_mean_z - exact) < 0.1, (log_mean_z, exact, logzs)
    # all rows seated, counts consistent
    counts = np.asarray(res.particles.counts)
    assert (counts.sum(axis=-1) == defn.n).all()


def test_smc_posterior_matches_enumeration():
    defn, data = _small_problem(n=5, seed=3)
    chp = {"alpha": 1.0}
    key = jax.random.key(0)
    # exact posterior over canonical partitions
    scores, parts_list = [], []
    for part in testutil.permutation_iter(defn.n):
        s = st.initialize(defn, data, key, cluster_hp=chp,
                          assignment=jnp.asarray(part, jnp.int32))
        scores.append(float(st.score_joint(s)))
        parts_list.append(part)
    probs = np.exp(scores - sp_logsumexp(scores))
    exact = dict(zip(parts_list, probs))

    # SMC weighted partition distribution, pooled over repeats
    est = {p: 0.0 for p in parts_list}
    total = 0.0
    for seed in range(6):
        particles = smc.init_particles(
            defn, data, jax.random.key(10 + seed), 512, cluster_hp=chp
        )
        res = smc.run(particles, data, jax.random.key(200 + seed),
                      rejuvenation_moves=2)
        asg, w = smc.posterior_partition_weights(res)
        asg, w = np.asarray(asg), np.asarray(w)
        for a, wi in zip(asg, w):
            est[testutil.permutation_canonical(a)] += float(wi)
            total += float(wi)
    est = {p: v / total for p, v in est.items()}
    kl = sum(
        q * (np.log(q) - np.log(max(est[p], 1e-10)))
        for p, q in exact.items() if q > 0
    )
    assert kl < 0.05, (kl, exact, est)


def test_smc_sharded_matches_single_device(cpu_devices):
    defn, data = _small_problem(n=6, seed=1)
    chp = {"alpha": 1.0}
    exact = _exact_log_evidence(defn, data, chp)

    mesh = smc.make_particle_mesh(devices=cpu_devices[:8])
    logzs = []
    with jax.default_device(cpu_devices[0]):
        for seed in range(6):
            parts = smc.init_particles(
                defn, data, jax.random.key(seed), 256, cluster_hp=chp
            )
            parts, sdata = smc.shard_particles(mesh, parts, data)
            res = smc.run_sharded(mesh, parts, sdata, jax.random.key(300 + seed))
            logzs.append(float(res.logz))
            counts = np.asarray(res.particles.counts)
            assert (counts.sum(axis=-1) == defn.n).all()
    log_mean_z = sp_logsumexp(logzs) - np.log(len(logzs))
    assert abs(log_mean_z - exact) < 0.15, (log_mean_z, exact, logzs)


def test_smc_fixed_k():
    """Fixed-K Dirichlet prior path: runs, seats all rows, finite logz."""
    n = 8
    r = np.random.default_rng(2)
    x = r.integers(0, 2, size=n)
    defn = st.model_definition(n, [models.bb], k_max=3)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    parts = smc.init_particles(
        defn, data, jax.random.key(0), 64,
        cluster_hp={"alphas": np.full(3, 0.7, np.float32)}, fixed=True,
    )
    res = smc.run(parts, data, jax.random.key(1))
    assert np.isfinite(float(res.logz))
    assert (np.asarray(res.particles.counts).sum(axis=-1) == n).all()


def test_row_smc_scale_cap_guard():
    """The row-sequential scan (one device step per row) is fenced at
    ROW_SCAN_CAP; at-scale SMC is run_blocked."""
    n = smc.ROW_SCAN_CAP + 1
    defn = st.model_definition(n, [models.bb], k_max=4)
    data = ((jnp.zeros(n), jnp.ones(n)),)
    parts = smc.init_particles(defn, data, jax.random.key(0), 4,
                               cluster_hp={"alpha": 1.0})
    with pytest.raises(ValueError, match="safety cap"):
        smc.run(parts, data, jax.random.key(1))


@pytest.mark.parametrize("warmup", [0, 3, 512])
def test_block_smc_evidence_matches_enumeration(warmup):
    """Block-SMC log Z vs exact enumeration (truncation error at
    K_max=16, n=6, alpha=1.3 is ~4n·exp(−15/1.3) ≈ 1e-4 — negligible).

    warmup=0 exercises the pure block path (`_seat_block` RB weights),
    warmup=512 the pure row-warmup path (`_warmup_row`), warmup=3 the
    phase transition — all must be unbiased for the same evidence.
    """
    n = 6
    r = np.random.default_rng(0)
    x = r.integers(0, 2, size=n)
    defn = st.model_definition(n, [models.bb], k_max=16)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    chp = {"alpha": 1.3}
    exact = _exact_log_evidence(defn, data, chp)

    logzs = []
    for seed in range(8):
        parts = smc.init_particles(
            defn, data, jax.random.key(seed), 256, cluster_hp=chp
        )
        res = smc.run_blocked(parts, data, jax.random.key(100 + seed),
                              block=2, warmup=warmup)
        logzs.append(float(res.logz))
        counts = np.asarray(res.particles.counts)
        assert (counts.sum(axis=-1) == n).all()
        asg = np.asarray(res.particles.assignments)
        assert asg.shape == (256, n)
        assert (asg >= 0).all()
    log_mean_z = sp_logsumexp(logzs) - np.log(len(logzs))
    assert abs(log_mean_z - exact) < 0.12, (log_mean_z, exact, logzs)


@pytest.mark.parametrize("warmup", [0, 512])
def test_block_smc_evidence_matches_enumeration_niw(warmup):
    """Same oracle check with the headline NIW likelihood (d=2)."""
    n = 5
    r = np.random.default_rng(4)
    x = r.normal(size=(n, 2)).astype(np.float32)
    defn = st.model_definition(n, [models.niw(2)], k_max=16)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    chp = {"alpha": 1.0}
    exact = _exact_log_evidence(defn, data, chp)

    logzs = []
    for seed in range(8):
        parts = smc.init_particles(
            defn, data, jax.random.key(seed), 256, cluster_hp=chp
        )
        res = smc.run_blocked(parts, data, jax.random.key(50 + seed),
                              block=2, warmup=warmup)
        logzs.append(float(res.logz))
    log_mean_z = sp_logsumexp(logzs) - np.log(len(logzs))
    assert abs(log_mean_z - exact) < 0.25, (log_mean_z, exact, logzs)


def test_block_smc_logz_respects_gibbs_joint_bound_medium_scale():
    """log Z ≥ log p(z, data) for ANY
    z, so a converged collapsed-Gibbs chain's score_joint lower-bounds
    the true log evidence.  Round 4's block-SMC logz sat 4× BELOW this
    bound at n=8k (≈ −870k vs −220k); the RB-weight + row-warmup redesign
    must keep the estimate above it (row-sequential SMC reads ≈ −208k on
    this problem; truncation error 4n·exp(−(K−1)/α) ≈ 1e-10 at K=32).

    Medium scale on purpose: tiny-n enumeration tests cannot see this
    failure mode."""
    from common_tpu.kernels import blocked

    n, d, K, P, B = 4096, 8, 32, 16, 512
    r = np.random.default_rng(0)
    centers = r.normal(scale=3.0, size=(8, d))
    zt = r.integers(0, 8, size=n)
    x = (centers[zt] + r.normal(size=(n, d))).astype(np.float32)
    defn = st.model_definition(n, [models.niw(d)], k_max=K)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    chp = {"alpha": 1.0}

    state = st.initialize(defn, data, jax.random.key(0), cluster_hp=chp)

    @jax.jit
    def chain(s, keys):
        return jax.lax.scan(
            lambda st_, k: (blocked.sweep(st_, data, k), st.score_joint(st_)),
            s, keys,
        )

    state, joints = chain(state, jax.random.split(jax.random.key(1), 20))
    bound = max(float(st.score_joint(state)), float(jnp.max(joints)))

    parts = smc.init_particles(defn, data, jax.random.key(2), P,
                               cluster_hp=chp)
    res = smc.run_blocked(parts, data, jax.random.key(3), block=B)
    logz = float(res.logz)
    # slack: f32 marginal-loglik cancellation noise across 8 blocks plus
    # MC slack; the r04 defect overshot this bound by 45 000+ nats even
    # after the RB fix alone.
    assert logz >= bound - 100.0, (logz, bound)
    assert (np.asarray(res.particles.counts).sum(axis=-1) == n).all()


@pytest.mark.slow
def test_block_smc_matches_row_smc_moderate():
    """At 64 rows the block path's evidence agrees with the row path's
    (both unbiased in Z; truncation negligible at K_max=24)."""
    n = 64
    r = np.random.default_rng(7)
    x = r.integers(0, 2, size=n)
    defn = st.model_definition(n, [models.bb], k_max=24)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    chp = {"alpha": 1.0}

    def mean_logz(runner, base):
        logzs = []
        for seed in range(6):
            parts = smc.init_particles(
                defn, data, jax.random.key(base + seed), 512,
                cluster_hp=chp,
            )
            logzs.append(float(runner(parts, jax.random.key(7 + seed))))
        return sp_logsumexp(logzs) - np.log(len(logzs)), logzs

    row, _ = mean_logz(
        lambda p, k: smc.run(p, data, k, rejuvenation_moves=1).logz, 0
    )
    blk, _ = mean_logz(
        lambda p, k: smc.run_blocked(p, data, k, block=16).logz, 100
    )
    assert abs(row - blk) < 0.6, (row, blk)


def test_block_smc_fixed_k():
    n = 12
    r = np.random.default_rng(2)
    x = r.integers(0, 2, size=n)
    defn = st.model_definition(n, [models.bb], k_max=3)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    parts = smc.init_particles(
        defn, data, jax.random.key(0), 64,
        cluster_hp={"alphas": np.full(3, 0.7, np.float32)}, fixed=True,
    )
    res = smc.run_blocked(parts, data, jax.random.key(1), block=4)
    assert np.isfinite(float(res.logz))
    assert (np.asarray(res.particles.counts).sum(axis=-1) == n).all()


def test_block_smc_rejects_nonconjugate():
    n = 6
    defn = st.model_definition(n, [models.bbnc], k_max=4)
    data = ((jnp.zeros(n), jnp.ones(n)),)
    parts = smc.init_particles(defn, data, jax.random.key(0), 8,
                               cluster_hp={"alpha": 1.0})
    with pytest.raises(ValueError, match="conjugate"):
        smc.run_blocked(parts, data, jax.random.key(1), block=2)


@pytest.mark.slow  # ~50 s; row-variant sharded agreement +
# multichip dryrun cover the collective path in the fast gate
def test_block_smc_sharded_matches_single_device(cpu_devices):
    n = 6
    r = np.random.default_rng(1)
    x = r.integers(0, 2, size=n)
    defn = st.model_definition(n, [models.bb], k_max=16)
    data = ((jnp.asarray(x), jnp.ones(n)),)
    chp = {"alpha": 1.0}
    exact = _exact_log_evidence(defn, data, chp)

    mesh = smc.make_particle_mesh(devices=cpu_devices[:8])
    logzs = []
    with jax.default_device(cpu_devices[0]):
        for seed in range(6):
            parts = smc.init_particles(
                defn, data, jax.random.key(seed), 256, cluster_hp=chp
            )
            parts, sdata = smc.shard_particles(mesh, parts, data)
            res = smc.run_blocked_sharded(
                mesh, parts, sdata, jax.random.key(400 + seed), block=2
            )
            logzs.append(float(res.logz))
            counts = np.asarray(res.particles.counts)
            assert (counts.sum(axis=-1) == n).all()
    log_mean_z = sp_logsumexp(logzs) - np.log(len(logzs))
    assert abs(log_mean_z - exact) < 0.15, (log_mean_z, exact, logzs)


def test_posterior_sample_shape():
    defn, data = _small_problem(n=5)
    parts = smc.init_particles(defn, data, jax.random.key(0), 32,
                               cluster_hp={"alpha": 1.0})
    res = smc.run(parts, data, jax.random.key(1))
    one = smc.posterior_sample(jax.random.key(2), res)
    assert one.assignments.shape == (defn.n,)
    assert int(one.counts.sum()) == defn.n
