"""State bookkeeping tests (group_manager / entity_state analog).

Key invariant battery: the scan-based incremental ops (add/remove/score)
must agree exactly with from-scratch computation (compute_stats +
score_joint), and the EPPF must match hand-computed CRP probabilities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import gammaln

from common_tpu import models
from common_tpu import state as st

KEY = jax.random.key(0)


def make_problem(n=6, seed=0, k_max=8):
    r = np.random.default_rng(seed)
    defn = st.model_definition(n, [models.niw(2), models.bb], k_max=k_max)
    data = (
        (jnp.asarray(r.normal(size=(n, 2)), jnp.float32), jnp.ones(n)),
        (jnp.asarray(r.integers(0, 2, size=n)), jnp.ones(n)),
    )
    return defn, data


def test_initialize_counts_and_stats():
    defn, data = make_problem()
    assignment = jnp.asarray([0, 0, 1, 1, 1, 2], jnp.int32)
    s = st.initialize(defn, data, KEY, assignment=assignment)
    np.testing.assert_array_equal(
        np.asarray(s.counts), [2, 3, 1, 0, 0, 0, 0, 0]
    )
    assert s.ngroups() == 3
    np.testing.assert_array_equal(s.groups(), [0, 1, 2])
    np.testing.assert_array_equal(s.empty_groups(), [3, 4, 5, 6, 7])
    # stats of group 0 = sum of rows 0,1
    x = np.asarray(data[0][0])
    np.testing.assert_allclose(
        np.asarray(s.stats[0]["sum_x"][0]), x[0] + x[1], rtol=1e-6
    )
    np.testing.assert_allclose(np.asarray(s.stats[0]["n"]), [2, 3, 1, 0, 0, 0, 0, 0])


def test_add_remove_roundtrip():
    defn, data = make_problem()
    s0 = st.initialize(
        defn, data, KEY, assignment=jnp.asarray([0, 0, 1, 1, 1, 2], jnp.int32)
    )
    s1 = st.remove_value(s0, data, 3)
    assert int(s1.assignments[3]) == -1
    assert int(s1.counts[1]) == 2
    s2 = st.add_value(s1, data, 3, jnp.asarray(1))
    np.testing.assert_array_equal(np.asarray(s2.counts), np.asarray(s0.counts))
    for f in range(2):
        for k in s0.stats[f]:
            np.testing.assert_allclose(
                np.asarray(s2.stats[f][k]),
                np.asarray(s0.stats[f][k]),
                rtol=1e-5,
                atol=1e-5,
            )


def test_remove_empties_slot_clears_stats():
    defn, data = make_problem()
    s0 = st.initialize(
        defn, data, KEY, assignment=jnp.asarray([0, 0, 1, 1, 1, 2], jnp.int32)
    )
    s1 = st.remove_value(s0, data, 5)  # group 2 had one member
    assert int(s1.counts[2]) == 0
    for f in range(2):
        for leaf in jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda a: a[2], s1.stats[f])
        ):
            np.testing.assert_allclose(np.asarray(leaf), 0.0, atol=1e-6)


def test_incremental_matches_scratch():
    """After a chain of add/removes, stats == compute_stats from scratch."""
    defn, data = make_problem(n=8, k_max=6)
    s = st.initialize(
        defn, data, KEY,
        assignment=jnp.asarray([0, 1, 0, 2, 1, 0, 3, 2], jnp.int32),
    )
    moves = [(0, 2), (6, 0), (3, 3), (7, 1), (4, 4)]
    for eid, gid in moves:
        s = st.remove_value(s, data, eid)
        s = st.add_value(s, data, eid, jnp.asarray(gid))
    scratch = st.compute_stats(defn, s.hypers, data, s.assignments)
    for f in range(2):
        for k in s.stats[f]:
            np.testing.assert_allclose(
                np.asarray(s.stats[f][k]),
                np.asarray(scratch[f][k]),
                rtol=1e-4,
                atol=1e-4,
            )
    np.testing.assert_array_equal(
        np.asarray(s.counts),
        np.bincount(np.asarray(s.assignments), minlength=6),
    )


def test_eppf_matches_closed_form():
    defn, data = make_problem()
    alpha = 1.7
    s = st.initialize(
        defn, data, KEY,
        cluster_hp={"alpha": alpha},
        assignment=jnp.asarray([0, 0, 1, 1, 1, 2], jnp.int32),
    )
    counts = [2, 3, 1]
    expect = (
        3 * np.log(alpha)
        + sum(gammaln(c) for c in counts)
        + gammaln(alpha)
        - gammaln(alpha + 6)
    )
    np.testing.assert_allclose(st.score_assignment(s), expect, rtol=1e-5)


def test_crp_prior_scores():
    defn, data = make_problem()
    alpha = 0.8
    s = st.initialize(
        defn, data, KEY,
        cluster_hp={"alpha": alpha},
        assignment=jnp.asarray([0, 0, 1, 1, 1, 2], jnp.int32),
    )
    scores = np.asarray(st.crp_prior_scores(s))
    np.testing.assert_allclose(scores[:3], np.log([2, 3, 1]), rtol=1e-6)
    np.testing.assert_allclose(scores[3], np.log(alpha), rtol=1e-6)
    assert np.all(np.isneginf(scores[4:]))


def test_score_value_is_predictive_delta():
    """score_value(eid)[k] == Δ joint logp of seating eid at k, up to the
    slot-independent CRP normalizer −log(α + N − 1).

    The fundamental identity that makes collapsed Gibbs correct — checks
    the whole scoring path against score_joint.
    """
    defn, data = make_problem()
    s = st.initialize(
        defn, data, KEY, assignment=jnp.asarray([0, 0, 1, 1, 1, 2], jnp.int32)
    )
    eid = 4
    s_rm = st.remove_value(s, data, eid)
    scores = np.asarray(st.score_value(s_rm, data, eid))
    base = float(st.score_joint(s_rm))
    deltas = []
    for gid in range(4):  # 3 active + 1 birth candidate
        s_try = st.add_value(s_rm, data, eid, jnp.asarray(gid))
        deltas.append(float(st.score_joint(s_try)) - base)
    deltas = np.asarray(deltas)
    # affine match: same vector up to one additive constant
    np.testing.assert_allclose(
        scores[:4] - scores[0], deltas - deltas[0], rtol=1e-3, atol=1e-3
    )
    alpha, n_after = 1.0, 6
    np.testing.assert_allclose(
        scores[:4] - deltas, np.log(alpha + n_after - 1), rtol=1e-3
    )
    assert np.all(np.isneginf(scores[4:]))


def test_fixed_state_dirichlet_scores():
    defn, data = make_problem(k_max=3)
    alphas = np.array([0.5, 1.0, 1.5], np.float32)
    s = st.initialize(
        defn, data, KEY,
        cluster_hp={"alphas": alphas},
        assignment=jnp.asarray([0, 0, 1, 1, 1, 2], jnp.int32),
        fixed=True,
    )
    scores = np.asarray(st.crp_prior_scores(s))
    np.testing.assert_allclose(
        scores, np.log(np.array([2, 3, 1]) + alphas), rtol=1e-6
    )
    counts = np.array([2.0, 3, 1])
    expect = (
        (gammaln(alphas + counts) - gammaln(alphas)).sum()
        + gammaln(alphas.sum())
        - gammaln(alphas.sum() + 6)
    )
    np.testing.assert_allclose(st.score_assignment(s), expect, rtol=1e-5)


def test_crp_prior_sampler_distribution():
    """sample_crp_assignment: P(partition) matches the CRP EPPF for n=3."""
    from common_tpu import testutil

    n, k_max, alpha = 3, 4, 1.3

    draws = jax.jit(
        jax.vmap(
            lambda k: st.sample_crp_assignment(k, n, k_max, jnp.asarray(alpha))
        )
    )(jax.random.split(jax.random.key(1), 4000))
    draws = np.asarray(draws)

    def eppf(part):
        counts = np.bincount(part)
        k = len(counts)
        return (
            k * np.log(alpha)
            + gammaln(counts).sum()
            + gammaln(alpha)
            - gammaln(alpha + n)
        )

    parts = list(testutil.permutation_iter(n))
    probs = testutil.scores_to_probs([eppf(np.asarray(p)) for p in parts])
    dist = dict(zip(parts, probs))

    def sample_fn(ns):
        return [
            testutil.permutation_canonical(draws[i]) for i in range(min(ns, len(draws)))
        ]

    testutil.assert_discrete_dist_approx(sample_fn, dist, nsamples=4000)


def test_masked_rows_excluded_from_stats():
    defn, data = make_problem()
    (x0, _), (x1, _) = data
    mask0 = jnp.asarray([1, 1, 0, 1, 1, 1], jnp.float32)
    data_masked = ((x0, mask0), (x1, jnp.ones(6)))
    s = st.initialize(
        defn, data_masked, KEY,
        assignment=jnp.asarray([0, 0, 1, 1, 1, 2], jnp.int32),
    )
    # feature 0, group 1 has members {2,3,4} but row 2 masked -> n=2
    np.testing.assert_allclose(float(s.stats[0]["n"][1]), 2.0)
    np.testing.assert_allclose(float(s.stats[1]["n"][1]), 3.0)
    # cluster counts unaffected by per-feature masks
    np.testing.assert_array_equal(np.asarray(s.counts)[:3], [2, 3, 1])


# ---------------------------------------------------------------------------
# K_max overflow policy (SURVEY.md §7 hard parts)
# ---------------------------------------------------------------------------
def test_saturation_detection_and_repad():
    import dataclasses

    import pytest as _pytest

    r = np.random.default_rng(11)
    n, k_small = 8, 3
    defn = st.model_definition(n, [models.bb], k_max=k_small)
    data = ((jnp.asarray(r.integers(0, 2, size=n)), jnp.ones(n)),)
    # force all slots occupied
    z = jnp.asarray(np.arange(n) % k_small, jnp.int32)
    s = st.initialize(defn, data, jax.random.key(0),
                      cluster_hp={"alpha": 1.0}, assignment=z)
    assert bool(st.is_saturated(s))

    s2 = st.repad(s, 8)
    assert s2.k_max == 8
    assert not bool(st.is_saturated(s2))
    # counts preserved + zero-padded; suffstats zero in new slots
    np.testing.assert_array_equal(np.asarray(s2.counts[:k_small]),
                                  np.asarray(s.counts))
    assert int(jnp.sum(s2.counts[k_small:])) == 0
    for leaf in jax.tree_util.tree_leaves(s2.stats):
        np.testing.assert_allclose(np.asarray(leaf[k_small:]), 0.0)
    # scores agree: the padded state describes the same partition + data
    np.testing.assert_allclose(
        float(st.score_joint(s)), float(st.score_joint(s2)), rtol=1e-6
    )
    # repadded state can open a new cluster (log-alpha on first empty slot)
    scores = st.crp_prior_scores(s2)
    assert np.isfinite(float(scores[k_small]))
    # and kernels run on it
    from common_tpu.kernels import gibbs

    s3 = gibbs.assign(s2, data, jax.random.key(1))
    assert int(jnp.sum(s3.counts)) == n

    with _pytest.raises(ValueError):
        st.repad(s, 2)
    defn_f = st.model_definition(n, [models.bb], k_max=k_small)
    sf = st.initialize(defn_f, data, jax.random.key(0), fixed=True,
                       assignment=z)
    assert not bool(st.is_saturated(sf))
    with _pytest.raises(ValueError):
        st.repad(sf, 8)


def test_runner_saturation_warning_and_jsonl(tmp_path):
    import json as _json
    import warnings as _warnings

    from common_tpu.runner import runner

    r = np.random.default_rng(12)
    n, k_small = 9, 3
    defn = st.model_definition(n, [models.bb], k_max=k_small)
    data = ((jnp.asarray(r.integers(0, 2, size=n)), jnp.ones(n)),)
    z = jnp.asarray(np.arange(n) % k_small, jnp.int32)
    s = st.initialize(defn, data, jax.random.key(0),
                      cluster_hp={"alpha": 0.01}, assignment=z)
    path = str(tmp_path / "sweeps.jsonl")
    run = runner(defn, data, s, ["assign"], jsonl_path=path)
    with _warnings.catch_warnings(record=True) as w:
        _warnings.simplefilter("always")
        run.run(jax.random.key(1), 5)
    # low alpha keeps all 3 slots full -> saturation warning fires
    assert any("cluster slots are occupied" in str(x.message) for x in w) or \
        not bool(st.is_saturated(run.get_latent()))
    lines = [_json.loads(l) for l in open(path)]
    assert len(lines) == 5
    assert {"sweep", "score_joint", "k_active", "occupancy", "ess"} <= set(lines[0])
    assert lines[-1]["ess"] is not None
    assert sum(lines[0]["occupancy"]) == n


def test_sample_prior_generative():
    """st.sample draws (data, assignment) consumable by initialize, with
    CRP-consistent cluster usage."""
    defn = st.model_definition(300, [models.niw(2), models.bb], k_max=16)
    data, z = st.sample(defn, jax.random.key(0), cluster_hp={"alpha": 2.0})
    assert data[0][0].shape == (300, 2)
    assert data[1][0].shape == (300,)
    z = np.asarray(z)
    assert z.min() >= 0 and z.max() < 16
    # bb values are 0/1
    assert set(np.unique(np.asarray(data[1][0]))) <= {0.0, 1.0}
    s = st.initialize(defn, data, jax.random.key(1),
                      assignment=jnp.asarray(z))
    assert np.isfinite(float(st.score_joint(s)))


def test_sample_post_pred_tracks_posterior():
    """Posterior-predictive draws concentrate near the data's clusters."""
    r = np.random.default_rng(0)
    centers = np.array([[-6.0], [6.0]])
    zt = r.integers(0, 2, 400)
    x = (centers[zt][:, 0] + r.normal(scale=0.5, size=400)).astype(np.float32)
    defn = st.model_definition(400, [models.niw(1)], k_max=8)
    data = ((jnp.asarray(x)[:, None], jnp.ones(400)),)
    s = st.initialize(defn, data, jax.random.key(0),
                      assignment=jnp.asarray(zt, jnp.int32))
    pp, zz = st.sample_post_pred(s, jax.random.key(1), size=200)
    vals = np.asarray(pp[0][0])[:, 0]
    assert zz.shape == (200,)
    # nearly all mass within the two posterior modes
    near = (np.abs(vals + 6) < 3) | (np.abs(vals - 6) < 3)
    assert near.mean() > 0.9, near.mean()
    # both modes visited
    assert (vals < 0).any() and (vals > 0).any()


def test_sample_post_pred_validates_size():
    defn = st.model_definition(10, [models.bb], k_max=4)
    data = ((jnp.zeros(10), jnp.ones(10)),)
    s = st.initialize(defn, data, jax.random.key(0))
    with pytest.raises(ValueError):
        st.sample_post_pred(s, jax.random.key(1), size=0)


def test_heldout_logp_consistency():
    """heldout_logp == logsumexp(score_value) - logsumexp(crp weights),
    and the bb predictive normalizes over {0, 1}."""
    r = np.random.default_rng(3)
    n = 40
    X = r.normal(size=(n, 2)).astype(np.float32)
    B = (r.random(n) < 0.4).astype(np.float32)
    defn = st.model_definition(n, [models.niw(2), models.bb], k_max=8)
    data = (
        (jnp.asarray(X), jnp.ones(n, jnp.float32)),
        (jnp.asarray(B), jnp.ones(n, jnp.float32)),
    )
    s = st.initialize(defn, data, jax.random.key(0),
                      cluster_hp={"alpha": 1.5})

    H = 5
    Xh = r.normal(size=(H, 2)).astype(np.float32)
    Bh = (r.random(H) < 0.5).astype(np.float32)
    held = (
        (jnp.asarray(Xh), jnp.ones(H, jnp.float32)),
        (jnp.asarray(Bh), jnp.ones(H, jnp.float32)),
    )
    got = np.asarray(st.heldout_logp(s, held))
    assert got.shape == (H,)

    from scipy.special import logsumexp as slse

    crp = np.asarray(st.crp_prior_scores(s))
    for i in range(H):
        row = (
            (jnp.asarray(Xh[i: i + 1]), jnp.ones(1, jnp.float32)),
            (jnp.asarray(Bh[i: i + 1]), jnp.ones(1, jnp.float32)),
        )
        sv = np.asarray(st.score_value(s, row, 0))
        want = slse(sv) - slse(crp[np.isfinite(crp)])
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)

    # bb alone: predictive mass over {0, 1} must be 1
    defn_b = st.model_definition(n, [models.bb], k_max=8)
    data_b = ((jnp.asarray(B), jnp.ones(n, jnp.float32)),)
    sb = st.initialize(defn_b, data_b, jax.random.key(1),
                       cluster_hp={"alpha": 1.0})
    vals = (
        (jnp.asarray(np.array([0.0, 1.0], np.float32)),
         jnp.ones(2, jnp.float32)),
    )
    p = np.exp(np.asarray(st.heldout_logp(sb, vals)))
    np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-5)

    # masked cells contribute nothing: fully-masked row scores 0
    held_masked = (
        (jnp.asarray(Xh[:1]), jnp.zeros(1, jnp.float32)),
        (jnp.asarray(Bh[:1]), jnp.zeros(1, jnp.float32)),
    )
    np.testing.assert_allclose(
        np.asarray(st.heldout_logp(s, held_masked)), 0.0, atol=1e-5
    )
