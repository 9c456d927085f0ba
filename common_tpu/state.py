"""Clustering state — the JAX rebuild of the reference's bookkeeping.

Reference analogs:
  - ``common:include/microscopes/common/group_manager.hpp`` —
    ``group_manager<T>`` (CRP assignment vector, gid→(count, suffstats) map,
    empty-group set, EPPF scoring, create/delete/add/remove) and
    ``fixed_group_manager<T>`` (fixed K, Dirichlet prior).
  - ``common:include/microscopes/common/entity_state.hpp`` — the abstract
    ``entity_based_state_object`` kernel interface
    (add_value/remove_value/score_value/score_assignment/score_likelihood).

Vectorized design (SURVEY.md §2.2): dynamic group birth/death becomes a
**fixed-capacity padded representation** with static shapes —
``assignments[N]`` (−1 = unassigned), ``counts[K_max]``, per-feature
suffstat pytrees with leading ``[K_max]`` — so every operation is a masked
vector op under `jit`.  "Create group" = touch the first empty slot;
"delete group" = the slot's count hits zero (its stats are zero-cleared to
kill float drift).  The entity_state OO interface becomes a set of pure
functions ``(state, data, eid) -> state`` / scores; kernels compose them
under `lax.scan`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

from common_tpu import validator
from common_tpu.likelihoods import base as lik_base
from common_tpu.models import model_descriptor

NEG_INF = -jnp.inf


# ---------------------------------------------------------------------------
# definition (model_definition analog — mixturemodel:…/definition.py)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MixtureDefinition:
    """Problem shape: number of rows, feature models, cluster capacity."""

    n: int
    models: Tuple[model_descriptor, ...]
    k_max: int

    def __post_init__(self):
        validator.validate_positive(self.n, "n")
        validator.validate_positive(self.k_max, "k_max")
        validator.validate_nonempty(self.models, "models")
        object.__setattr__(self, "models", tuple(self.models))

    @property
    def nfeatures(self) -> int:
        return len(self.models)

    def likelihoods(self):
        return tuple(m.likelihood for m in self.models)


def model_definition(n: int, models: Sequence[model_descriptor], k_max: int = 64):
    """Reference-parity constructor (mixturemodel's ``model_definition``)."""
    return MixtureDefinition(n, tuple(models), k_max)


# ---------------------------------------------------------------------------
# state pytree
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MixtureState:
    """Padded-K clustering state (group_manager + per-feature suffstats).

    Pytree leaves (batchable over chains/particles via extra leading axes):
      assignments [N] int32, −1 = unassigned
      counts      [K] int32, rows per cluster (0 = empty slot)
      cluster_hp  dict — {'alpha': scalar} CRP, or {'alphas': [K]} fixed-K
      stats       tuple over features of suffstat dict pytrees, leaves [K,…]
      hypers      tuple over features of hyper dict pytrees

    Static metadata:
      lik_names   tuple of likelihood registry names (resolves kernels)
      fixed       True = fixed-K Dirichlet prior (fixed_group_manager)
    """

    assignments: jax.Array
    counts: jax.Array
    cluster_hp: Dict[str, Any]
    stats: Tuple[Dict[str, Any], ...]
    hypers: Tuple[Dict[str, Any], ...]
    lik_names: Tuple[str, ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    fixed: bool = dataclasses.field(metadata=dict(static=True), default=False)

    # -- host-side conveniences (entity_based_state_object surface) ------
    @property
    def n(self) -> int:
        return self.assignments.shape[-1]

    @property
    def k_max(self) -> int:
        return self.counts.shape[-1]

    def nentities(self) -> int:
        return self.n

    def ngroups(self):
        return jnp.sum(self.counts > 0, axis=-1)

    def groups(self):
        """Active group ids (host-side, eager)."""
        return np.nonzero(np.asarray(self.counts) > 0)[0]

    def empty_groups(self):
        return np.nonzero(np.asarray(self.counts) == 0)[0]

    def likelihoods(self):
        return tuple(lik_base.get(n) for n in self.lik_names)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------
def compute_stats(defn: MixtureDefinition, hypers, data, assignments):
    """Per-feature suffstats from scratch via one segment-sum per leaf.

    The parallel analog of the reference's initialize() add_value loop
    (SURVEY.md §3.1) — and the periodic drift-refresh for long MCMC runs.
    Unassigned rows (gid −1) are routed to a scratch segment and dropped.
    """
    K = defn.k_max
    gid = jnp.where(assignments >= 0, assignments, K)

    stats = []
    for (x, mask), desc, hyper in zip(data, defn.models, hypers):
        stats.append(
            desc.likelihood.stats_from_assignments(hyper, x, mask, gid, K)
        )
    return tuple(stats)


def _assignment_counts(assignments, k_max):
    gid = jnp.where(assignments >= 0, assignments, k_max)
    return jax.ops.segment_sum(
        jnp.ones_like(assignments), gid, num_segments=k_max + 1
    )[:k_max].astype(jnp.int32)


def initialize(
    defn: MixtureDefinition,
    data,
    key,
    cluster_hp: Optional[Dict[str, Any]] = None,
    feature_hps: Optional[Sequence[Dict[str, Any]]] = None,
    assignment=None,
    fixed: bool = False,
) -> MixtureState:
    """Build an initialized state (reference: state.initialize(defn, view, rng)).

    assignment: None → sample from the CRP prior (capped at k_max);
    or an [N] int array of group ids.
    """
    validator.validate_len(data, defn.nfeatures, "data columns")
    hypers = tuple(
        desc.canonical_hyper(
            None if feature_hps is None else feature_hps[f]
        )
        for f, desc in enumerate(defn.models)
    )
    if fixed:
        chp = {"alphas": jnp.asarray(
            (cluster_hp or {}).get("alphas", np.ones(defn.k_max, np.float32))
        )}
    else:
        chp = {"alpha": jnp.asarray((cluster_hp or {}).get("alpha", 1.0))}

    if assignment is None:
        assignment = sample_crp_assignment(
            key, defn.n, defn.k_max,
            chp["alpha"] if not fixed else jnp.asarray(1.0),
        )
    assignment = jnp.asarray(assignment, jnp.int32)

    counts = _assignment_counts(assignment, defn.k_max)
    stats = compute_stats(defn, hypers, data, assignment)

    return MixtureState(
        assignments=assignment,
        counts=counts,
        cluster_hp=chp,
        stats=stats,
        hypers=hypers,
        lik_names=tuple(m.name for m in defn.models),
        fixed=fixed,
    )


def sample_crp_assignment(key, n, k_max, alpha):
    """Sequential CRP prior draw (scan), capped at k_max tables."""

    def step(carry, i):
        counts, key = carry
        key, sub = jax.random.split(key)
        logw = jnp.where(counts > 0, jnp.log(counts.astype(jnp.float32)), NEG_INF)
        can_open = jnp.any(counts == 0)
        first_empty = jnp.argmax(counts == 0)
        logw = jnp.where(
            (jnp.arange(k_max) == first_empty) & can_open,
            jnp.log(alpha.astype(jnp.float32)),
            logw,
        )
        g = jax.random.gumbel(sub, (k_max,))
        z = jnp.argmax(logw + g)
        counts = counts.at[z].add(1)
        return (counts, key), z.astype(jnp.int32)

    (_, _), zs = jax.lax.scan(
        step, (jnp.zeros(k_max, jnp.int32), key), jnp.arange(n)
    )
    return zs


# ---------------------------------------------------------------------------
# entity ops (entity_based_state_object analog, pure-functional)
# ---------------------------------------------------------------------------
def _row_txs(state: MixtureState, data, eid):
    """Suffstat contributions of row `eid` for every feature."""
    out = []
    for (x, mask), lik, hyper in zip(data, state.likelihoods(), state.hypers):
        out.append(lik.tx(hyper, x[eid], mask[eid]))
    return out


def remove_value(state: MixtureState, data, eid) -> MixtureState:
    """Unassign row eid: downdate counts + suffstats; zero-clear emptied slot."""
    old = state.assignments[eid]
    present = (old >= 0).astype(jnp.int32)
    safe = jnp.maximum(old, 0)
    counts = state.counts.at[safe].add(-present)
    emptied = (counts[safe] == 0) & (present == 1)

    new_stats = []
    for txf, stats_f in zip(_row_txs(state, data, eid), state.stats):
        s = lik_base.scatter_fold(
            stats_f, safe, txf, -present.astype(jnp.float32)
        )
        s = lik_base.zero_slot(s, safe, jnp.logical_not(emptied))
        new_stats.append(s)

    return dataclasses.replace(
        state,
        assignments=state.assignments.at[eid].set(-1),
        counts=counts,
        stats=tuple(new_stats),
    )


def add_value(state: MixtureState, data, eid, gid) -> MixtureState:
    """Assign row eid to group gid: update counts + suffstats."""
    new_stats = []
    for txf, stats_f in zip(_row_txs(state, data, eid), state.stats):
        new_stats.append(lik_base.scatter_fold(stats_f, gid, txf, 1.0))
    return dataclasses.replace(
        state,
        assignments=state.assignments.at[eid].set(gid.astype(jnp.int32)),
        counts=state.counts.at[gid].add(1),
        stats=tuple(new_stats),
    )


def crp_prior_scores(state: MixtureState):
    """Per-slot log prior weight for seating a new row ([K], −inf = invalid).

    CRP: log n_k for active slots; log alpha on the first empty slot.
    Fixed-K Dirichlet: log(n_k + alpha_k) on every slot.
    """
    counts_f = state.counts.astype(jnp.float32)
    if state.fixed:
        return jnp.log(counts_f + state.cluster_hp["alphas"])
    active = state.counts > 0
    crp = jnp.where(active, jnp.log(counts_f), NEG_INF)
    can_open = jnp.any(~active)
    first_empty = jnp.argmax(~active)
    k = jnp.arange(state.k_max)
    return jnp.where(
        (k == first_empty) & can_open,
        jnp.log(state.cluster_hp["alpha"].astype(jnp.float32)),
        crp,
    )


def is_saturated(state: MixtureState):
    """True when every K_max slot is occupied (no empty slot to open).

    SURVEY.md §7 "hard parts": under the padded-K representation a CRP
    state with all slots active silently stops proposing new clusters
    (crp_prior_scores drops the log-α term).  Samplers remain valid MCMC
    on the *truncated* support, but the truncation is no longer negligible
    — callers should re-pad (see `repad`) and recompile.  Fixed-K states
    are never "saturated" (their support is exactly K).
    """
    if state.fixed:
        return jnp.asarray(False)
    return jnp.all(state.counts > 0)


def repad(state: MixtureState, new_k_max: int) -> MixtureState:
    """Host-side K_max growth: pad every cluster-axis leaf with empty slots.

    The re-pad + recompile tier of the K_max overflow policy (SURVEY.md §7):
    returns an equivalent state with capacity `new_k_max`; downstream jitted
    kernels recompile once for the new static shape.  Pair with
    ``dataclasses.replace(defn, k_max=new_k_max)`` for definition objects.
    """
    validator.validate_positive(new_k_max, "new_k_max")
    k_old = state.k_max
    if new_k_max < k_old:
        raise ValueError(
            f"new_k_max ({new_k_max}) must be >= current k_max ({k_old})"
        )
    if state.fixed:
        raise ValueError("fixed-K states have exactly K components; cannot repad")
    if new_k_max == k_old:
        return state
    grow = new_k_max - k_old

    def pad_leaf(leaf):
        widths = [(0, grow)] + [(0, 0)] * (leaf.ndim - 1)
        return jnp.pad(leaf, widths)

    new_stats = tuple(
        {k: pad_leaf(v) for k, v in stats_f.items()} for stats_f in state.stats
    )
    return dataclasses.replace(
        state,
        counts=pad_leaf(state.counts),
        stats=new_stats,
    )


def score_value(state: MixtureState, data, eid):
    """[K] log p(assign row eid to each slot): CRP prior + likelihoods.

    The reference's entity_state score_value — de-virtualized into one
    vectorized pass over all K slots and all features.
    """
    logp = crp_prior_scores(state)
    for (x, mask), lik, hyper, stats_f in zip(
        data, state.likelihoods(), state.hypers, state.stats
    ):
        s = lik.pred_logpdf(hyper, stats_f, x[eid])
        logp = logp + s * jnp.asarray(mask[eid], s.dtype)
    return logp


def score_assignment(state: MixtureState):
    """EPPF: log p(partition) (group_manager::score_assignment).

    CRP:  K⁺ log α + Σ_k lgamma(n_k) + lgamma(α) − lgamma(α + N)
    Fixed-K: Dirichlet-multinomial over assignment counts.
    """
    counts_f = state.counts.astype(jnp.float32)
    n = jnp.sum(state.counts)
    if state.fixed:
        a = state.cluster_hp["alphas"]
        a0 = jnp.sum(a)
        return (
            jnp.sum(gammaln(a + counts_f) - gammaln(a))
            + gammaln(a0)
            - gammaln(a0 + n.astype(jnp.float32))
        )
    alpha = state.cluster_hp["alpha"].astype(jnp.float32)
    active = state.counts > 0
    kplus = jnp.sum(active)
    return (
        kplus.astype(jnp.float32) * jnp.log(alpha)
        + jnp.sum(jnp.where(active, gammaln(counts_f), 0.0))
        + gammaln(alpha)
        - gammaln(alpha + n.astype(jnp.float32))
    )


def score_likelihood(state: MixtureState, fid: Optional[int] = None):
    """Σ over active groups of each feature's marginal loglik (score_data).

    fid=None sums over all features (the reference iterates fids).
    """
    active = state.counts > 0
    fids = range(len(state.stats)) if fid is None else [fid]
    liks = state.likelihoods()
    total = jnp.asarray(0.0)
    for f in fids:
        ml = liks[f].marginal_loglik(state.hypers[f], state.stats[f])
        total = total + jnp.sum(jnp.where(active, ml, 0.0))
    return total


def score_joint(state: MixtureState):
    """log p(partition, data) — the enumeration oracle's target."""
    return score_assignment(state) + score_likelihood(state)


# ---------------------------------------------------------------------------
# generative surfaces (mixturemodel's sample / sample_post_pred)
# ---------------------------------------------------------------------------
def sample(
    defn: MixtureDefinition,
    key,
    cluster_hp: Optional[Dict[str, Any]] = None,
    feature_hps: Optional[Sequence[Dict[str, Any]]] = None,
):
    """Synthetic data from the model prior (mixturemodel's ``sample``):
    draw a CRP partition, per-cluster parameters from each feature prior,
    then one row per entity.  Returns (data columns, assignment) in the
    same ((values, mask), ...) layout `initialize` consumes.
    """
    hypers = tuple(
        desc.canonical_hyper(
            None if feature_hps is None else feature_hps[f]
        )
        for f, desc in enumerate(defn.models)
    )
    alpha = jnp.asarray((cluster_hp or {}).get("alpha", 1.0))
    kz, kt, kv = jax.random.split(key, 3)
    z = sample_crp_assignment(kz, defn.n, defn.k_max, alpha)

    data = []
    for f, (desc, hyper) in enumerate(zip(defn.models, hypers)):
        lik = desc.likelihood
        empty = lik.init_stats(hyper, (defn.k_max,))
        theta = lik.sample_params(jax.random.fold_in(kt, f), hyper, empty)
        theta_rows = jax.tree_util.tree_map(lambda l: l[z], theta)
        row_keys = jax.random.split(jax.random.fold_in(kv, f), defn.n)
        vals = jax.vmap(lik.sample_value)(row_keys, theta_rows)
        data.append((vals, jnp.ones(defn.n, jnp.float32)))
    return tuple(data), z


def heldout_logp(state: MixtureState, data):
    """[n] log posterior-predictive density of held-out rows.

    The BASELINE north-star quality metric ("predictive log-likelihood
    within MC error"): for each held-out row x*,
        log p(x* | state) = logsumexp_k( log w_k + Σ_f pred_logpdf_{k,f} )
                            − logsumexp_k( log w_k )
    with w_k the CRP/Dirichlet seating weights (`crp_prior_scores`, the
    collapsed mixture weights including the fresh-cluster alpha slot) and
    pred_logpdf each feature's collapsed predictive (Student-t for NIW,
    etc.).  `data` uses the standard ((values, mask), ...) column layout;
    masked cells contribute nothing.  Average over several posterior
    states for an MC-error-quantified estimate.
    """
    from jax.scipy.special import logsumexp as _lse

    logw = crp_prior_scores(state)  # [K]
    norm = _lse(logw)

    def row_lp(cols_row):
        lp = logw
        for (xi, mi), lik, hyper, stats_f in zip(
            cols_row, state.likelihoods(), state.hypers, state.stats
        ):
            s = lik.pred_logpdf(hyper, stats_f, xi)
            lp = lp + s * jnp.asarray(mi, s.dtype)
        return _lse(lp) - norm

    return jax.vmap(lambda *cols: row_lp(cols))(
        *[(x, jnp.asarray(m)) for x, m in data]
    )


def sample_post_pred(state: MixtureState, key, size: int = 1):
    """Draw `size` hypothetical new rows from the posterior predictive
    (mixturemodel's ``state.sample_post_pred``): cluster ~ CRP seating
    weights (a fresh cluster takes the alpha slot and draws from the
    prior), then a value from that cluster's posterior parameter draw.
    Returns (data columns [(values [size, ...], mask [size]), ...],
    cluster ids [size]).
    """
    validator.validate_positive(size, "size")
    kc, kt, kv = jax.random.split(key, 3)
    logw = crp_prior_scores(state)
    z = jax.random.categorical(kc, logw, shape=(size,))

    data = []
    for f, (lik, hyper, stats_f) in enumerate(
        zip(state.likelihoods(), state.hypers, state.stats)
    ):
        theta = lik.sample_params(jax.random.fold_in(kt, f), hyper, stats_f)
        theta_rows = jax.tree_util.tree_map(lambda l: l[z], theta)
        row_keys = jax.random.split(jax.random.fold_in(kv, f), size)
        vals = jax.vmap(lik.sample_value)(row_keys, theta_rows)
        data.append((vals, jnp.ones(size, jnp.float32)))
    return tuple(data), z
