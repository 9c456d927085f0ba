"""Infinite Relational Model state — clustering over multiple domains.

Reference analog: the `irm` sibling repo (`irm:microscopes/irm/model.pyx`,
`irm:src/irm/state.cpp` [MED]), which `common` exists to serve: per-domain
CRP `group_manager`s + per-relation suffstat tables indexed by cluster
tuples, driven through the same `entity_based_state_object` kernel
interface.  Data arrives through `common`'s sparse_ndarray dataview
(`common:include/microscopes/common/sparse_ndarray/dataview.hpp`).

Vectorized design: every domain gets the padded-K treatment of the mixture
state (assignments [N_d], counts [K_d], alpha), and every relation keeps
its suffstats as *dense cluster-block tensors* with shape [K_a, K_b, ...]
(one slot per cluster tuple; empty blocks hold zero stats, which score 0
under every conjugate marginal, so no masking is needed).  Suffstat
(re)builds are one segment-sum over the flat COO cell axis per leaf —
shardable along cells.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammaln

from common_tpu import validator
from common_tpu.likelihoods import base as lik_base
from common_tpu.models import model_descriptor


# ---------------------------------------------------------------------------
# definition
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RelationDefinition:
    """One relation: which domain each axis ranges over, and its likelihood."""

    domains: Tuple[int, ...]
    model: model_descriptor

    def __post_init__(self):
        validator.validate_nonempty(self.domains, "relation domains")
        object.__setattr__(self, "domains", tuple(int(d) for d in self.domains))


@dataclass(frozen=True)
class IRMDefinition:
    """Domains (entity counts) + typed relations over them.

    Mirrors irm's ``model_definition([n1, n2], [((0, 1), bb), ...])``.
    """

    domain_sizes: Tuple[int, ...]
    relations: Tuple[RelationDefinition, ...]
    k_maxes: Tuple[int, ...]

    def __post_init__(self):
        for n in self.domain_sizes:
            validator.validate_positive(n, "domain size")
        for k in self.k_maxes:
            validator.validate_positive(k, "k_max")
        validator.validate_nonempty(self.relations, "relations")
        for r in self.relations:
            for d in r.domains:
                if not 0 <= d < len(self.domain_sizes):
                    raise ValueError(f"relation references unknown domain {d}")

    @property
    def ndomains(self) -> int:
        return len(self.domain_sizes)


def model_definition(
    domain_sizes: Sequence[int],
    relations: Sequence,
    k_max: int | Sequence[int] = 8,
) -> IRMDefinition:
    """relations: [(domain-tuple, model_descriptor), ...] (irm's format)."""
    rels = tuple(
        r if isinstance(r, RelationDefinition) else RelationDefinition(*r)
        for r in relations
    )
    if isinstance(k_max, int):
        k_maxes = tuple(k_max for _ in domain_sizes)
    else:
        k_maxes = tuple(int(k) for k in k_max)
        validator.validate_len(k_maxes, len(domain_sizes), "k_max list")
    return IRMDefinition(tuple(int(n) for n in domain_sizes), rels, k_maxes)


class RelView(NamedTuple):
    """Jit-crossable COO view of one relation (pytree of arrays)."""

    indices: jax.Array  # [M, arity] int32
    values: jax.Array   # [M]
    mask: jax.Array     # [M] float 0/1


def as_views(views: Sequence) -> Tuple[RelView, ...]:
    """Coerce sparse_ndarray_dataview (or anything with .indices/.values/
    .mask) into RelView pytrees so kernels can take them as jit args."""
    out = []
    for v in views:
        if isinstance(v, RelView):
            out.append(v)
        else:
            out.append(RelView(
                jnp.asarray(v.indices, jnp.int32),
                jnp.asarray(v.values),
                jnp.asarray(v.mask, jnp.float32),
            ))
    return tuple(out)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IRMState:
    """Pytree: per-domain clustering + per-relation cluster-block suffstats."""

    assignments: Tuple[jax.Array, ...]   # per domain [N_d] int32
    counts: Tuple[jax.Array, ...]        # per domain [K_d] int32
    cluster_hps: Tuple[Dict[str, Any], ...]
    suffstats: Tuple[Dict[str, Any], ...]  # per relation, leaves [K_a, K_b,…]
    hypers: Tuple[Dict[str, Any], ...]
    lik_names: Tuple[str, ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )
    rel_domains: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True), default=()
    )

    @property
    def ndomains(self) -> int:
        return len(self.assignments)

    def k_max(self, d: int) -> int:
        return self.counts[d].shape[-1]

    def likelihoods(self):
        return tuple(lik_base.get(n) for n in self.lik_names)

    def ngroups(self, d: int):
        return jnp.sum(self.counts[d] > 0)


def _cell_bins(defn_domains, assignments, indices, k_maxes):
    """Flat cluster-block id per COO cell (row-major over the K grid)."""
    bins = jnp.zeros(indices.shape[0], jnp.int32)
    for axis, dom in enumerate(defn_domains):
        z = assignments[dom][indices[:, axis]]
        bins = bins * k_maxes[dom] + z
    return bins


def compute_relation_stats(lik, hyper, rel_domains, assignments, view,
                           k_maxes):
    """Suffstat block tensor [K_a, K_b, ...] from scratch (segment-sum)."""
    shape = tuple(k_maxes[d] for d in rel_domains)
    total = int(np.prod(shape))
    bins = _cell_bins(rel_domains, assignments, view.indices, k_maxes)
    txs = jax.vmap(lambda v, m: lik.tx(hyper, v, m))(view.values, view.mask)

    def seg(t):
        flat = jax.ops.segment_sum(t, bins, num_segments=total)
        return flat.reshape(*shape, *t.shape[1:])

    return jax.tree_util.tree_map(seg, txs)


def initialize(
    defn: IRMDefinition,
    views: Sequence,
    key,
    cluster_hps: Optional[Sequence[Dict[str, Any]]] = None,
    relation_hps: Optional[Sequence[Dict[str, Any]]] = None,
    domain_assignments: Optional[Sequence] = None,
) -> IRMState:
    """Build an initialized IRM state (irm's state.initialize analog).

    views: one sparse_ndarray_dataview (or anything with .indices/.values/
    .mask) per relation.  domain_assignments: optional explicit [N_d] int
    arrays; otherwise each domain draws from its CRP prior.
    """
    from common_tpu import state as mix_state

    validator.validate_len(views, len(defn.relations), "relation views")
    hypers = tuple(
        r.model.canonical_hyper(
            None if relation_hps is None else relation_hps[i]
        )
        for i, r in enumerate(defn.relations)
    )
    chps = []
    for d in range(defn.ndomains):
        hp = (cluster_hps[d] if cluster_hps is not None else {}) or {}
        chps.append({"alpha": jnp.asarray(hp.get("alpha", 1.0))})

    assignments = []
    for d in range(defn.ndomains):
        if domain_assignments is not None and domain_assignments[d] is not None:
            a = jnp.asarray(domain_assignments[d], jnp.int32)
        else:
            a = mix_state.sample_crp_assignment(
                jax.random.fold_in(key, d), defn.domain_sizes[d],
                defn.k_maxes[d], chps[d]["alpha"],
            )
        assignments.append(a)
    assignments = tuple(assignments)

    counts = tuple(
        jax.ops.segment_sum(
            jnp.ones_like(assignments[d]), assignments[d],
            num_segments=defn.k_maxes[d],
        ).astype(jnp.int32)
        for d in range(defn.ndomains)
    )

    suffstats = tuple(
        compute_relation_stats(
            r.model.likelihood, hypers[i], r.domains, assignments,
            views[i], defn.k_maxes,
        )
        for i, r in enumerate(defn.relations)
    )

    return IRMState(
        assignments=assignments,
        counts=counts,
        cluster_hps=tuple(chps),
        suffstats=suffstats,
        hypers=hypers,
        lik_names=tuple(r.model.name for r in defn.relations),
        rel_domains=tuple(r.domains for r in defn.relations),
    )


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------
def _crp_eppf(counts, alpha):
    counts_f = counts.astype(jnp.float32)
    n = jnp.sum(counts)
    active = counts > 0
    kplus = jnp.sum(active)
    return (
        kplus.astype(jnp.float32) * jnp.log(alpha)
        + jnp.sum(jnp.where(active, gammaln(counts_f), 0.0))
        + gammaln(alpha)
        - gammaln(alpha + n.astype(jnp.float32))
    )


def score_assignment(state: IRMState):
    """Σ over domains of the CRP EPPF (group_manager::score_assignment)."""
    total = jnp.zeros(())
    for d in range(state.ndomains):
        total = total + _crp_eppf(
            state.counts[d], state.cluster_hps[d]["alpha"].astype(jnp.float32)
        )
    return total


def score_likelihood(state: IRMState, rid: Optional[int] = None):
    """Σ over relations of Σ over cluster blocks of the marginal loglik.

    Empty blocks carry zero suffstats and score exactly 0 under every
    conjugate marginal, so the sum runs over the whole dense block tensor.
    """
    rids = range(len(state.suffstats)) if rid is None else [rid]
    liks = state.likelihoods()
    total = jnp.zeros(())
    for r in rids:
        ml = liks[r].marginal_loglik(state.hypers[r], state.suffstats[r])
        total = total + jnp.sum(ml)
    return total


def score_joint(state: IRMState):
    """log p(partitions, relations) — the enumeration oracle's target."""
    return score_assignment(state) + score_likelihood(state)


# ---------------------------------------------------------------------------
# prediction (link prediction — the IRM posterior-predictive surface)
# ---------------------------------------------------------------------------
@partial(jax.jit, static_argnames=("rid",))
def pred_logpdf(state: IRMState, rid, indices, values):
    """Collapsed posterior-predictive log p(x_cell | state) for query cells.

    indices [M, arity] entity tuples of relation `rid`, values [M]
    candidate cell values; each cell is scored against its cluster
    block's current suffstats (the reference irm's score_value analog,
    used for link prediction / missing-cell imputation).
    """
    rid = int(rid)
    lik = state.likelihoods()[rid]
    doms = state.rel_domains[rid]
    k_maxes = tuple(state.counts[d].shape[-1] for d in range(state.ndomains))
    shape = tuple(k_maxes[d] for d in doms)
    total = int(np.prod(shape))
    indices = jnp.asarray(indices, jnp.int32)
    bins = _cell_bins(doms, state.assignments, indices, k_maxes)
    stats_cells = jax.tree_util.tree_map(
        lambda s: s.reshape(total, *s.shape[len(shape):])[bins],
        state.suffstats[rid],
    )
    return jax.vmap(
        lambda st_c, v: lik.pred_logpdf(state.hypers[rid], st_c, v)
    )(stats_cells, jnp.asarray(values))


def predict_missing(state: IRMState, rid, indices, candidates):
    """Posterior-predictive distribution over `candidates` for each cell.

    Returns [M, C] normalized probabilities — argmax gives the imputation,
    and for binary relations candidates=(0, 1) gives link probabilities.
    """
    cand = jnp.asarray(candidates)
    logps = jnp.stack(
        [pred_logpdf(state, rid, indices,
                     jnp.full(len(jnp.asarray(indices)), c, cand.dtype))
         for c in np.asarray(cand)],
        axis=-1,
    )
    return jax.nn.softmax(logps, axis=-1)
