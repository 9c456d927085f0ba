"""IRM inference kernels: exact collapsed Gibbs + blocked (uncollapsed).

Reference analog: the `irm` sibling repo reuses the same kernels-repo
Gibbs drivers (`kernels:microscopes/kernels/gibbs.pyx`) through the
entity_based_state_object interface, with irm's state supplying
score_value over cluster-block suffstats.

Vectorized design:
  - `assign(state, views, key, domain=d)` — exact collapsed Gibbs over one
    domain's entities: a `lax.scan` over entities whose body scores ALL
    K_d candidate clusters at once by materializing the candidate's
    suffstat block-tensor delta (scatter of the entity's cells) and
    differencing Σ marginal_loglik — bins the entity doesn't touch cancel
    *exactly* (bitwise-identical floats), so the difference is the exact
    collapsed predictive including multi-cell-per-block interactions.
    O(N·K·Πk) marginal evals per sweep: the correctness oracle.
  - `sweep(state, views, key)` — blocked Gibbs perf path: draw cluster-
    block parameters θ and per-domain stick weights, then reassign every
    entity of a domain *in parallel* via per-cell logpdf tables +
    segment-sums (one [M, K] block per relation axis).  Domains touched
    by a self-relation (same domain on ≥2 axes) fall back to a
    sequential-given-θ scan, which stays a valid Gibbs update where the
    parallel one would not be.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from common_tpu.kernels import blocked as blocked_mod
from common_tpu.relational import state as irm_state
from common_tpu.relational.state import IRMState

NEG_INF = -jnp.inf


def _k_maxes(state: IRMState):
    return tuple(state.counts[d].shape[-1] for d in range(state.ndomains))


def _flat_stats(stats, shape):
    total = int(np.prod(shape))
    return jax.tree_util.tree_map(
        lambda s: s.reshape(total, *s.shape[len(shape):]), stats
    )


def _unflat_stats(stats_flat, shape):
    return jax.tree_util.tree_map(
        lambda s: s.reshape(*shape, *s.shape[1:]), stats_flat
    )


def _involved(rel_domains, indices, domain, eid):
    """[M] 1.0 where a cell touches entity eid of `domain` on any axis."""
    inv = jnp.zeros(indices.shape[0], bool)
    for axis, dom in enumerate(rel_domains):
        if dom == domain:
            inv = inv | (indices[:, axis] == eid)
    return inv


def _bins_with(rel_domains, assignments, indices, k_maxes, domain, eid, gid):
    """Flat block id per cell with entity eid of `domain` reassigned to gid."""
    bins = jnp.zeros(indices.shape[0], jnp.int32)
    for axis, dom in enumerate(rel_domains):
        z = assignments[dom][indices[:, axis]]
        if dom == domain:
            z = jnp.where(indices[:, axis] == eid, gid, z)
        bins = bins * k_maxes[dom] + z
    return bins


# ---------------------------------------------------------------------------
# exact collapsed Gibbs over one domain
# ---------------------------------------------------------------------------
def _entity_step(views, domain, key, carry, eid):
    state, rel_txs = carry
    k_maxes = _k_maxes(state)
    K = k_maxes[domain]
    liks = state.likelihoods()

    # ---- remove: scatter-subtract this entity's cells from its blocks ----
    old = state.assignments[domain][eid]
    removed = []
    for r, (view, txs) in enumerate(zip(views, rel_txs)):
        shape = tuple(k_maxes[d] for d in state.rel_domains[r])
        inv = _involved(state.rel_domains[r], view.indices, domain, eid)
        w = inv.astype(jnp.float32) * view.mask
        bins = _bins_with(
            state.rel_domains[r], state.assignments, view.indices,
            k_maxes, domain, eid, old,
        )
        flat = _flat_stats(state.suffstats[r], shape)
        flat = jax.tree_util.tree_map(
            lambda s, t: s.at[bins].add(
                -t * w.reshape(w.shape + (1,) * (t.ndim - 1))
            ),
            flat, txs,
        )
        removed.append((flat, shape, txs, w, view))

    counts = state.counts[domain].at[old].add(-1)

    # ---- score all K candidates: Δ Σ marginal_loglik per relation -------
    base_ml = jnp.zeros(())
    for r, (flat, shape, txs, w, view) in enumerate(removed):
        base_ml = base_ml + jnp.sum(
            liks[r].marginal_loglik(
                state.hypers[r], _unflat_stats(flat, shape)
            )
        )

    def cand_score(gid):
        total = jnp.zeros(())
        for r, (flat, shape, txs, w, view) in enumerate(removed):
            bins_k = _bins_with(
                state.rel_domains[r], state.assignments, view.indices,
                k_maxes, domain, eid, gid,
            )
            flat_k = jax.tree_util.tree_map(
                lambda s, t: s.at[bins_k].add(
                    t * w.reshape(w.shape + (1,) * (t.ndim - 1))
                ),
                flat, txs,
            )
            total = total + jnp.sum(
                liks[r].marginal_loglik(
                    state.hypers[r], _unflat_stats(flat_k, shape)
                )
            )
        return total

    delta_ml = jax.vmap(cand_score)(jnp.arange(K)) - base_ml

    # CRP prior over candidate slots (single aux slot = exact collapsed)
    counts_f = counts.astype(jnp.float32)
    active = counts > 0
    alpha = state.cluster_hps[domain]["alpha"].astype(jnp.float32)
    can_open = jnp.any(~active)
    first_empty = jnp.argmax(~active)
    crp = jnp.where(
        active,
        jnp.log(counts_f),
        jnp.where(
            (jnp.arange(K) == first_empty) & can_open, jnp.log(alpha), NEG_INF
        ),
    )

    logp = crp + delta_ml
    g = jax.random.gumbel(jax.random.fold_in(key, eid), logp.shape, logp.dtype)
    gid = jnp.argmax(logp + g).astype(jnp.int32)

    # ---- add back at gid -------------------------------------------------
    new_suffstats = list(state.suffstats)
    for r, (flat, shape, txs, w, view) in enumerate(removed):
        bins_g = _bins_with(
            state.rel_domains[r], state.assignments, view.indices,
            k_maxes, domain, eid, gid,
        )
        flat_g = jax.tree_util.tree_map(
            lambda s, t: s.at[bins_g].add(
                t * w.reshape(w.shape + (1,) * (t.ndim - 1))
            ),
            flat, txs,
        )
        new_suffstats[r] = _unflat_stats(flat_g, shape)

    new_assign = list(state.assignments)
    new_assign[domain] = state.assignments[domain].at[eid].set(gid)
    new_counts = list(state.counts)
    new_counts[domain] = counts.at[gid].add(1)

    state = dataclasses.replace(
        state,
        assignments=tuple(new_assign),
        counts=tuple(new_counts),
        suffstats=tuple(new_suffstats),
    )
    return (state, rel_txs), gid


def assign(state: IRMState, views, key, domain: int = 0) -> IRMState:
    """One exact collapsed-Gibbs sweep over `domain`'s entities."""
    return _assign_jit(state, irm_state.as_views(views), key, domain)


@partial(jax.jit, static_argnames=("domain",))
def _assign_jit(state: IRMState, views, key, domain: int) -> IRMState:
    liks = state.likelihoods()
    rel_txs = tuple(
        jax.vmap(lambda v, m, lik=lik, h=h: lik.tx(h, v, m))(
            view.values, view.mask
        )
        for lik, h, view in zip(liks, state.hypers, views)
    )
    n = state.assignments[domain].shape[0]
    step = partial(_entity_step, views, domain, key)
    (state, _), _ = jax.lax.scan(step, (state, rel_txs), jnp.arange(n))
    return state


def assign_all(state: IRMState, views, key) -> IRMState:
    """Collapsed sweep over every domain in turn."""
    for d in range(state.ndomains):
        state = assign(state, views, jax.random.fold_in(key, d), domain=d)
    return state


# ---------------------------------------------------------------------------
# blocked (uncollapsed) sweep
# ---------------------------------------------------------------------------
def _sample_block_params(state: IRMState, key):
    """θ for every cluster block of every relation (posterior draws)."""
    thetas = []
    for r, (lik, hyper, stats) in enumerate(
        zip(state.likelihoods(), state.hypers, state.suffstats)
    ):
        thetas.append(lik.sample_params(jax.random.fold_in(key, r), hyper, stats))
    return tuple(thetas)


def _theta_at_cells(theta, rel_domains, assignments, indices, free_axis):
    """Gather θ leaves to [M, K_free, *event]: every block axis fixed at
    its cells' current cluster, except `free_axis`, which stays free."""

    def gather_generic(leaf):
        n_block = len(rel_domains)
        m = indices.shape[0]
        # build flat index over fixed axes, keep free axis
        out = jnp.moveaxis(leaf, free_axis, n_block - 1)  # free axis last
        fixed_doms = [d for a, d in enumerate(rel_domains) if a != free_axis]
        fixed_axes = [a for a in range(n_block) if a != free_axis]
        flat_fixed = jnp.zeros(m, jnp.int32)
        for a, d in zip(fixed_axes, fixed_doms):
            z = assignments[d][indices[:, a]]
            flat_fixed = flat_fixed * leaf.shape[a] + z
        fixed_shape = tuple(leaf.shape[a] for a in fixed_axes)
        total_fixed = int(np.prod(fixed_shape)) if fixed_shape else 1
        rest = out.shape[n_block - 1:]
        out = out.reshape(total_fixed, *rest)
        return out[flat_fixed]  # [M, K_free, *event]

    return jax.tree_util.tree_map(gather_generic, theta)


def _domain_loglik_table(state, views, thetas, domain):
    """[N_d, K_d] Σ over relations/axes of per-cell logpdf contributions."""
    n_d = state.assignments[domain].shape[0]
    K = state.counts[domain].shape[-1]
    liks = state.likelihoods()
    table = jnp.zeros((n_d, K))
    for r, view in enumerate(views):
        doms = state.rel_domains[r]
        for axis, dom in enumerate(doms):
            if dom != domain:
                continue
            th_cells = _theta_at_cells(
                thetas[r], doms, state.assignments, view.indices, axis
            )  # leaves [M, K, *event]
            vals = view.values
            lp = liks[r].logpdf(th_cells, vals[:, None])  # [M, K]
            lp = lp * view.mask[:, None]
            table = table + jax.ops.segment_sum(
                lp, view.indices[:, axis], num_segments=n_d
            )
    return table


def _self_relational(state: IRMState, domain: int) -> bool:
    return any(
        sum(1 for d in doms if d == domain) >= 2
        for doms in state.rel_domains
    )


def sweep(state: IRMState, views, key) -> IRMState:
    """One blocked sweep: θ | z, then z_d | θ, z_−d for each domain.

    Domains free of self-relations update all entities in parallel;
    self-relational domains run a sequential-given-θ scan (parallel
    updates would ignore the z_i–z_j coupling through θ[z_i, z_j]).
    """
    return _sweep_jit(state, irm_state.as_views(views), key,
                      tuple(_self_relational(state, d)
                            for d in range(state.ndomains)))


@partial(jax.jit, static_argnames=("self_rel",))
def _sweep_jit(state: IRMState, views, key, self_rel: Tuple[bool, ...]):
    thetas = _sample_block_params(state, jax.random.fold_in(key, 0))
    k_maxes = _k_maxes(state)

    for d in range(state.ndomains):
        kd = jax.random.fold_in(key, 100 + d)
        logw = blocked_mod.stick_break_log_weights(
            jax.random.fold_in(kd, 0), state.counts[d],
            state.cluster_hps[d]["alpha"].astype(jnp.float32),
        )
        if not self_rel[d]:
            table = _domain_loglik_table(state, views, thetas, d)
            logp = logw[None, :] + table
            g = jax.random.gumbel(
                jax.random.fold_in(kd, 1), logp.shape, logp.dtype
            )
            z_new = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)
        else:
            z_new = _sequential_given_theta(state, views, thetas, d, logw, kd)

        new_assign = list(state.assignments)
        new_assign[d] = z_new
        new_counts = list(state.counts)
        new_counts[d] = jax.ops.segment_sum(
            jnp.ones_like(z_new), z_new, num_segments=k_maxes[d]
        ).astype(jnp.int32)
        state = dataclasses.replace(
            state, assignments=tuple(new_assign), counts=tuple(new_counts)
        )

    # rebuild suffstats from the new assignments (segment-sum per relation)
    new_stats = tuple(
        irm_state.compute_relation_stats(
            lik, state.hypers[r], state.rel_domains[r], state.assignments,
            views[r], k_maxes,
        )
        for r, lik in enumerate(state.likelihoods())
    )
    return dataclasses.replace(state, suffstats=new_stats)


# ---------------------------------------------------------------------------
# domain concentration (alpha) hyper kernels
# ---------------------------------------------------------------------------
def _escobar_west_draw(key, alpha, n, kplus, a, b):
    """One exact Gibbs draw of a CRP concentration (Escobar & West 1995 §6)
    given n customers at kplus tables under alpha ~ Gamma(a, b)."""
    ke, kp, kg = jax.random.split(key, 3)
    eta = jax.random.beta(ke, alpha + 1.0, jnp.maximum(n, 1.0))
    log_eta = jnp.log(jnp.clip(eta, 1e-30))
    odds = (a + kplus - 1.0) / (jnp.maximum(n, 1.0) * (b - log_eta))
    pick_high = jax.random.uniform(kp) < odds / (1.0 + odds)
    shape = jnp.where(pick_high, a + kplus, a + kplus - 1.0)
    return jax.random.gamma(kg, shape) / (b - log_eta)


@jax.jit
def domain_alpha_escobar_west(
    state: IRMState, key, a: float = 1.0, b: float = 1.0
) -> IRMState:
    """Resample every domain's CRP concentration alpha | partition.

    The per-domain analog of the mixture `ew_cluster_hp` kernel; each
    domain's partition gives an independent Escobar–West draw.
    """
    new_chps = []
    for d in range(state.ndomains):
        alpha = state.cluster_hps[d]["alpha"].astype(jnp.float32)
        n = jnp.sum(state.counts[d]).astype(jnp.float32)
        kplus = jnp.sum(state.counts[d] > 0).astype(jnp.float32)
        new_alpha = _escobar_west_draw(
            jax.random.fold_in(key, d), alpha, n, kplus,
            jnp.float32(a), jnp.float32(b),
        )
        hp = dict(state.cluster_hps[d])
        hp["alpha"] = new_alpha.astype(state.cluster_hps[d]["alpha"].dtype)
        new_chps.append(hp)
    return dataclasses.replace(state, cluster_hps=tuple(new_chps))


def domain_alpha_grid(state: IRMState, prior_fn, grid, key) -> IRMState:
    """Grid Gibbs over each domain's alpha: prior(α) + that domain's EPPF.

    Mirrors the mixture `grid_cluster_hp` kernel; grid is a [G] array of
    alpha values shared by all domains (each domain draws independently
    from its own grid posterior).
    """
    grid = jnp.asarray(grid)
    new_chps = []
    for d in range(state.ndomains):
        def score_one(alpha, d=d):
            return prior_fn(alpha) + irm_state._crp_eppf(
                state.counts[d], alpha.astype(jnp.float32)
            )

        logps = jax.vmap(score_one)(grid)
        g = jax.random.gumbel(jax.random.fold_in(key, d), logps.shape,
                              logps.dtype)
        hp = dict(state.cluster_hps[d])
        hp["alpha"] = grid[jnp.argmax(logps + g)]
        new_chps.append(hp)
    return dataclasses.replace(state, cluster_hps=tuple(new_chps))


# ---------------------------------------------------------------------------
# multi-device: cell-sharded blocked sweep
# ---------------------------------------------------------------------------
def shard_cells(mesh, views):
    """Pad each relation's COO cell axis to a multiple of the mesh's last
    ('data') axis size and place it sharded; padding cells carry mask 0 and
    index 0 so every segment-sum ignores them."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[-1]
    nsh = mesh.shape[axis]
    sharded = NamedSharding(mesh, P(axis))
    out = []
    for v in irm_state.as_views(views):
        m = v.indices.shape[0]
        pad = (-m) % nsh
        idx = jnp.pad(v.indices, ((0, pad), (0, 0)))
        vals = jnp.pad(v.values, [(0, pad)] + [(0, 0)] * (v.values.ndim - 1))
        mask = jnp.pad(v.mask, (0, pad))
        out.append(irm_state.RelView(
            jax.device_put(idx, sharded),
            jax.device_put(vals, sharded),
            jax.device_put(mask, sharded),
        ))
    return tuple(out)


def make_sharded_sweep(mesh, state: IRMState, views):
    """Jitted multi-chip blocked sweep with relation cells sharded over the
    mesh's last axis: per-shard loglik tables and suffstat segment-sums are
    `psum`'d (ICI collective); θ draws and assignment updates replicate
    (identical keys per shard).  Fulfils relational/state.py's "shardable
    along cells" design note.  Self-relational domains need the sequential-
    given-θ scan over *all* cells and are not supported sharded.
    """
    from jax.sharding import PartitionSpec as P

    if any(_self_relational(state, d) for d in range(state.ndomains)):
        raise ValueError(
            "cell-sharded sweep supports only relations without repeated "
            "domains (self-relations need the sequential-given-theta scan); "
            "use kernels.sweep on a single device for those"
        )
    axis = mesh.axis_names[-1]
    state_spec = jax.tree_util.tree_map(lambda _: P(), state)
    views_spec = tuple(
        irm_state.RelView(P(axis), P(axis), P(axis)) for _ in views
    )
    k_maxes = _k_maxes(state)
    ndomains = state.ndomains

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(state_spec, views_spec, P()),
        out_specs=state_spec,
        check_vma=False,
    )
    def sweep(state, views_blk, key):
        # same key on every shard -> identical replicated θ draws
        thetas = _sample_block_params(state, jax.random.fold_in(key, 0))
        for d in range(ndomains):
            kd = jax.random.fold_in(key, 100 + d)
            logw = blocked_mod.stick_break_log_weights(
                jax.random.fold_in(kd, 0), state.counts[d],
                state.cluster_hps[d]["alpha"].astype(jnp.float32),
            )
            table = jax.lax.psum(
                _domain_loglik_table(state, views_blk, thetas, d), axis
            )
            logp = logw[None, :] + table
            g = jax.random.gumbel(
                jax.random.fold_in(kd, 1), logp.shape, logp.dtype
            )
            z_new = jnp.argmax(logp + g, axis=-1).astype(jnp.int32)
            new_assign = list(state.assignments)
            new_assign[d] = z_new
            new_counts = list(state.counts)
            new_counts[d] = jax.ops.segment_sum(
                jnp.ones_like(z_new), z_new, num_segments=k_maxes[d]
            ).astype(jnp.int32)
            state = dataclasses.replace(
                state, assignments=tuple(new_assign),
                counts=tuple(new_counts),
            )

        new_stats = tuple(
            jax.tree_util.tree_map(
                lambda l: jax.lax.psum(l, axis),
                irm_state.compute_relation_stats(
                    lik, state.hypers[r], state.rel_domains[r],
                    state.assignments, views_blk[r], k_maxes,
                ),
            )
            for r, lik in enumerate(state.likelihoods())
        )
        return dataclasses.replace(state, suffstats=new_stats)

    return sweep


def _sequential_given_theta(state, views, thetas, domain, logw, key):
    """Valid Gibbs over a self-relational domain: scan entities, scoring
    each against θ with the *current* (in-scan) assignments of its peers.

    Each involved cell is counted exactly once, with the candidate cluster
    substituted on EVERY axis the entity occupies — so diagonal cells
    (e, e) correctly score against θ[k, k].
    """
    n_d = state.assignments[domain].shape[0]
    k_maxes = _k_maxes(state)
    K = k_maxes[domain]
    liks = state.likelihoods()

    def step(z_d, eid):
        logp = logw
        assignments = list(state.assignments)
        assignments[domain] = z_d
        assignments = tuple(assignments)
        for r, view in enumerate(views):
            doms = state.rel_domains[r]
            if domain not in doms:
                continue
            shape = tuple(k_maxes[d] for d in doms)
            total = int(np.prod(shape))
            inv = _involved(doms, view.indices, domain, eid)
            w = inv.astype(jnp.float32) * view.mask
            bins_k = jax.vmap(
                lambda g: _bins_with(
                    doms, assignments, view.indices, k_maxes, domain, eid, g
                ),
                out_axes=1,
            )(jnp.arange(K))  # [M, K]
            th_cells = jax.tree_util.tree_map(
                lambda leaf: leaf.reshape(total, *leaf.shape[len(shape):])[
                    bins_k
                ],
                thetas[r],
            )  # leaves [M, K, *event]
            lp = liks[r].logpdf(th_cells, view.values[:, None])
            logp = logp + jnp.sum(lp * w[:, None], axis=0)
        g = jax.random.gumbel(jax.random.fold_in(key, eid), logp.shape)
        gid = jnp.argmax(logp + g).astype(jnp.int32)
        return z_d.at[eid].set(gid), gid

    z_final, _ = jax.lax.scan(
        step, state.assignments[domain], jnp.arange(n_d)
    )
    return z_final
