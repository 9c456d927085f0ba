"""Collapsed Gibbs kernels for DP mixture states.

Reference analog: `kernels:microscopes/kernels/gibbs.pyx` — the ecosystem's
inference engine drives the abstract entity_state interface with:
  gibbs.assign(state, rng)              collapsed Gibbs (conjugate models)
  gibbs.assign_resample(state, m, rng)  Neal (2000) algorithm 8, m aux groups
  gibbs.hp(state, specs, rng)           grid Gibbs over feature hypers
  gibbs.assign_fixed(state, rng)        fixed-K variant

Vectorized design (SURVEY.md §3.2): the reference's per-row Python/C++ loop
with O(K·F) virtual calls becomes a single `lax.scan` over rows whose body
is one fully vectorized [K_max]-slot scoring pass (CRP prior weights +
batched posterior-predictive log-pdfs), Gumbel-argmax categorical choice,
and scatter-based suffstat update.  The whole sweep is one compiled XLA
program; a sweep over N rows is O(N) sequential steps of O(K·F) *vector*
work (the sequential dependence is inherent to exact collapsed Gibbs — see
kernels/blocked.py for the parallel uncollapsed path).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Sequence

import jax
import jax.numpy as jnp

from common_tpu import state as state_mod
from common_tpu.likelihoods import base as lik_base
from common_tpu.state import MixtureState, NEG_INF


def _aux_slot_mask(counts, m):
    """Mask of the first m empty slots (Neal-8 auxiliary groups)."""
    empty = counts == 0
    rank = jnp.cumsum(empty.astype(jnp.int32))
    return empty & (rank <= m)


def _row_sweep_step(data, m, key, state: MixtureState, eid):
    """One row of a collapsed-Gibbs sweep (remove → score → sample → add)."""
    key_e = jax.random.fold_in(key, eid)
    st = state_mod.remove_value(state, data, eid)

    liks = st.likelihoods()
    aux = _aux_slot_mask(st.counts, m)

    # non-conjugate models: fresh prior draws on the aux slots (Neal-8)
    new_stats = []
    for f, (lik, hyper, stats_f) in enumerate(zip(liks, st.hypers, st.stats)):
        if lik.conjugate:
            new_stats.append(stats_f)
        else:
            kf = jax.random.fold_in(key_e, 1000 + f)
            new_stats.append(lik.refresh_latents(kf, hyper, stats_f, aux))
    st = dataclasses.replace(st, stats=tuple(new_stats))

    # seat-choice log-weights over all K slots
    if st.fixed:
        logp = state_mod.crp_prior_scores(st)
    else:
        counts_f = st.counts.astype(jnp.float32)
        active = st.counts > 0
        alpha = st.cluster_hp["alpha"].astype(jnp.float32)
        logp = jnp.where(
            active,
            jnp.log(counts_f),
            jnp.where(aux, jnp.log(alpha) - jnp.log(float(m)), NEG_INF),
        )
    for (x, mask), lik, hyper, stats_f in zip(data, liks, st.hypers, st.stats):
        s = lik.pred_logpdf(hyper, stats_f, x[eid])
        logp = logp + s * jnp.asarray(mask[eid], s.dtype)

    g = jax.random.gumbel(jax.random.fold_in(key_e, 0), logp.shape, logp.dtype)
    gid = jnp.argmax(logp + g)
    st = state_mod.add_value(st, data, eid, gid)
    return st, gid


@partial(jax.jit, static_argnames=("m",))
def assign_resample(state: MixtureState, data, key, m: int = 1) -> MixtureState:
    """One full sweep of Neal algorithm 8 with m auxiliary groups.

    With m=1 and conjugate likelihoods this *is* exact collapsed Gibbs
    (the aux slot's zero suffstats give the prior predictive and weight
    α/1), so `assign` delegates here.
    """
    n = state.n
    step = partial(_row_sweep_step, data, m, key)
    state, _ = jax.lax.scan(step, state, jnp.arange(n))
    return state


def assign(state: MixtureState, data, key) -> MixtureState:
    """One collapsed-Gibbs sweep over all rows (kernels' gibbs.assign)."""
    return assign_resample(state, data, key, m=1)


def assign_fixed(state: MixtureState, data, key) -> MixtureState:
    """Fixed-K collapsed Gibbs sweep (gibbs.assign_fixed)."""
    if not state.fixed:
        raise ValueError("assign_fixed requires a fixed-K state")
    return assign_resample(state, data, key, m=1)


# ---------------------------------------------------------------------------
# grid Gibbs over hyperparameters (kernels' gibbs.hp)
# ---------------------------------------------------------------------------
def _stack_grid(grid: Sequence[Dict[str, Any]]):
    """List of hyper dicts → single pytree with leading grid axis [G]."""
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.stack([jnp.asarray(l) for l in leaves]), *grid
    )


def _hp_impl(state: MixtureState, grids, key, fids, priors) -> MixtureState:
    liks = state.likelihoods()
    active = state.counts > 0
    new_hypers = list(state.hypers)
    for i, (fid, prior_fn, grid) in enumerate(zip(fids, priors, grids)):
        lik = liks[fid]

        def score_one(h, lik=lik, prior_fn=prior_fn, fid=fid):
            ml = lik.marginal_loglik(h, state.stats[fid])
            return prior_fn(h) + jnp.sum(jnp.where(active, ml, 0.0))

        logps = jax.vmap(score_one)(grid)
        kf = jax.random.fold_in(key, i)
        g = jax.random.gumbel(kf, logps.shape, logps.dtype)
        pick = jnp.argmax(logps + g)
        new_hypers[fid] = jax.tree_util.tree_map(lambda l: l[pick], grid)
    return dataclasses.replace(state, hypers=tuple(new_hypers))


_HP_JIT_CACHE: Dict[Any, Callable] = {}


def hp(
    state: MixtureState,
    specs: Dict[int, Dict[str, Any]],
    key,
) -> MixtureState:
    """Grid Gibbs over feature hyperparameters.

    specs: {fid: {'prior': callable(hyper_dict)->logp, 'grid': [hyper dicts]}}
    — mirrors the reference's {fid: {'hpdf': scalar_fn, 'hgrid': [...]}}
    spec format (kernels:gibbs.pyx hp kernel): for each feature, score every
    grid point by prior(h) + Σ_active marginal_loglik(h, stats), then draw
    the new hyper from the normalized grid posterior.

    The reference loops set_hp/score_likelihood per grid point; here the
    grid axis is vmapped so all points are scored in one batched pass, and
    the whole multi-feature update runs as ONE jitted program (cached per
    (fids, prior-fn identities); grid *values* are traced arguments, so
    regenerating a grid with the same shape does not recompile).
    """
    fids = tuple(sorted(specs))
    priors = tuple(specs[f]["prior"] for f in fids)
    grids = tuple(_stack_grid(list(specs[f]["grid"])) for f in fids)
    sig = (fids, priors)
    fn = _HP_JIT_CACHE.get(sig)
    if fn is None:
        fn = jax.jit(partial(_hp_impl, fids=fids, priors=priors))
        _HP_JIT_CACHE[sig] = fn
    return fn(state, grids, key)


@jax.jit
def theta(state: MixtureState, key) -> MixtureState:
    """Resample explicit per-cluster latents from their exact conditionals.

    For non-conjugate likelihoods carrying latents inside their suffstats
    (bbnc's p), redraw theta | data for every slot from `sample_params`
    (exact where available).  Conjugate features are untouched.  The
    slice-sampling variant (for latents without a closed conditional) is
    kernels/slice_.py's `theta` — this is the exact-conditional fast path
    and the oracle the slice kernel is validated against.
    """
    new_stats = []
    for f, (lik, hyper, stats_f) in enumerate(
        zip(state.likelihoods(), state.hypers, state.stats)
    ):
        if lik.conjugate or not lik.latent_leaves:
            new_stats.append(stats_f)
            continue
        kf = jax.random.fold_in(key, f)
        drawn = lik.sample_params(kf, hyper, stats_f)
        merged = {
            k: (drawn[k] if k in lik.latent_leaves else stats_f[k])
            for k in stats_f
        }
        new_stats.append(merged)
    return dataclasses.replace(state, stats=tuple(new_stats))


@jax.jit
def cluster_hp_escobar_west(
    state: MixtureState, key, a: float = 1.0, b: float = 1.0
) -> MixtureState:
    """Exact auxiliary-variable Gibbs for the CRP concentration α
    (Escobar & West 1995 §6) under an α ~ Gamma(a, b) prior:

      η ~ Beta(α+1, n);  π = (a+K⁺−1)/(a+K⁺−1 + n(b − log η));
      α ~ π·Gamma(a+K⁺, b−log η) + (1−π)·Gamma(a+K⁺−1, b−log η).

    One fused draw per call — the classic alternative to grid Gibbs
    (kernels' gibbs.hp over cluster hypers) with no grid to tune.
    """
    alpha = state.cluster_hp["alpha"].astype(jnp.float32)
    n = jnp.sum(state.counts).astype(jnp.float32)
    kplus = jnp.sum(state.counts > 0).astype(jnp.float32)
    ke, kp, kg = jax.random.split(key, 3)
    eta = jax.random.beta(ke, alpha + 1.0, n)
    log_eta = jnp.log(jnp.clip(eta, 1e-30))
    odds = (a + kplus - 1.0) / (n * (b - log_eta))
    pick_high = jax.random.uniform(kp) < odds / (1.0 + odds)
    shape = jnp.where(pick_high, a + kplus, a + kplus - 1.0)
    new_alpha = jax.random.gamma(kg, shape) / (b - log_eta)
    return dataclasses.replace(
        state, cluster_hp={"alpha": new_alpha.astype(alpha.dtype)}
    )


def _cluster_hp_impl(state: MixtureState, grid, key, prior_fn) -> MixtureState:
    def score_one(alpha):
        st = dataclasses.replace(state, cluster_hp={"alpha": alpha})
        return prior_fn(alpha) + state_mod.score_assignment(st)

    logps = jax.vmap(score_one)(grid)
    g = jax.random.gumbel(key, logps.shape, logps.dtype)
    pick = jnp.argmax(logps + g)
    return dataclasses.replace(state, cluster_hp={"alpha": grid[pick]})


def cluster_hp(
    state: MixtureState,
    prior_fn: Callable,
    grid,
    key,
) -> MixtureState:
    """Grid Gibbs over the CRP concentration α (cluster-hp kernel).

    grid: [G] array of α values; prior_fn(α)->logp.  Scores each grid point
    by prior + EPPF of the current partition.  One jitted program, cached
    per prior-fn identity (grid values are traced).
    """
    grid = jnp.asarray(grid)
    sig = ("cluster_hp", prior_fn)
    fn = _HP_JIT_CACHE.get(sig)
    if fn is None:
        fn = jax.jit(partial(_cluster_hp_impl, prior_fn=prior_fn))
        _HP_JIT_CACHE[sig] = fn
    return fn(state, grid, key)
