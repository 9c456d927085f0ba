"""Slice sampling kernels (Neal 2003: stepping-out + shrinkage).

Reference analog: `kernels:microscopes/kernels/slice.pyx` —
  slice.theta(state, rng, tparams)  resample non-conjugate per-cluster
                                    latents (bbnc's p);
  slice.hp(state, rng, hparams)     resample feature/cluster
                                    hyperparameters under continuous priors.

Vectorized design: the univariate slice update is a pair of bounded
`lax.while_loop`s (step-out, then shrink) — compiler-friendly control flow
with a hard iteration cap — and is `vmap`ed across all K cluster slots at
once for theta updates.  All targets are the framework's own pure scoring
functions (posterior_logpdf_unnorm / marginal_loglik / EPPF).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp

from common_tpu import state as state_mod
from common_tpu.state import MixtureState

_MAX_STEPOUT = 16
_MAX_SHRINK = 64


def slice_sample(key, x0, logf: Callable, w=1.0, lower=-jnp.inf, upper=jnp.inf):
    """One univariate slice-sampling update of target density exp(logf).

    Stepping-out with width w (capped at _MAX_STEPOUT expansions per side,
    clipped to [lower, upper]) then shrinkage (capped at _MAX_SHRINK; on
    cap-exhaustion returns x0, which preserves detailed balance as a
    no-op).  All control flow is lax.while_loop — jit/vmap safe.
    """
    x0 = jnp.asarray(x0, jnp.float32)
    ky, ku, kl, ks = jax.random.split(key, 4)
    y = logf(x0) - jax.random.exponential(ky, dtype=x0.dtype)

    u = jax.random.uniform(ku, dtype=x0.dtype)
    L0 = jnp.maximum(x0 - u * w, lower)
    R0 = jnp.minimum(L0 + w, upper)

    def out_cond(st):
        edge, steps, grow = st
        return (steps < _MAX_STEPOUT) & grow

    def mk_out_body(direction):
        def body(st):
            edge, steps, _ = st
            new_edge = jnp.clip(edge + direction * w, lower, upper)
            grow = (logf(new_edge) > y) & (new_edge != edge)
            return (new_edge, steps + 1, grow)

        return body

    L, _, _ = jax.lax.while_loop(
        out_cond, mk_out_body(-1.0), (L0, 0, logf(L0) > y)
    )
    R, _, _ = jax.lax.while_loop(
        out_cond, mk_out_body(+1.0), (R0, 0, logf(R0) > y)
    )

    def shr_cond(st):
        _, _, _, done, it, _ = st
        return (~done) & (it < _MAX_SHRINK)

    def shr_body(st):
        lo, hi, x, done, it, k = st
        k, sub = jax.random.split(k)
        xp = jax.random.uniform(sub, dtype=x0.dtype, minval=lo, maxval=hi)
        ok = logf(xp) >= y
        lo = jnp.where(ok, lo, jnp.where(xp < x0, xp, lo))
        hi = jnp.where(ok, hi, jnp.where(xp >= x0, xp, hi))
        x = jnp.where(ok, xp, x)
        return (lo, hi, x, ok, it + 1, k)

    _, _, x1, done, _, _ = jax.lax.while_loop(
        shr_cond, shr_body, (L, R, x0, False, 0, ks)
    )
    return jnp.where(done, x1, x0)


@partial(jax.jit, static_argnames=("w",))
def theta(state: MixtureState, key, w: float = 0.5) -> MixtureState:
    """Slice-resample explicit per-cluster latents (slice.theta).

    For each non-conjugate feature, each latent leaf is updated slot-wise
    against the feature's `posterior_logpdf_unnorm` conditional; empty
    slots get fresh prior draws via refresh_latents.  Jitted end-to-end
    (w is a static compile-time width).
    """
    new_stats = []
    for f, (lik, hyper, stats_f) in enumerate(
        zip(state.likelihoods(), state.hypers, state.stats)
    ):
        if lik.conjugate or not lik.latent_leaves:
            new_stats.append(stats_f)
            continue
        kf = jax.random.fold_in(key, f)
        stats_new = dict(stats_f)
        for li, leaf in enumerate(lik.latent_leaves):
            kleaf = jax.random.fold_in(kf, li)
            vals = stats_f[leaf]
            K = vals.shape[-1]
            lo, hi = getattr(lik, "latent_bounds", {}).get(
                leaf, (-jnp.inf, jnp.inf)
            )

            def one_slot(k_slot, slot_idx, x0):
                def logf(x):
                    stats_k = jax.tree_util.tree_map(
                        lambda l: l[slot_idx], stats_f
                    )
                    return lik.posterior_logpdf_unnorm(
                        hyper, stats_k, x
                    )

                return slice_sample(k_slot, x0, logf, w=w, lower=lo, upper=hi)

            keys = jax.random.split(kleaf, K)
            stats_new[leaf] = jax.vmap(one_slot)(
                keys, jnp.arange(K), vals
            )
        # empty slots: fresh prior draws (their conditional is the prior,
        # but a prior draw mixes instantly vs slice steps)
        stats_new = lik.refresh_latents(
            jax.random.fold_in(kf, 999), hyper, stats_new, state.counts == 0
        )
        new_stats.append(stats_new)
    return dataclasses.replace(state, stats=tuple(new_stats))


def _freeze_spec(obj):
    """Hashable signature of a nested spec dict (fns by identity)."""
    if isinstance(obj, dict):
        return tuple((k, _freeze_spec(v)) for k, v in sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze_spec(v) for v in obj)
    if callable(obj):
        return id(obj)
    return obj


_SLICE_HP_CACHE: Dict[Any, Callable] = {}


def hp(
    state: MixtureState,
    data,
    key,
    specs: Dict[int, Dict[str, Dict[str, Any]]],
    cluster: Dict[str, Any] | None = None,
) -> MixtureState:
    """Slice-resample hyperparameters (slice.hp).

    specs: {fid: {param: {'prior': logp fn, 'w': width, 'bounds': (lo,hi)}}}
    — scalar hyperparameters (the reference's slice.hp surface) or [d]
    vector hypers (bbv/dd/dm alphas), slice-updated coordinate-wise as a
    sequential Gibbs scan (correct for coupled marginals like dd/dm's).
    cluster: optional {'prior': fn, 'w': float, 'bounds': (lo,hi)} for the
    CRP concentration α.  The whole multi-parameter update runs as ONE
    jitted program, cached per spec structure (fn identities + widths).

    Pairing note: with the *collapsed* assignment kernels any bounds
    work; when pairing with the uncollapsed/blocked sweep, keep bounds
    moderate (e.g. Beta hypers >= 0.5) — hyper draws fitted to mixed
    early-sweep stats otherwise make empty-slot prior draws so extreme
    that the truncated sampler collapses to one cluster and cannot seed
    new ones.
    """
    del data  # scoring uses suffstats only
    sig = (_freeze_spec(specs), _freeze_spec(cluster))
    fn = _SLICE_HP_CACHE.get(sig)
    if fn is None:
        fn = jax.jit(partial(_hp_impl, specs=specs, cluster=cluster))
        _SLICE_HP_CACHE[sig] = fn
    return fn(state, key)


def _hp_impl(
    state: MixtureState,
    key,
    specs: Dict[int, Dict[str, Dict[str, Any]]],
    cluster: Dict[str, Any] | None = None,
) -> MixtureState:
    active = state.counts > 0
    liks = state.likelihoods()
    new_hypers = list(state.hypers)
    for i, (fid, params) in enumerate(sorted(specs.items())):
        lik = liks[fid]
        hyper = dict(new_hypers[fid])
        for j, (pname, spec) in enumerate(sorted(params.items())):
            kp = jax.random.fold_in(key, 1000 * (i + 1) + j)
            prior_fn = spec["prior"]
            lo, hi = spec.get("bounds", (-jnp.inf, jnp.inf))
            x0 = jnp.asarray(hyper[pname])

            if x0.ndim == 0:
                def logf(v):
                    h = {**hyper, pname: v}
                    ml = lik.marginal_loglik(h, state.stats[fid])
                    return prior_fn(v) + jnp.sum(jnp.where(active, ml, 0.0))

                hyper[pname] = slice_sample(
                    kp, x0, logf, w=spec.get("w", 1.0), lower=lo, upper=hi
                )
            else:
                # Vector hyper (bbv/dd/dm alphas): coordinate-wise slice
                # as a SEQUENTIAL Gibbs scan — each coordinate's slice
                # conditions on the already-updated values of the others.
                # (A simultaneous vmap update would only be valid for
                # coordinate-separable marginals like bbv's; dd/dm's
                # lnΓ(Σα) couples coordinates, so sequential is the
                # correct general path and costs one fused scan.)
                def coord_step(vec, inp):
                    c, kc = inp

                    def logf_c(v):
                        h = {**hyper, pname: vec.at[c].set(v)}
                        ml = lik.marginal_loglik(h, state.stats[fid])
                        return prior_fn(v) + jnp.sum(
                            jnp.where(active, ml, 0.0)
                        )

                    new_v = slice_sample(
                        kc, vec[c], logf_c,
                        w=spec.get("w", 1.0), lower=lo, upper=hi,
                    )
                    return vec.at[c].set(new_v), None

                coords = jnp.arange(x0.shape[0])
                hyper[pname], _ = jax.lax.scan(
                    coord_step, x0,
                    (coords, jax.random.split(kp, x0.shape[0])),
                )
        new_hypers[fid] = hyper
    state = dataclasses.replace(state, hypers=tuple(new_hypers))

    if cluster is not None and not state.fixed:
        kc = jax.random.fold_in(key, 777)
        prior_fn = cluster["prior"]
        lo, hi = cluster.get("bounds", (1e-6, jnp.inf))

        def logf_alpha(a):
            s = dataclasses.replace(state, cluster_hp={"alpha": a})
            return prior_fn(a) + state_mod.score_assignment(s)

        new_alpha = slice_sample(
            kc,
            state.cluster_hp["alpha"],
            logf_alpha,
            w=cluster.get("w", 1.0),
            lower=lo,
            upper=hi,
        )
        state = dataclasses.replace(state, cluster_hp={"alpha": new_alpha})
    return state
