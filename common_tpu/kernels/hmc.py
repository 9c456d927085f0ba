"""Hamiltonian Monte Carlo + NUTS kernels (non-conjugate hypers/latents).

No reference analog: the reference ecosystem's non-conjugate kernels are
MH/slice only (`kernels:microscopes/kernels/slice.pyx`, mh.pyx [MED]).
HMC/NUTS is a north-star requirement (BASELINE.json: "NUTS/HMC ... for
non-conjugate hypers, with ... step-size adaptation") and the natural
Device path: the leapfrog integrator is pure dense linear algebra, the whole
trajectory is a `lax.while_loop`/`scan` of fused XLA steps, and gradients
come from `jax.grad` through the framework's own scoring functions
(`marginal_loglik`, EPPF, `posterior_logpdf_unnorm`) — no hand-written
derivatives anywhere.

Contents:
  - bijectors (identity/positive/lower_bounded/interval) with log-det
    corrections so all sampling happens in unconstrained space;
  - `leapfrog`, `hmc_step` (multinomial-in-trajectory HMC);
  - `nuts_step` — iterative multinomial NUTS with biased progressive
    doubling, checkpoint-buffer U-turn detection (the recursion-free
    formulation of Phan & Pradhan's iterative NUTS; max_depth static),
    divergence guard at ΔH > 1000;
  - dual-averaging step-size adaptation (Hoffman & Gelman 2014 §3.2) and
    Welford diagonal mass estimation → `warmup` / `sample` drivers;
  - mixture-state kernels: `hp` (NUTS over feature hyperparameters given
    suffstats), `cluster_hp` (NUTS over the CRP concentration α via the
    EPPF), `theta` (NUTS over explicit non-conjugate cluster latents,
    e.g. bbnc's p) — all pluggable into runner kernel configs.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from common_tpu import state as state_mod
from common_tpu.state import MixtureState

_MAX_DELTA_ENERGY = 1000.0  # divergence threshold (Stan's default)


# ---------------------------------------------------------------------------
# bijectors: unconstrained u -> constrained x, with log|dx/du|
# ---------------------------------------------------------------------------
IDENTITY = ("identity",)
POSITIVE = ("positive",)


def lower_bounded(lb):
    return ("lower_bounded", float(lb))


def interval(lo, hi):
    return ("interval", float(lo), float(hi))


def bij_forward(spec, u):
    """(x, sum log|dx/du|) for one leaf."""
    kind = spec[0]
    if kind == "identity":
        return u, jnp.zeros((), u.dtype)
    if kind == "positive":
        return jnp.exp(u), jnp.sum(u)
    if kind == "lower_bounded":
        return spec[1] + jnp.exp(u), jnp.sum(u)
    if kind == "interval":
        lo, hi = spec[1], spec[2]
        s = jax.nn.sigmoid(u)
        x = lo + (hi - lo) * s
        ld = jnp.sum(jnp.log(hi - lo) + jax.nn.log_sigmoid(u) + jax.nn.log_sigmoid(-u))
        return x, ld
    raise ValueError(f"unknown bijector {spec!r}")


def bij_inverse(spec, x):
    kind = spec[0]
    x = jnp.asarray(x, jnp.float32)
    if kind == "identity":
        return x
    if kind == "positive":
        return jnp.log(x)
    if kind == "lower_bounded":
        return jnp.log(x - spec[1])
    if kind == "interval":
        lo, hi = spec[1], spec[2]
        s = jnp.clip((x - lo) / (hi - lo), 1e-6, 1.0 - 1e-6)
        return jnp.log(s) - jnp.log1p(-s)
    raise ValueError(f"unknown bijector {spec!r}")


# ---------------------------------------------------------------------------
# leapfrog + energies (flat-vector domain; diagonal inverse mass m_inv)
# ---------------------------------------------------------------------------
def _kinetic(p, m_inv):
    return 0.5 * jnp.sum(p * p * m_inv)


def leapfrog(grad_fn, q, p, eps, m_inv, n_steps):
    """n_steps leapfrog steps; returns (q, p). eps may be negative."""

    def body(carry, _):
        q, p = carry
        p = p + 0.5 * eps * grad_fn(q)
        q = q + eps * (m_inv * p)
        p = p + 0.5 * eps * grad_fn(q)
        return (q, p), None

    (q, p), _ = jax.lax.scan(body, (q, p), None, length=n_steps)
    return q, p


def _one_leapfrog(grad_fn, q, p, eps, m_inv):
    p = p + 0.5 * eps * grad_fn(q)
    q = q + eps * (m_inv * p)
    p = p + 0.5 * eps * grad_fn(q)
    return q, p


# ---------------------------------------------------------------------------
# fixed-length HMC step (Metropolis accept)
# ---------------------------------------------------------------------------
class HMCInfo(NamedTuple):
    accept_prob: jax.Array
    diverging: jax.Array
    energy: jax.Array
    num_leapfrog: jax.Array


def hmc_step(logprob_fn, q, key, step_size, num_leapfrog, m_inv=None):
    """One HMC transition on flat vector q. Returns (q', logp', info)."""
    if m_inv is None:
        m_inv = jnp.ones_like(q)
    kp, ka = jax.random.split(key)
    grad_fn = jax.grad(logprob_fn)
    logp0 = logprob_fn(q)
    p0 = jax.random.normal(kp, q.shape, q.dtype) / jnp.sqrt(m_inv)
    h0 = -logp0 + _kinetic(p0, m_inv)
    q1, p1 = leapfrog(grad_fn, q, p0, step_size, m_inv, num_leapfrog)
    logp1 = logprob_fn(q1)
    h1 = -logp1 + _kinetic(p1, m_inv)
    delta = h0 - h1
    delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
    accept_prob = jnp.minimum(1.0, jnp.exp(delta))
    accept = jax.random.uniform(ka) < accept_prob
    q_new = jnp.where(accept, q1, q)
    logp_new = jnp.where(accept, logp1, logp0)
    info = HMCInfo(accept_prob, -delta > _MAX_DELTA_ENERGY, h1,
                   jnp.asarray(num_leapfrog))
    return q_new, logp_new, info


# ---------------------------------------------------------------------------
# iterative NUTS
# ---------------------------------------------------------------------------
class _Tree(NamedTuple):
    q_left: jax.Array
    p_left: jax.Array
    q_right: jax.Array
    p_right: jax.Array
    q_prop: jax.Array
    logp_prop: jax.Array
    log_weight: jax.Array      # log Σ_leaves exp(H0 − H)
    p_sum: jax.Array           # Σ_leaves p
    turning: jax.Array
    diverging: jax.Array
    sum_accept: jax.Array
    num_leaves: jax.Array


def _is_turning(m_inv, p_left, p_right, p_sum):
    v_sum_l = jnp.sum(m_inv * p_sum * p_left)
    v_sum_r = jnp.sum(m_inv * p_sum * p_right)
    return (v_sum_l <= 0.0) | (v_sum_r <= 0.0)


def _leaf_to_ckpt_idxs(n):
    """Checkpoint index range to test a new odd leaf n against.

    idx_max = popcount(n >> 1); idx_min = idx_max − (trailing ones of n) + 1.
    (Recursion-free U-turn bookkeeping per the iterative-NUTS construction.)
    """

    def popcount_body(c):
        x, acc = c
        return x >> 1, acc + (x & 1)

    _, idx_max = jax.lax.while_loop(
        lambda c: c[0] > 0, popcount_body, (n >> 1, jnp.int32(0))
    )

    def trailing_body(c):
        x, acc = c
        return x >> 1, acc + 1

    _, ntrail = jax.lax.while_loop(
        lambda c: (c[0] & 1) != 0, trailing_body, (n, jnp.int32(0))
    )
    return idx_max - ntrail + 1, idx_max


def _iterative_turning(m_inv, p_ckpts, psum_ckpts, p, p_sum, idx_min, idx_max):
    def body(c):
        i, _ = c
        sub_sum = p_sum - psum_ckpts[i] + p_ckpts[i]
        return i - 1, _is_turning(m_inv, p_ckpts[i], p, sub_sum)

    _, turning = jax.lax.while_loop(
        lambda c: (c[0] >= idx_min) & ~c[1], body, (idx_max, jnp.asarray(False))
    )
    return turning


def _build_subtree(grad_fn, logprob_fn, q0, p0, eps, m_inv, h0, depth_target,
                   max_depth, key):
    """Build a subtree of up to 2^depth_target leaves by single leapfrog
    steps from (q0, p0), with checkpoint-buffer U-turn detection.

    Returns a _Tree whose build-order start/end map onto left/right by the
    caller's direction.  eps carries the direction sign.
    """
    dim = q0.shape[0]
    p_ckpts = jnp.zeros((max_depth + 1, dim), q0.dtype)
    psum_ckpts = jnp.zeros((max_depth + 1, dim), q0.dtype)

    leaf0 = _Tree(
        q_left=q0, p_left=p0, q_right=q0, p_right=p0,
        q_prop=q0, logp_prop=-jnp.inf,
        log_weight=-jnp.inf, p_sum=jnp.zeros_like(p0),
        turning=jnp.asarray(False), diverging=jnp.asarray(False),
        sum_accept=jnp.zeros(()), num_leaves=jnp.int32(0),
    )
    max_leaves = jnp.int32(2) ** depth_target

    def cond(c):
        tree, _, _, _, _, _ = c
        return (
            (tree.num_leaves < max_leaves)
            & ~tree.turning
            & ~tree.diverging
        )

    def body(c):
        tree, q, p, p_ckpts, psum_ckpts, key = c
        key, kp = jax.random.split(key)
        q, p = _one_leapfrog(grad_fn, q, p, eps, m_inv)
        logp = logprob_fn(q)
        h = -logp + _kinetic(p, m_inv)
        h = jnp.where(jnp.isnan(h), jnp.inf, h)
        log_w = h0 - h
        diverging = (h - h0) > _MAX_DELTA_ENERGY
        accept_p = jnp.minimum(1.0, jnp.exp(log_w))

        n = tree.num_leaves  # index of this new leaf within the subtree
        new_log_weight = jnp.logaddexp(tree.log_weight, log_w)
        # multinomial within-subtree proposal swap
        take_new = jnp.log(jax.random.uniform(kp)) < (log_w - new_log_weight)
        q_prop = jnp.where(take_new, q, tree.q_prop)
        logp_prop = jnp.where(take_new, logp, tree.logp_prop)

        p_sum = tree.p_sum + p
        idx_min, idx_max = _leaf_to_ckpt_idxs(n)
        is_even = (n % 2) == 0
        p_ckpts = jnp.where(
            is_even, p_ckpts.at[idx_max].set(p), p_ckpts
        )
        psum_ckpts = jnp.where(
            is_even, psum_ckpts.at[idx_max].set(p_sum), psum_ckpts
        )
        turning = jnp.where(
            is_even,
            jnp.asarray(False),
            _iterative_turning(
                m_inv, p_ckpts, psum_ckpts, p, p_sum, idx_min, idx_max
            ),
        )
        new_tree = _Tree(
            q_left=tree.q_left, p_left=tree.p_left, q_right=q, p_right=p,
            q_prop=q_prop, logp_prop=logp_prop,
            log_weight=new_log_weight, p_sum=p_sum,
            turning=turning, diverging=diverging,
            sum_accept=tree.sum_accept + accept_p,
            num_leaves=n + 1,
        )
        return new_tree, q, p, p_ckpts, psum_ckpts, key

    tree, _, _, _, _, _ = jax.lax.while_loop(
        cond, body, (leaf0, q0, p0, p_ckpts, psum_ckpts, key)
    )
    return tree


class NUTSInfo(NamedTuple):
    accept_prob: jax.Array     # mean leaf acceptance (adaptation statistic)
    diverging: jax.Array
    num_leaves: jax.Array
    depth: jax.Array


def nuts_step(logprob_fn, q, key, step_size, m_inv=None, max_depth: int = 8):
    """One NUTS transition on flat vector q. Returns (q', logp', info)."""
    if m_inv is None:
        m_inv = jnp.ones_like(q)
    grad_fn = jax.grad(logprob_fn)
    kp, kt = jax.random.split(key)
    p0 = jax.random.normal(kp, q.shape, q.dtype) / jnp.sqrt(m_inv)
    logp0 = logprob_fn(q)
    h0 = -logp0 + _kinetic(p0, m_inv)

    init = _Tree(
        q_left=q, p_left=p0, q_right=q, p_right=p0,
        q_prop=q, logp_prop=logp0,
        log_weight=jnp.zeros(()), p_sum=p0,
        turning=jnp.asarray(False), diverging=jnp.asarray(False),
        sum_accept=jnp.zeros(()), num_leaves=jnp.int32(1),
    )

    def cond(c):
        tree, depth, _ = c
        return (depth < max_depth) & ~tree.turning & ~tree.diverging

    def body(c):
        tree, depth, key = c
        key, kd, kb, ks = jax.random.split(key, 4)
        going_right = jax.random.bernoulli(kd)
        eps = jnp.where(going_right, step_size, -step_size)
        q_edge = jnp.where(going_right, tree.q_right, tree.q_left)
        p_edge = jnp.where(going_right, tree.p_right, tree.p_left)
        sub = _build_subtree(
            grad_fn, logprob_fn, q_edge, p_edge, eps, m_inv, h0,
            depth, max_depth, kb,
        )
        bad = sub.turning | sub.diverging
        # biased progressive: P(take subtree proposal) = min(1, w_sub/w_tree)
        take = (
            jnp.log(jax.random.uniform(ks))
            < (sub.log_weight - tree.log_weight)
        ) & ~bad
        q_prop = jnp.where(take, sub.q_prop, tree.q_prop)
        logp_prop = jnp.where(take, sub.logp_prop, tree.logp_prop)

        # merged edges (subtree build-end is the new outer edge)
        q_left = jnp.where(going_right, tree.q_left, sub.q_right)
        p_left = jnp.where(going_right, tree.p_left, sub.p_right)
        q_right = jnp.where(going_right, sub.q_right, tree.q_right)
        p_right = jnp.where(going_right, sub.p_right, tree.p_right)
        p_sum = tree.p_sum + sub.p_sum
        turning_top = _is_turning(m_inv, p_left, p_right, p_sum)

        merged = _Tree(
            q_left=q_left, p_left=p_left, q_right=q_right, p_right=p_right,
            q_prop=q_prop, logp_prop=logp_prop,
            log_weight=jnp.logaddexp(tree.log_weight, sub.log_weight),
            p_sum=p_sum,
            turning=bad | turning_top,
            diverging=tree.diverging | sub.diverging,
            sum_accept=tree.sum_accept + sub.sum_accept,
            num_leaves=tree.num_leaves + sub.num_leaves,
        )
        return merged, depth + 1, key

    tree, depth, _ = jax.lax.while_loop(cond, body, (init, jnp.int32(0), kt))
    n_new = jnp.maximum(tree.num_leaves - 1, 1).astype(jnp.float32)
    info = NUTSInfo(
        accept_prob=tree.sum_accept / n_new,
        diverging=tree.diverging,
        num_leaves=tree.num_leaves,
        depth=depth,
    )
    return tree.q_prop, tree.logp_prop, info


# ---------------------------------------------------------------------------
# dual-averaging step-size adaptation (HG14 §3.2) + Welford mass
# ---------------------------------------------------------------------------
class DAState(NamedTuple):
    log_eps: jax.Array
    log_eps_avg: jax.Array
    h_avg: jax.Array
    mu: jax.Array
    t: jax.Array


def da_init(step_size):
    eps = jnp.asarray(step_size, jnp.float32)
    return DAState(
        log_eps=jnp.log(eps),
        log_eps_avg=jnp.log(eps),
        h_avg=jnp.zeros(()),
        mu=jnp.log(10.0 * eps),
        t=jnp.zeros(()),
    )


def da_update(s: DAState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DAState:
    t = s.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_avg = (1.0 - eta_h) * s.h_avg + eta_h * (target - accept_prob)
    log_eps = s.mu - jnp.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * s.log_eps_avg
    return DAState(log_eps, log_eps_avg, h_avg, s.mu, t)


class WelfordState(NamedTuple):
    mean: jax.Array
    m2: jax.Array
    count: jax.Array


def welford_init(dim, dtype=jnp.float32):
    z = jnp.zeros(dim, dtype)
    return WelfordState(z, z, jnp.zeros((), dtype))


def welford_update(s: WelfordState, x) -> WelfordState:
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count
    m2 = s.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_var(s: WelfordState, regularize=True):
    var = s.m2 / jnp.maximum(s.count - 1.0, 1.0)
    if regularize:  # Stan's shrink-to-unit regularization
        w = s.count / (s.count + 5.0)
        var = w * var + (1.0 - w) * 1e-3
    return var


# ---------------------------------------------------------------------------
# drivers: warmup + sample over arbitrary pytree positions
# ---------------------------------------------------------------------------
def warmup(logprob_flat, q0, key, num_steps, init_step_size=0.1,
           max_depth=8, target_accept=0.8, adapt_mass=True):
    """Dual-averaging (+ optional Welford diag mass) NUTS warmup.

    Returns (q, step_size, m_inv).  Single adaptation window: mass is
    estimated from all warmup draws and applied at the end (sufficient for
    the moderate-dimension hyper/latent targets this kernel serves).
    """
    dim = q0.shape[0]

    def body(carry, k):
        q, da, wf = carry
        eps = jnp.exp(da.log_eps)
        q, _, info = nuts_step(logprob_flat, q, k, eps, None, max_depth)
        da = da_update(da, info.accept_prob, target=target_accept)
        wf = welford_update(wf, q)
        return (q, da, wf), None

    (q, da, wf), _ = jax.lax.scan(
        body, (q0, da_init(init_step_size), welford_init(dim)),
        jax.random.split(key, num_steps),
    )
    m_inv = welford_var(wf) if adapt_mass else jnp.ones(dim)
    eps = jnp.exp(da.log_eps_avg)

    # short re-adaptation of eps under the new metric
    def body2(carry, k):
        q, da = carry
        q, _, info = nuts_step(
            logprob_flat, q, k, jnp.exp(da.log_eps), m_inv, max_depth
        )
        da = da_update(da, info.accept_prob, target=target_accept)
        return (q, da), None

    n2 = max(num_steps // 4, 10)
    (q, da), _ = jax.lax.scan(
        body2, (q, da_init(eps)),
        jax.random.split(jax.random.fold_in(key, 1), n2),
    )
    return q, jnp.exp(da.log_eps_avg), m_inv


def sample(logprob_fn, init_position, key, num_samples, num_warmup=500,
           kernel="nuts", step_size=0.1, num_leapfrog=32, max_depth=8,
           target_accept=0.8):
    """Warmup + sample. init_position: any pytree; returns stacked pytree
    of draws plus an info dict (works under jit; used directly in tests)."""
    q0, unravel = ravel_pytree(init_position)
    q0 = jnp.asarray(q0, jnp.float32)

    def logprob_flat(q):
        return logprob_fn(unravel(q))

    kw, ks = jax.random.split(jax.random.fold_in(key, 7))
    if num_warmup > 0:
        q0, eps, m_inv = warmup(
            logprob_flat, q0, kw, num_warmup, step_size, max_depth,
            target_accept,
        )
    else:
        eps, m_inv = jnp.asarray(step_size), jnp.ones_like(q0)

    def body(q, k):
        if kernel == "nuts":
            q, logp, info = nuts_step(logprob_flat, q, k, eps, m_inv, max_depth)
            extras = {"accept_prob": info.accept_prob,
                      "diverging": info.diverging,
                      "num_leaves": info.num_leaves}
        else:
            q, logp, info = hmc_step(
                logprob_flat, q, k, eps, num_leapfrog, m_inv
            )
            extras = {"accept_prob": info.accept_prob,
                      "diverging": info.diverging}
        return q, {"position": q, "logp": logp, **extras}

    _, out = jax.lax.scan(body, q0, jax.random.split(ks, num_samples))
    samples = jax.vmap(unravel)(out.pop("position"))
    out["step_size"] = eps
    return samples, out


# ---------------------------------------------------------------------------
# mixture-state kernels (runner-pluggable)
# ---------------------------------------------------------------------------
def _make_hyper_target(state: MixtureState, fids, priors, transforms):
    """Unconstrained joint target over the selected features' hypers."""
    liks = state.likelihoods()
    active = state.counts > 0

    def logprob(upos: Dict[int, Dict[str, Any]]):
        total = jnp.zeros(())
        for fid in fids:
            hyper = dict(state.hypers[fid])
            for name, spec in transforms[fid].items():
                x, ld = bij_forward(spec, upos[fid][name])
                hyper[name] = x
                total = total + ld
            ml = liks[fid].marginal_loglik(hyper, state.stats[fid])
            total = total + priors[fid](hyper)
            total = total + jnp.sum(jnp.where(active, ml, 0.0))
        return total

    return logprob


def _default_transforms(state, fids, transforms):
    """POSITIVE for every sampled param unless the user says otherwise."""
    out = {}
    for fid in fids:
        spec = dict((transforms or {}).get(fid, {}))
        if not spec:  # sample every scalar hyper, positively constrained
            spec = {
                k: POSITIVE
                for k, v in state.hypers[fid].items()
                if jnp.ndim(v) == 0
            }
        out[fid] = spec
    return out


@partial(
    jax.jit,
    static_argnames=("fids", "tdef", "priors_tuple", "num_steps", "max_depth"),
)
def _hp_jit(state, key, fids, tdef, priors_tuple, step_size, num_steps,
            max_depth):
    transforms = {f: dict(s) for f, s in tdef}
    priors = {f: p for f, p in zip(fids, priors_tuple)}
    target = _make_hyper_target(state, fids, priors, transforms)

    upos = {
        fid: {
            name: bij_inverse(spec, state.hypers[fid][name])
            for name, spec in transforms[fid].items()
        }
        for fid in fids
    }
    q0, unravel = ravel_pytree(upos)
    q0 = jnp.asarray(q0, jnp.float32)

    def logprob_flat(q):
        return target(unravel(q))

    def body(q, k):
        q, _, _ = nuts_step(logprob_flat, q, k, step_size, None, max_depth)
        return q, None

    q, _ = jax.lax.scan(body, q0, jax.random.split(key, num_steps))
    u_final = unravel(q)

    new_hypers = list(state.hypers)
    for fid in fids:
        hyper = dict(state.hypers[fid])
        for name, spec in transforms[fid].items():
            x, _ = bij_forward(spec, u_final[fid][name])
            hyper[name] = jnp.asarray(x, jnp.asarray(state.hypers[fid][name]).dtype)
        new_hypers[fid] = hyper
    return dataclasses.replace(state, hypers=tuple(new_hypers))


def hp(state: MixtureState, data, key, priors: Dict[int, Callable],
       transforms: Optional[Dict[int, Dict[str, tuple]]] = None,
       step_size: float = 0.05, num_steps: int = 4,
       max_depth: int = 6) -> MixtureState:
    """NUTS over feature hyperparameters (config-3 kernel).

    priors: {fid: callable(hyper_dict) -> log prior}.  transforms: {fid:
    {param: bijector spec}} — defaults to POSITIVE on every scalar hyper of
    each listed feature.  Target = prior + Σ_active marginal_loglik, with
    gradients via jax.grad through the likelihood's marginal (valid for
    conjugate models whose suffstats don't depend on hypers).
    """
    del data
    fids = tuple(sorted(priors))
    transforms = _default_transforms(state, fids, transforms)
    tdef = tuple((f, tuple(sorted(transforms[f].items()))) for f in fids)
    priors_tuple = tuple(priors[f] for f in fids)
    return _hp_jit(state, key, fids, tdef, priors_tuple,
                   jnp.asarray(step_size), num_steps, max_depth)


@partial(jax.jit, static_argnames=("prior_fn", "num_steps", "max_depth"))
def cluster_hp(state: MixtureState, key, prior_fn: Callable,
               step_size=0.1, num_steps: int = 4,
               max_depth: int = 6) -> MixtureState:
    """NUTS over the CRP concentration α (log-space) via the EPPF."""

    def logprob(u):
        alpha = jnp.exp(u[0])
        st = dataclasses.replace(state, cluster_hp={"alpha": alpha})
        return prior_fn(alpha) + state_mod.score_assignment(st) + u[0]

    q0 = jnp.log(state.cluster_hp["alpha"].astype(jnp.float32))[None]

    def body(q, k):
        q, _, _ = nuts_step(logprob, q, k, jnp.asarray(step_size), None,
                            max_depth)
        return q, None

    q, _ = jax.lax.scan(body, q0, jax.random.split(key, num_steps))
    return dataclasses.replace(
        state, cluster_hp={"alpha": jnp.exp(q[0])}
    )


@partial(jax.jit, static_argnames=("num_steps", "max_depth"))
def theta(state: MixtureState, key, step_size=0.1, num_steps: int = 4,
          max_depth: int = 6) -> MixtureState:
    """NUTS over explicit non-conjugate cluster latents (bbnc's p).

    Latents of all K slots are sampled jointly (they are conditionally
    independent given assignments, so a joint NUTS is exact); bounded
    latents ride an interval bijector from the model's `latent_bounds`.
    """
    new_stats = list(state.stats)
    for f, (lik, hyper, stats_f) in enumerate(
        zip(state.likelihoods(), state.hypers, state.stats)
    ):
        if lik.conjugate or not lik.latent_leaves:
            continue
        bounds = getattr(lik, "latent_bounds", {})

        specs = {
            name: (interval(*bounds[name]) if name in bounds else IDENTITY)
            for name in lik.latent_leaves
        }

        def logprob(u, lik=lik, hyper=hyper, stats_f=stats_f, specs=specs):
            total = jnp.zeros(())
            vals = {}
            for name, spec in specs.items():
                x, ld = bij_forward(spec, u[name])
                vals[name] = x
                total = total + ld
            # bbnc-style unnormalized conditional over every slot
            lp = lik.posterior_logpdf_unnorm(
                hyper, stats_f, *[vals[n] for n in lik.latent_leaves]
            )
            return total + jnp.sum(lp)

        u0 = {
            name: bij_inverse(specs[name], stats_f[name])
            for name in lik.latent_leaves
        }
        q0, unravel = ravel_pytree(u0)
        q0 = jnp.asarray(q0, jnp.float32)

        def logprob_flat(q, logprob=logprob, unravel=unravel):
            return logprob(unravel(q))

        kf = jax.random.fold_in(key, f)

        def body(q, k, logprob_flat=logprob_flat):
            q, _, _ = nuts_step(logprob_flat, q, k, jnp.asarray(step_size),
                                None, max_depth)
            return q, None

        q, _ = jax.lax.scan(body, q0, jax.random.split(kf, num_steps))
        u_final = unravel(q)
        merged = dict(stats_f)
        for name in lik.latent_leaves:
            x, _ = bij_forward(specs[name], u_final[name])
            merged[name] = jnp.asarray(x, stats_f[name].dtype)
        new_stats[f] = merged
    return dataclasses.replace(state, stats=tuple(new_stats))
