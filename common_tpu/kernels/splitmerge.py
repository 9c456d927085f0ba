"""Jain–Neal split-merge MH moves for conjugate DP mixtures.

No direct reference analog: the reference ecosystem's kernels repo ships
only single-site samplers (`kernels:microscopes/kernels/gibbs.pyx`,
slice.pyx); split-merge (Jain & Neal 2004, "A Split-Merge Markov Chain
Monte Carlo Procedure for the Dirichlet Process Mixture Model") is the
standard DPMM *mixing* multiplier this rebuild adds for the ESS/s north
star: single-site sweeps move mass between clusters one row at a time,
while one accepted split/merge relocates an entire cluster.

Vectorized design — all static shapes, one compiled program per move:

* The anchor pair (i, j) picks either a SPLIT (same cluster) or a MERGE
  (different clusters); both branches run under one `lax.cond`.
* Jain–Neal's restricted Gibbs launch scans are BLOCKED here: every
  member row is rescored against the two candidate components' suffstats
  *from the previous scan* in one vectorized [N, 2] pass (the [2, D, D]
  Cholesky hoists out of the row vmap automatically), instead of a
  sequential per-row scan.  The proposal density is the product of the
  FINAL blocked scan's per-row conditionals — exactly computable, so the
  MH correction is exact; blocking changes only proposal *quality*
  (lower acceptance than sequential scans at equal t_scans), never the
  stationary distribution.
* Acceptance works at partition level: Δscore_joint (EPPF + marginal
  likelihoods — both label-invariant) + log q_reverse − log q_forward,
  with the merge direction deterministic (q = 1).  Slot bookkeeping
  (split opens the first empty slot, merge zero-clears the emptied
  slot — preserving the exact-zero empty-slot invariant) is pure
  representation.

Only conjugate likelihoods (additive suffstats, collapsed predictives)
are supported; fixed-K states have no split-merge notion (the Dirichlet
prior has no trans-dimensional moves) and are rejected.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from common_tpu import state as state_mod
from common_tpu.likelihoods import base as lik_base
from common_tpu.state import MixtureState


def _check_support(state: MixtureState):
    if state.fixed:
        raise ValueError("split-merge requires a CRP (non-fixed) state")
    for lik in state.likelihoods():
        if getattr(lik, "latent_leaves", None) or not lik.conjugate:
            raise ValueError(
                f"split-merge requires conjugate likelihoods with additive "
                f"suffstats; got {lik.name}"
            )


def _member_stats(state: MixtureState, data, member, lab):
    """Two-component suffstats + row counts from launch labels.

    member: [N] bool (rows in the move's scope); lab: [N] int32 in {0,1}.
    Returns ([per-feature {leaf: [2, ...]}], counts [2] float row counts).
    """
    gid = jnp.where(member, lab, 2).astype(jnp.int32)
    stats2 = []
    for (x, mask), lik, hyper in zip(data, state.likelihoods(), state.hypers):
        stats2.append(lik.stats_from_assignments(hyper, x, mask, gid, 2))
    counts2 = jax.ops.segment_sum(
        member.astype(jnp.float32), gid, num_segments=3
    )[:2]
    return stats2, counts2


def _launch_table(state: MixtureState, data, stats2, counts2):
    """[N, 2] blocked restricted-Gibbs logits: log n_c + Σ_f pred_c."""
    lp = jnp.log(jnp.maximum(counts2, 1e-6))[None, :]
    for (x, mask), lik, hyper, s2 in zip(
        data, state.likelihoods(), state.hypers, stats2
    ):
        s = jax.vmap(lambda xr: lik.pred_logpdf(hyper, s2, xr))(x)
        lp = lp + s * jnp.asarray(mask, s.dtype)[:, None]
    return lp


def _ml_sum(state: MixtureState, stats_list):
    """Σ over features (and the [2] component axis) of marginal logliks."""
    total = jnp.asarray(0.0)
    for lik, hyper, s in zip(state.likelihoods(), state.hypers, stats_list):
        ml = lik.marginal_loglik(hyper, s)
        total = total + jnp.sum(ml)
    return total


def _slot_ml(state: MixtureState, slot):
    """Σ_f marginal loglik of existing slot `slot` (0 when empty)."""
    total = jnp.asarray(0.0)
    for lik, hyper, s in zip(state.likelihoods(), state.hypers, state.stats):
        ml = lik.marginal_loglik(hyper, s)[slot]
        total = total + jnp.where(state.counts[slot] > 0, ml, 0.0)
    return total


@partial(jax.jit, static_argnames=("t_scans",))
def move(state: MixtureState, data, key, t_scans: int = 3) -> MixtureState:
    """One split-merge MH move (anchor pair → launch → propose → accept)."""
    _check_support(state)
    n = state.n
    K = state.k_max
    z = state.assignments
    kp, ki, ks, kf, ka = jax.random.split(key, 5)

    i = jax.random.randint(kp, (), 0, n)
    j0 = jax.random.randint(jax.random.fold_in(kp, 1), (), 0, n - 1)
    j = j0 + (j0 >= i).astype(j0.dtype)          # j ≠ i, uniform
    ci, cj = z[i], z[j]
    is_split = ci == cj
    member = (z == ci) | (z == cj)
    rows = jnp.arange(n)
    free = member & (rows != i) & (rows != j)

    # ---- launch: anchor-seeded init + t_scans blocked restricted scans.
    # A random 50/50 init is a symmetric FIXED POINT of the blocked scan
    # (both components then carry near-identical mixture stats, so the
    # rescoring pass keeps labels random and proposed splits never find
    # structure — observed at n=400: every split of a 318-row mixture
    # came back ~50/50 with d_ml ≈ 0).  Seeding the first pass from the
    # two anchor rows ALONE (component stats = one row each) breaks the
    # symmetry the way Jain–Neal's sequential launch does: each member
    # joins the anchor it explains better, and the t_scans refinements
    # then sharpen a structured split. ----
    lab = jnp.ones((n,), jnp.int32).at[i].set(0)   # j stays 1
    anchor_only = (rows == i) | (rows == j)
    stats0, counts0 = _member_stats(state, data, anchor_only, lab)
    lp0 = _launch_table(state, data, stats0, counts0)
    g0 = jax.random.gumbel(ki, lp0.shape, lp0.dtype)
    lab = jnp.where(
        free, jnp.argmax(lp0 + g0, axis=-1).astype(jnp.int32), lab
    )
    lab = lab.at[i].set(0).at[j].set(1)

    def scan_body(lab, kt):
        stats2, counts2 = _member_stats(state, data, member, lab)
        lp = _launch_table(state, data, stats2, counts2)
        g = jax.random.gumbel(kt, lp.shape, lp.dtype)
        new = jnp.argmax(lp + g, axis=-1).astype(jnp.int32)
        return jnp.where(free, new, lab), None

    lab, _ = jax.lax.scan(scan_body, lab, jax.random.split(ks, t_scans))

    # ---- final blocked scan: the proposal density ----
    stats2, counts2 = _member_stats(state, data, member, lab)
    lp = _launch_table(state, data, stats2, counts2)
    logq = jax.nn.log_softmax(lp, axis=-1)       # [N, 2]

    m_rows = state.counts[ci] + jnp.where(is_split, 0, state.counts[cj])
    alpha = state.cluster_hp["alpha"].astype(jnp.float32)
    empty = state.counts == 0
    can_open = jnp.any(empty)
    b_slot = jnp.argmax(empty).astype(jnp.int32)  # first empty (split)

    # ---------------- split branch ----------------
    def split_branch(_):
        g = jax.random.gumbel(kf, lp.shape, lp.dtype)
        prop = jnp.argmax(lp + g, axis=-1).astype(jnp.int32)
        prop = jnp.where(free, prop, lab)         # anchors pinned
        q_fwd = jnp.sum(
            jnp.where(free, jnp.take_along_axis(
                logq, prop[:, None], axis=-1)[:, 0], 0.0)
        )
        stats2p, _ = _member_stats(state, data, member, prop)
        cnt_a = jnp.sum(member & (prop == 0)).astype(jnp.float32)
        cnt_b = jnp.sum(member & (prop == 1)).astype(jnp.float32)
        d_ml = _ml_sum(state, stats2p) - _slot_ml(state, ci)
        d_eppf = (
            jnp.log(alpha)
            + gammaln(cnt_a) + gammaln(cnt_b)
            - gammaln(cnt_a + cnt_b)
        )
        log_acc = jnp.where(
            can_open, d_ml + d_eppf - q_fwd, -jnp.inf
        )

        z_new = jnp.where(member & (prop == 1), b_slot, z)
        counts_new = (
            state.counts.at[ci].set(cnt_a.astype(state.counts.dtype))
            .at[b_slot].set(cnt_b.astype(state.counts.dtype))
        )
        stats_new = []
        for s_f, s2p in zip(state.stats, stats2p):
            stats_new.append(jax.tree_util.tree_map(
                lambda s, p: s.at[ci].set(p[0]).at[b_slot].set(p[1]),
                s_f, s2p,
            ))
        return z_new, counts_new, tuple(stats_new), log_acc

    # ---------------- merge branch ----------------
    def merge_branch(_):
        orig = (z == cj).astype(jnp.int32)        # current labels (a=ci)
        q_rev = jnp.sum(
            jnp.where(free, jnp.take_along_axis(
                logq, orig[:, None], axis=-1)[:, 0], 0.0)
        )
        merged = []
        ml_merged = jnp.asarray(0.0)
        for lik, hyper, s_f in zip(
            state.likelihoods(), state.hypers, state.stats
        ):
            sm = jax.tree_util.tree_map(
                lambda s: s[ci] + s[cj], s_f
            )
            merged.append(sm)
            ml_merged = ml_merged + lik.marginal_loglik(hyper, sm)
        d_ml = ml_merged - _slot_ml(state, ci) - _slot_ml(state, cj)
        cnt_a = state.counts[ci].astype(jnp.float32)
        cnt_b = state.counts[cj].astype(jnp.float32)
        d_eppf = (
            gammaln(cnt_a + cnt_b)
            - gammaln(cnt_a) - gammaln(cnt_b)
            - jnp.log(alpha)
        )
        log_acc = d_ml + d_eppf + q_rev

        z_new = jnp.where(z == cj, ci, z)
        counts_new = (
            state.counts.at[ci].add(state.counts[cj]).at[cj].set(0)
        )
        stats_new = []
        for s_f, sm in zip(state.stats, merged):
            s_upd = jax.tree_util.tree_map(
                lambda s, m_: s.at[ci].set(m_), s_f, sm
            )
            stats_new.append(
                lik_base.zero_slot(s_upd, cj, jnp.asarray(0.0))
            )
        return z_new, counts_new, tuple(stats_new), log_acc

    z_new, counts_new, stats_new, log_acc = jax.lax.cond(
        is_split, split_branch, merge_branch, None
    )

    accept = jnp.log(jax.random.uniform(ka)) < log_acc
    sel = lambda a, b: jnp.where(accept, a, b)
    return dataclasses.replace(
        state,
        assignments=sel(z_new, z),
        counts=sel(counts_new, state.counts),
        stats=tuple(
            jax.tree_util.tree_map(sel, s_new, s_old)
            for s_new, s_old in zip(stats_new, state.stats)
        ),
    )


@partial(jax.jit, static_argnames=("n_moves", "t_scans"))
def moves(state: MixtureState, data, key, n_moves: int = 4,
          t_scans: int = 3) -> MixtureState:
    """n_moves sequential split-merge proposals in one compiled scan."""
    _check_support(state)

    def body(st, k):
        return move(st, data, k, t_scans=t_scans), None

    state, _ = jax.lax.scan(
        body, state, jax.random.split(key, n_moves)
    )
    return state
