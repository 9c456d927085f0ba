"""Subsample annealing — collapsed Gibbs on a growing data subset.

No reference analog (the reference only has full-data sweeps,
kernels:gibbs.pyx); this is SURVEY.md §7 strategy (c) for large-N scale,
after "Scaling Nonparametric Bayesian Inference via Subsample-Annealing"
(arXiv 1402.5473, PAPERS.md): start the chain on a small prefix of the
data and anneal toward the full posterior by alternately *adding* unseen
rows (seated by their collapsed predictive scores) and *resampling*
already-active rows.  Early steps mix on tiny n where collapsed Gibbs is
cheap and modes are found fast; by the end the chain is exact collapsed
Gibbs on the full data, so the stationary distribution is the true
posterior.

Vectorized design: one `lax.scan` over anneal steps; each step's body is
an inner scan over exactly ``add_per_step + resample_per_step`` rows
through the same fused remove→score→sample→add row step as
kernels/gibbs.py (static shapes; a row with assignment −1 makes
``remove_value`` a masked no-op, so "add" and "resample" share one code
path).  Rows are visited through a fixed random permutation so the active
set is always a prefix; resample targets are drawn uniformly from the
currently active prefix with a traced upper bound.

Total work is ``n_steps · (add + resample)`` row updates — for the linear
schedule roughly half a full-data sweep's rows per data pass, with most
updates happening at small active-n where each is also *cheaper to mix*.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from common_tpu import state as state_mod
from common_tpu import validator
from common_tpu.kernels.gibbs import _row_sweep_step
from common_tpu.state import MixtureState


def empty_state(defn, data, key, cluster_hp=None, feature_hps=None,
                fixed: bool = False) -> MixtureState:
    """A state with every row unassigned (the annealing start point)."""
    return state_mod.initialize(
        defn, data, key, cluster_hp=cluster_hp, feature_hps=feature_hps,
        assignment=-jnp.ones(defn.n, jnp.int32), fixed=fixed,
    )


def linear_schedule(n: int, n_init: int = 0, add_per_step: int = 8,
                    resample_per_step: int = 8):
    """(n_steps, add, resample) covering all n rows with a linear ramp.

    Returns at least 1 step so a fully-assigned initial state (n_init >= n)
    degrades to one random-scan resample block instead of an invalid
    n_steps == 0 config.
    """
    remaining = max(n - n_init, 0)
    n_steps = max(-(-remaining // add_per_step), 1)
    return n_steps, add_per_step, resample_per_step


@partial(jax.jit, static_argnames=("n_steps", "add_per_step",
                                   "resample_per_step", "m"))
def run(
    state: MixtureState,
    data,
    key,
    n_steps: int,
    add_per_step: int = 8,
    resample_per_step: int = 8,
    m: int = 1,
) -> MixtureState:
    """Anneal from the current active prefix to the full dataset.

    state: rows assigned (≥0) count as already active; typically from
      `empty_state` (n_init=0) or an `initialize` over a prefix.
    n_steps·add_per_step must be ≥ the number of unassigned rows; extra
      capacity clamps at n (duplicate visits are plain resamples).
    m: Neal-8 auxiliary slots for non-conjugate features.
    """
    validator.validate_positive(n_steps, "n_steps")
    validator.validate_positive(add_per_step, "add_per_step")
    validator.validate_nonnegative(resample_per_step, "resample_per_step")
    n = state.n
    kperm, ksteps = jax.random.split(key)

    # Fixed visit order with active rows first, so the active set is always
    # a prefix of `perm`.  argsort is stable: among unassigned rows the
    # order is the random permutation's.
    perm = jax.random.permutation(kperm, n)
    active0 = state.assignments[perm] >= 0
    perm = perm[jnp.argsort(~active0)]
    n_active0 = jnp.sum(active0).astype(jnp.int32)

    block = add_per_step + resample_per_step

    def anneal_step(carry, t):
        st, n_active = carry
        kt = jax.random.fold_in(ksteps, t)

        # rows to seat this step: perm[n_active + j]; once the prefix is
        # exhausted, leftover add slots become uniform resamples over the
        # full active set (clamping them all to row n-1 would waste every
        # post-activation add slot on one fixed row)
        j = jnp.arange(add_per_step)
        n_next = jnp.minimum(n_active + add_per_step, n)
        spill = jax.random.randint(
            jax.random.fold_in(kt, 0), (add_per_step,), 0, n_next
        )
        add_idx = jnp.where(n_active + j < n, n_active + j, spill)

        # resample targets: uniform over the new active prefix
        ridx = jax.random.randint(
            jax.random.fold_in(kt, 1), (resample_per_step,), 0, n_next
        )
        eids = perm[jnp.concatenate([add_idx, ridx])]

        def row(st_, i):
            # fold (step, slot) into the key: every visit gets fresh noise
            return _row_sweep_step(
                data, m, jax.random.fold_in(kt, 2 + i[0]), st_, i[1]
            )

        st, _ = jax.lax.scan(row, st, (jnp.arange(block), eids))
        return (st, n_next), None

    (state, _), _ = jax.lax.scan(
        anneal_step, (state, n_active0), jnp.arange(n_steps)
    )
    return state
