"""Likelihood interface — the JAX rebuild of the reference's model layer.

Reference analog: ``common:include/microscopes/models/base.hpp`` defines the
abstract ``models::model`` (prior/shared side) and ``models::feature_group``
(per-cluster side) interfaces, with ``distributions.hpp`` adapting the
`distributions` C++ library's per-model ``Shared``/``Group`` structs
(``add_value``/``remove_value``/``score_value``/``score_data``/``sample_value``).
That design is per-row, per-group, per-feature *virtual dispatch* — the #1
hot path flagged in SURVEY.md §3.2.

Here the same capability is a namespace of **pure, batch-vectorized
functions** over suffstat pytrees with a leading cluster axis ``[K, ...]``:

  - ``tx(x, mask)``          suffstat contribution of one row (the reference's
                             Group add/remove delta); leaves broadcast so the
                             same function serves scan steps and segment-sums.
  - stats fold (generic)     ``stats + sign * tx`` — replaces add_value /
                             remove_value mutation with scatter-add.
  - ``pred_logpdf``          posterior predictive log p(x | stats) over all K
                             clusters at once (the reference's score_value,
                             de-virtualized and vectorized).
  - ``marginal_loglik``      log marginal likelihood of each cluster's data
                             (the reference's score_data).
  - ``sample_params`` /      explicit-parameter path for uncollapsed/blocked
    ``logpdf`` /             Gibbs, slice, HMC/NUTS and posterior draws — the
    ``sample_value``         reference has no uncollapsed path; this is the
                             accelerator perf path (fully parallel [N, K] scoring).

All functions are jit-safe, shape-static, and broadcast over arbitrary
leading batch axes of ``stats`` (clusters, chains, particles).

Conventions:
  - ``stats`` is a dict pytree; every likelihood includes its own ``n`` leaf
    (per-cluster count of *observed* rows for this feature — masked cells do
    not contribute, mirroring the reference's per-feature-group counts).
  - ``hyper`` is a dict pytree of scalars/arrays (get_hp/set_hp analog:
    plain dict access).
  - ``x`` is a single row value; mask is 0.0/1.0.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp


Pytree = Any


def fold(stats: Pytree, tx: Pytree, sign) -> Pytree:
    """stats <- stats + sign * tx  (generic add_value/remove_value)."""
    return jax.tree_util.tree_map(lambda s, t: s + sign * t, stats, tx)


def scatter_fold(stats: Pytree, gid, tx: Pytree, sign) -> Pytree:
    """Scatter-add one row's suffstat contribution into cluster slot `gid`.

    Leaves of `stats` have leading cluster axis [K, ...]; leaves of `tx`
    are a single row's contribution.
    """
    return jax.tree_util.tree_map(
        lambda s, t: s.at[gid].add(sign * t.astype(s.dtype)), stats, tx
    )


def zero_slot(stats: Pytree, gid, keep) -> Pytree:
    """Multiply cluster slot `gid` by `keep` (0 clears it).

    Used to kill float drift when a cluster empties: exact-sum suffstats
    accumulate rounding error across add/remove cycles; clearing an emptied
    slot restores the empty-group invariant stats == 0 exactly (the
    reference instead deletes the group object: group_manager.hpp
    delete_group).
    """
    return jax.tree_util.tree_map(
        lambda s: s.at[gid].multiply(jnp.asarray(keep).astype(s.dtype)), stats
    )


class Likelihood:
    """Base class: stateless namespaces of pure functions, one per model."""

    name: str = "abstract"
    conjugate: bool = True
    # suffstat-dict keys that are explicit latents, not additive sums
    # (excluded from segment-sum recomputation; see bbnc)
    latent_leaves: tuple = ()

    # --- schema ---------------------------------------------------------
    def default_hyper(self) -> Dict[str, Any]:
        raise NotImplementedError

    def validate_hyper(self, hyper: Dict[str, Any]) -> Dict[str, Any]:
        """Canonicalize a hyper dict to jnp arrays; raise on missing keys."""
        ref = self.default_hyper()
        missing = set(ref) - set(hyper)
        if missing:
            raise ValueError(f"{self.name}: missing hyperparameters {sorted(missing)}")
        return {k: jnp.asarray(hyper[k]) for k in ref}

    def init_stats(self, hyper: Dict[str, Any], batch_shape: Tuple[int, ...]) -> Pytree:
        """Zero suffstats with leading batch shape (usually (K,))."""
        raise NotImplementedError

    # --- suffstats ------------------------------------------------------
    def tx(self, hyper: Dict[str, Any], x, mask) -> Pytree:
        """One row's suffstat contribution, scaled by mask (0 or 1)."""
        raise NotImplementedError

    # --- collapsed scoring ---------------------------------------------
    def pred_logpdf(self, hyper, stats, x):
        """Posterior-predictive log p(x | stats); broadcasts over stats' batch."""
        raise NotImplementedError

    def marginal_loglik(self, hyper, stats):
        """Log marginal likelihood of the data summarized in stats."""
        raise NotImplementedError

    # --- explicit-parameter path ---------------------------------------
    def sample_params(self, key, hyper, stats):
        """Draw theta ~ p(theta | stats) (posterior; prior when stats==0)."""
        raise NotImplementedError

    def logpdf(self, theta, x):
        """log p(x | theta); broadcasts over theta's batch axes."""
        raise NotImplementedError

    def logpdf_batch(self, theta, X, mask):
        """[N, K] log-likelihood table for the blocked/uncollapsed path.

        Default: vmap of `logpdf` over rows. Override with a matmul
        formulation where the matrix units can be engaged (e.g. Gaussian quadratic
        forms).  `theta` leaves have leading [K]; X is [N, ...]; mask [N].
        """
        per_row = jax.vmap(lambda x: self.logpdf(theta, x))(X)
        return per_row * mask[:, None]

    def sample_value(self, key, theta):
        """Draw x ~ p(x | theta)."""
        raise NotImplementedError

    def prior_logpdf(self, hyper, theta):
        """log p(theta | hyper) — needed by non-conjugate kernels (slice/HMC)."""
        raise NotImplementedError

    def stats_from_assignments(self, hyper, X, mask, gid, K: int):
        """Per-cluster suffstats from scratch: segment-sum of tx over rows.

        gid: [N] int32 cluster ids in [0, K) (or K for unassigned/dropped).
        Generic path vmaps `tx` then segment-sums each leaf; override when
        the per-row suffstat is large (NIW's outer products) with a
        matmul formulation that never materializes [N, …] intermediates.
        """
        import jax as _jax

        txs = _jax.vmap(lambda xi, mi: self.tx(hyper, xi, mi))(X, mask)

        def seg(t):
            return _jax.ops.segment_sum(t, gid, num_segments=K + 1)[:K]

        summed = _jax.tree_util.tree_map(seg, txs)
        zeros = self.init_stats(hyper, (K,))
        return {
            k: (zeros[k] if k in self.latent_leaves else summed[k])
            for k in zeros
        }

    # --- conjugate exponential-family structure (SVI path) --------------
    # When has_expfam is True the model exposes its conjugate prior as an
    # exponential family over theta: p(theta|hyper) = exp(eta·T(theta) −
    # A(eta)) h0(theta), with the likelihood's log p(x|theta) = t(x)·T(theta)
    # + log h(x) (t(x) aligned component-wise with T).  Everything SVI needs
    # (E_q[log p(x|theta)], KL(q‖prior), natural-gradient updates) then
    # follows generically from autodiff of A — see likelihoods/expfam.py.
    has_expfam: bool = False

    def posterior_hyper(self, hyper, stats):
        """Conjugate posterior hyper given suffstats (broadcasts over batch)."""
        raise NotImplementedError

    def nat_params(self, hyper) -> Pytree:
        """Natural parameters eta of the conjugate prior (dict pytree)."""
        raise NotImplementedError

    def log_partition(self, nat) -> Any:
        """A(eta): log-normalizer of the conjugate prior; differentiable."""
        raise NotImplementedError

    def suffstat_pair(self, hyper, x, mask) -> Pytree:
        """t(x)·mask, component-aligned with nat_params/T(theta).

        `hyper` supplies family shape info only (e.g. dd's category count);
        t(x) never depends on hyper *values*.
        """
        raise NotImplementedError

    def log_h(self, hyper, x, mask):
        """log base measure of the likelihood at x (mask-scaled)."""
        raise NotImplementedError

    def stats_from_weights(self, hyper, X, mask, r) -> Pytree:
        """Soft-weighted suffstats [K, ...] = Σ_n r[n, k] · tx(x_n).

        The SVI M-step analog of `stats_from_assignments`.  Default: vmap
        `tx` then one einsum per leaf; override when the per-row suffstat
        is large (NIW's outer products) with a matmul formulation.
        """
        txs = jax.vmap(lambda xi, mi: self.tx(hyper, xi, mi))(X, mask)
        return jax.tree_util.tree_map(
            lambda t: jnp.einsum("nk,n...->k...", r, t), txs
        )

    def refresh_latents(self, key, hyper, stats, refresh_mask):
        """Redraw any explicit latents inside `stats` where refresh_mask set.

        Identity for conjugate models (no explicit latents).  Non-conjugate
        models (bbnc) override: birth candidates / Neal-8 aux slots need
        fresh prior draws before they can be scored.
        """
        del key, hyper, refresh_mask
        return stats

    def __repr__(self):
        return f"<likelihood {self.name}>"


# ----------------------------------------------------------------------
# registry (the analog of the reference's models.py module-level zoo)
# ----------------------------------------------------------------------
_REGISTRY: Dict[str, Likelihood] = {}


def register(lik: Likelihood) -> Likelihood:
    _REGISTRY[lik.name] = lik
    return lik


def get(name: str) -> Likelihood:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown likelihood {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def names():
    return sorted(_REGISTRY)
