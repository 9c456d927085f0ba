"""Generic conjugate exponential-family machinery (the SVI engine room).

No reference analog: the reference's `distributions` library hand-codes
every per-model density; here the variational quantities all derive from
one object per family — the conjugate prior's log-partition A(eta) — via
autodiff:

  E_q[T(theta)]        = ∇A(eta_q)                       (mean params)
  E_q[log p(x|theta)]  = t(x)·∇A(eta_q) + log h(x)       (expected loglik)
  KL(q ‖ p)            = (eta_q − eta_p)·∇A(eta_q) − A(eta_q) + A(eta_p)

where q = the conjugate family at eta_q (SVI's variational posterior) and
p = the prior at eta_p.  Each likelihood supplies `nat_params(hyper)`,
`log_partition(nat)`, `suffstat_pair(x, mask)` (t(x), aligned with eta),
and `log_h(x, mask)`; everything here is family-agnostic.

All helpers broadcast over a leading cluster axis [K] on the hyper side
via vmap, and over rows [N] on the data side.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


def _grad_A_flat(lik, nat_flat, unravel):
    return jax.grad(lambda f: lik.log_partition(unravel(f)))(nat_flat)


def expected_T(lik, hyper):
    """∇A(eta(hyper)) as a pytree shaped like nat_params (scalar hyper)."""
    nat = lik.nat_params(hyper)
    flat, unravel = ravel_pytree(nat)
    return unravel(_grad_A_flat(lik, flat, unravel))


def expected_logpdf(lik, hyper_q, x, mask):
    """E_q[log p(x | theta)] for a single row under a single q (no batch)."""
    et = expected_T(lik, hyper_q)
    t = lik.suffstat_pair(hyper_q, x, mask)
    dot = sum(
        jnp.sum(a * b)
        for a, b in zip(jax.tree_util.tree_leaves(t),
                        jax.tree_util.tree_leaves(et))
    )
    return dot + lik.log_h(hyper_q, x, mask)


def kl(lik, hyper_q, hyper_p):
    """KL(q ‖ p) between two members of the conjugate family (no batch)."""
    nat_q = lik.nat_params(hyper_q)
    nat_p = lik.nat_params(hyper_p)
    fq, unravel = ravel_pytree(nat_q)
    fp, _ = ravel_pytree(nat_p)
    g = _grad_A_flat(lik, fq, unravel)
    return (
        jnp.dot(fq - fp, g)
        - lik.log_partition(unravel(fq))
        + lik.log_partition(unravel(fp))
    )


# ---------------------------------------------------------------------------
# batched variants (cluster axis K on q; row axis N on data)
# ---------------------------------------------------------------------------
def expected_T_k(lik, hyper_q_k):
    """∇A per cluster: hyper_q_k leaves have leading [K]."""
    return jax.vmap(lambda h: expected_T(lik, h))(hyper_q_k)


def expected_loglik_table(lik, hyper_p, hyper_q_k, X, mask):
    """[N, K] table of E_q[log p(x_n | theta_k)].

    Computed as T_x @ E[T] — one matmul over the flattened suffstat axis,
    so the matrix units carry the N×K work (cf. pred_logpdf's role in the
    collapsed path).  hyper_p supplies family shape info for t(x).
    """
    et_k = expected_T_k(lik, hyper_q_k)  # leaves [K, ...]
    t_n = jax.vmap(
        lambda x, m: lik.suffstat_pair(hyper_p, x, m)
    )(X, mask)  # [N, ...]

    def flat2(tree, lead):
        leaves = jax.tree_util.tree_leaves(tree)
        return jnp.concatenate(
            [l.reshape(lead, -1) for l in leaves], axis=-1
        )

    n = X.shape[0]
    k = jax.tree_util.tree_leaves(et_k)[0].shape[0]
    tmat = flat2(t_n, n)        # [N, S]
    emat = flat2(et_k, k)       # [K, S]
    return tmat @ emat.T + lik.log_h(hyper_p, X, mask)[:, None]


def kl_k(lik, hyper_q_k, hyper_p):
    """[K] KL(q_k ‖ prior) for per-cluster variational posteriors."""
    return jax.vmap(lambda h: kl(lik, h, hyper_p))(hyper_q_k)
