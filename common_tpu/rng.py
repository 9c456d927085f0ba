"""PRNG key threading — the JAX analog of the reference's ``rng_t``.

The reference threads a single mt19937 ``rng_t`` (from the `distributions`
library, wrapped in ``common:microscopes/common/_rng.pyx``) mutably through
every sampling call. In JAX the analog is JAX's splittable counter-based
PRNG: a `jax.random` key threaded *functionally* through kernels, with a
`fold_in` discipline so any (sweep, row) step is independently replayable —
which is what makes checkpoint/resume bit-exact and multi-chip sharding
deterministic.

Conventions used across the framework:
  - every kernel takes and returns explicit keys (no hidden state);
  - per-iteration keys:  ``key_t  = fold_in(key, t)``
  - per-row/site keys:   ``key_ti = fold_in(key_t, i)``  (inside vmap/scan)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class rng:
    """Seeded RNG handle mirroring the reference's Python ``rng(seed)`` object.

    Unlike the reference's mutable mt19937 wrapper, this is a thin,
    *immutable* convenience over a JAX key for host-side/eager use: each
    ``next_key()`` call returns a fresh subkey by splitting an internal
    counter fold. Library kernels never use this class — they take raw keys.
    """

    __slots__ = ("_key", "_count")

    def __init__(self, seed: int = 0):
        if not isinstance(seed, (int,)):
            raise ValueError(f"seed must be an int, got {type(seed)}")
        self._key = jax.random.key(seed)
        self._count = 0

    def next_key(self):
        """Return a fresh subkey (advances the internal counter)."""
        self._count += 1
        return jax.random.fold_in(self._key, self._count)

    @property
    def key(self):
        return self._key

    def __repr__(self):
        return f"rng(count={self._count})"


def split_many(key, n: int):
    """Split a key into n subkeys (thin wrapper, shape [n])."""
    return jax.random.split(key, n)


def fold_all(key, *ids):
    """Fold a sequence of integer identifiers into a key, in order."""
    for i in ids:
        key = jax.random.fold_in(key, i)
    return key


def gumbel_argmax(key, logits, axis=-1):
    """Sample from a categorical given (possibly -inf masked) log-weights.

    The JAX analog of the reference's ``sample_discrete_log``
    (distributions lib): instead of exp/normalize/linear-scan, draw Gumbel
    noise and take the argmax — branch-free, vectorizes over any batch.
    -inf logits are never selected (gumbel + -inf = -inf).
    """
    g = jax.random.gumbel(key, logits.shape, dtype=logits.dtype)
    return jnp.argmax(logits + g, axis=axis)
