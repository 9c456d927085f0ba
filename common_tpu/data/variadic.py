"""Variadic (ragged-row) dataview — documents as variable-length token lists.

Reference analog: ``common:include/microscopes/common/variadic/dataview.hpp``
+ ``_dataview.pyx`` (`numpy_dataview(list_of_arrays)`) — the LDA data layer.

Vectorized design: ragged rows become a CSR-style flat layout with static
shapes — ``(tokens [T_pad], row_ptr [N+1], token_mask [T_pad])`` — so
per-document reductions are `segment_sum`s over a flat token axis and the
whole corpus shards along tokens/documents.  Padding tokens carry mask 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from common_tpu import validator


class variadic_dataview:
    """Flat CSR view over a list of variable-length integer/float rows."""

    def __init__(self, rows: Sequence, pad_to: Optional[int] = None):
        validator.validate_nonempty(rows, "rows")
        lengths = np.array([len(r) for r in rows], np.int32)
        total = int(lengths.sum())
        cap = int(pad_to) if pad_to is not None else total
        if cap < total:
            raise ValueError(f"pad_to={cap} < total token count {total}")
        flat = np.concatenate([np.asarray(r) for r in rows]) if total else np.array([])
        pad = cap - total
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, flat.dtype)])
        row_ptr = np.zeros(len(rows) + 1, np.int32)
        np.cumsum(lengths, out=row_ptr[1:])
        mask = np.arange(cap) < total

        self.tokens = jnp.asarray(flat)
        self.row_ptr = jnp.asarray(row_ptr)
        self.token_mask = jnp.asarray(mask.astype(np.float32))
        # per-token document id — the segment key for doc-level reductions
        doc_ids = np.repeat(np.arange(len(rows), dtype=np.int32), lengths)
        if pad:
            doc_ids = np.concatenate([doc_ids, np.full(pad, len(rows), np.int32)])
        self.doc_ids = jnp.asarray(doc_ids)
        self._n = len(rows)
        self._lengths = lengths

    def size(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def rowsize(self, i: int) -> int:
        return int(self._lengths[i])

    def row(self, i: int) -> np.ndarray:
        """Host-side row extraction (tests/debug)."""
        lo, hi = int(self.row_ptr[i]), int(self.row_ptr[i + 1])
        return np.asarray(self.tokens[lo:hi])

    def toarray(self) -> list:
        return [self.row(i) for i in range(self._n)]
