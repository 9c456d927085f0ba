"""Sparse N-d relation dataview — nonzero cells of relation tensors.

Reference analog:
``common:include/microscopes/common/sparse_ndarray/dataview.hpp`` +
``_dataview.pyx`` — the IRM data layer: iterate the observed cells of an
N-dimensional (usually 2-D) relation with their index tuples, supporting
dense-with-mask and sparse backings.

Vectorized design: observed cells become COO triples with static padding —
``(indices [M_pad, ndim] int32, values [M_pad], mask [M_pad])`` — so
relation likelihood scans are flat vmaps/segment ops over the cell axis,
shardable along cells.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from common_tpu import validator


class sparse_ndarray_dataview:
    """COO view over an N-dim relation.

    Construct from either:
      - a dense array + optional boolean missing-mask (True = missing), or
      - explicit (indices [M, ndim], values [M], shape).
    """

    def __init__(
        self,
        dense: Optional[np.ndarray] = None,
        missing_mask: Optional[np.ndarray] = None,
        indices: Optional[np.ndarray] = None,
        values: Optional[np.ndarray] = None,
        shape: Optional[Tuple[int, ...]] = None,
        pad_to: Optional[int] = None,
    ):
        if dense is not None:
            if np.ma.isMaskedArray(dense):
                missing_mask = np.ma.getmaskarray(dense)
                dense = np.ma.getdata(dense)
            dense = np.asarray(dense)
            observed = (
                np.ones(dense.shape, bool)
                if missing_mask is None
                else ~np.asarray(missing_mask, bool)
            )
            idx = np.argwhere(observed).astype(np.int32)
            vals = dense[observed]
            shape = dense.shape
        else:
            validator.validate_not_none(indices, "indices")
            validator.validate_not_none(values, "values")
            validator.validate_not_none(shape, "shape")
            idx = np.asarray(indices, np.int32)
            vals = np.asarray(values)
            if idx.ndim != 2 or idx.shape[0] != len(vals):
                raise ValueError(
                    f"indices {idx.shape} inconsistent with values {vals.shape}"
                )

        m = len(vals)
        cap = int(pad_to) if pad_to is not None else m
        if cap < m:
            raise ValueError(f"pad_to={cap} < observed cell count {m}")
        pad = cap - m
        if pad:
            idx = np.concatenate([idx, np.zeros((pad, idx.shape[1]), np.int32)])
            vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
        mask = (np.arange(cap) < m).astype(np.float32)

        self.shape = tuple(int(s) for s in shape)
        self.indices = jnp.asarray(idx)
        self.values = jnp.asarray(vals)
        self.mask = jnp.asarray(mask)
        self._nobserved = m

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def nobserved(self) -> int:
        return self._nobserved

    def __len__(self) -> int:
        return self._nobserved

    def todense(self, fill=0) -> np.ma.MaskedArray:
        """Host round-trip as a masked dense array (tests/debug)."""
        dense = np.full(self.shape, fill, np.asarray(self.values).dtype)
        missing = np.ones(self.shape, bool)
        idx = np.asarray(self.indices)[: self._nobserved]
        vals = np.asarray(self.values)[: self._nobserved]
        dense[tuple(idx.T)] = vals
        missing[tuple(idx.T)] = False
        return np.ma.masked_array(dense, mask=missing)
