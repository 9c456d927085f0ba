"""Tabular (recarray) dataview — typed columns + per-cell missingness.

Reference analog: ``common:include/microscopes/common/recarray/dataview.hpp``
+ ``_dataview.pyx`` (`numpy_dataview(recarray)`): a read-only row-major view
over numpy structured/masked arrays, iterated row-by-row by the C++ Gibbs
loop.

Vectorized design (SURVEY.md §2.2 item 4): columns become a tuple of
``(values [N, …], mask [N])`` device arrays — the layout every kernel in
:mod:`common_tpu.kernels` consumes directly (no row iteration; kernels
scan/vmap the row axis).  Masked-array and structured-array ingestion is
host-side; per-element masks on vector cells are reduced to a row-level
mask with "any missing element masks the cell" semantics.  Columns are
shardable along the row axis via `jax.sharding.NamedSharding` (see
parallel/).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from common_tpu import validator
from common_tpu.state import MixtureDefinition


class numpy_dataview:
    """Columns-of-device-arrays view over tabular host data.

    Accepts, mirroring the reference's ingestion surface:
      - a numpy *structured* array (one field per feature), optionally
        ``numpy.ma`` masked;
      - a list/tuple of per-feature arrays ([N] or [N, d]), optionally
        masked arrays.

    Exposes ``.columns`` — ``tuple[(values, mask), ...]`` with float 0/1
    masks (1 = observed) — which is the `data` argument of every kernel.
    """

    def __init__(self, arr, defn: Optional[MixtureDefinition] = None):
        if isinstance(arr, (list, tuple)):
            cols = [self._one_column(a) for a in arr]
        elif isinstance(arr, np.ndarray) and arr.dtype.names:
            cols = [
                self._one_column(
                    arr[name] if not np.ma.isMaskedArray(arr) else arr[name]
                )
                for name in arr.dtype.names
            ]
        elif isinstance(arr, np.ndarray):
            # single plain array = single feature
            cols = [self._one_column(arr)]
        else:
            raise ValueError(
                f"unsupported data input of type {type(arr).__name__}"
            )
        ns = {c[0].shape[0] for c in cols}
        if len(ns) != 1:
            raise ValueError(f"columns disagree on row count: {sorted(ns)}")
        self._n = ns.pop()
        if defn is not None:
            validator.validate_len(cols, defn.nfeatures, "data columns")
            cols = [
                (jnp.asarray(
                    d.rtype.validate_column(np.asarray(v), f"column {i}")
                ), m)
                for i, ((v, m), d) in enumerate(zip(cols, defn.models))
            ]
        self.columns: Tuple = tuple(cols)

    @staticmethod
    def _one_column(a):
        if np.ma.isMaskedArray(a):
            mask_elems = np.ma.getmaskarray(a)
            # any masked element in a vector cell masks the whole cell
            row_missing = (
                mask_elems
                if mask_elems.ndim == 1
                else mask_elems.reshape(mask_elems.shape[0], -1).any(axis=1)
            )
            values = np.ascontiguousarray(np.ma.getdata(a))
            mask = (~row_missing).astype(np.float32)
        else:
            values = np.ascontiguousarray(a)
            mask = np.ones(len(values), np.float32)
        return (jnp.asarray(values), jnp.asarray(mask))

    def size(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def view(self):
        """The kernel-facing representation (tuple of (values, mask))."""
        return self.columns

    def toarray(self) -> list:
        """Host round-trip (masked numpy arrays), for tests/debug."""
        out = []
        for v, m in self.columns:
            vv = np.asarray(v)
            mm = np.asarray(m) == 0.0
            if vv.ndim > 1:
                mm = np.broadcast_to(mm.reshape(-1, *([1] * (vv.ndim - 1))), vv.shape)
            out.append(np.ma.masked_array(vv, mask=mm))
        return out
