"""Data layer — JAX rebuilds of the reference's three dataviews
(recarray tabular, variadic ragged, sparse N-d relation) as static-shape
device-array layouts shardable over a mesh `data` axis."""

from common_tpu.data.recarray import numpy_dataview  # noqa: F401
from common_tpu.data.sparse import sparse_ndarray_dataview  # noqa: F401
from common_tpu.data.variadic import variadic_dataview  # noqa: F401
