"""Hand-written Pallas kernels for the hot ops (SURVEY.md §7 step 8)."""

from common_tpu.ops.gaussian_assign import (  # noqa: F401
    fused_gaussian_assign,
    gaussian_assign_reference,
)
