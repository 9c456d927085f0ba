"""Uniform argument validation.

JAX rebuild of the reference's validation helpers
(``common:microscopes/common/validator.py``): every public API entry point
across the framework funnels argument checking through these functions so
error messages are uniform. Host-side only — never called under `jit`.
"""

from __future__ import annotations

from typing import Any, Iterable, Sized


def validate_not_none(x: Any, name: str = "value") -> None:
    if x is None:
        raise ValueError(f"{name} must not be None")


def validate_type(x: Any, tpe, name: str = "value") -> None:
    if not isinstance(x, tpe):
        raise ValueError(
            f"{name} must be of type {tpe}, got {type(x).__name__}: {x!r}"
        )


def validate_kind(x: Any, kind: str, name: str = "value") -> None:
    """Validate numpy-style dtype kind of an array-like (e.g. 'f', 'i', 'b')."""
    import numpy as np

    arr = np.asarray(x)
    if arr.dtype.kind != kind:
        raise ValueError(
            f"{name} must have dtype kind {kind!r}, got {arr.dtype} ({arr.dtype.kind!r})"
        )


def validate_len(x: Sized, n: int, name: str = "value") -> None:
    if len(x) != n:
        raise ValueError(f"{name} must have length {n}, got {len(x)}")


def validate_nonempty(x: Sized, name: str = "value") -> None:
    if len(x) == 0:
        raise ValueError(f"{name} must be non-empty")


def validate_positive(x, name: str = "value") -> None:
    if not x > 0:
        raise ValueError(f"{name} must be positive, got {x}")


def validate_nonnegative(x, name: str = "value") -> None:
    if not x >= 0:
        raise ValueError(f"{name} must be non-negative, got {x}")


def validate_in_range(x, n_or_lo, hi=None, name: str = "value") -> None:
    """validate_in_range(x, n): 0 <= x < n;  validate_in_range(x, lo, hi): lo <= x < hi."""
    lo, n = (0, n_or_lo) if hi is None else (n_or_lo, hi)
    if not (lo <= x < n):
        raise ValueError(f"{name} must be in [{lo}, {n}), got {x}")


def validate_one_of(x, options: Iterable, name: str = "value") -> None:
    opts = tuple(options)
    if x not in opts:
        raise ValueError(f"{name} must be one of {opts}, got {x!r}")
