"""Debug / replay tiers (SURVEY.md §5.2's rebuild of the reference's
sanitizer niche).

The reference is single-threaded C++ with no sanitizer CI; the vectorized
equivalents are:

  nan_check()      context: every compiled program output is checked for
                   NaN (jax_debug_nans) — the "ASAN tier" for numerics.
                   CI runs the gibbs/NIW smoke under it
                   (tests/test_niw_numerics.py).
  x64()            context: trace in float64 (CPU) — the reference-path
                   tier for f32-vs-f64 tolerance comparisons.  New
                   computations inside the context default to f64; pass
                   f64 inputs to promote existing code paths.
  replay_key()     the fold_in discipline, named: every kernel derives its
                   per-(sweep, row, feature) keys as
                   fold_in(fold_in(key, sweep), row) chains, so any single
                   step of a crashed run can be re-executed in isolation
                   by rebuilding its key from the trace coordinates.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def nan_check():
    """Raise FloatingPointError on any NaN in jitted outputs (debug tier).

    Compiled functions are re-run op-by-op on NaN detection to locate the
    producing primitive; expect a large slowdown — test/debug only.
    """
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def x64():
    """Context manager enabling float64 tracing (reference-path tier).

    Usage: ``with debug.x64(): ml = lik.marginal_loglik(h64, stats64)``
    where h64/stats64 carry f64 leaves; compare against the f32 result
    with a tolerance tier (see tests/test_niw_numerics.py).
    """
    return jax.enable_x64(True)


def replay_key(key, *coords):
    """Rebuild the PRNG key of one traced step from its coordinates.

    Kernels thread keys as fold_in chains (sweep → kernel-slot → row →
    feature ...); given the same base key and the coordinates recorded in
    the JSONL trace, the exact key of any step is reproducible:

        k_row = replay_key(run_key, sweep, kernel_idx, row)
    """
    for c in coords:
        key = jax.random.fold_in(key, c)
    return key


@contextlib.contextmanager
def strict_matmul_precision():
    """Force full-f32 ("highest") matmul precision for every XLA dot.

    On the GPU a DEFAULT-precision f32 matmul runs in TF32 (10-bit
    mantissa inputs), ~5e-4 relative per product.  Reproducibility
    studies and reference comparisons can opt into full f32 here, off
    the tensor cores.  Dots with an explicit precision keep it (the
    scatter restat's bf16 passes in `niw.scatter_product`, the fused
    assign kernel's TF32 dot).
    """
    import jax

    prev = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        yield
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
