"""Tracing/profiling utilities (SURVEY.md §5.1 rebuild).

The reference has no profiling subsystem (a trivial RAII timer at most);
the JAX replacement wraps `jax.profiler` for device traces and
provides kernel-throughput measurement with proper dispatch/compile
separation — the plumbing behind the north-star sweeps/s and ESS/s
numbers (bench.py).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional

import jax

named_scope = jax.named_scope  # per-kernel-stage annotation in traces


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device=None) -> Dict[str, Any]:
    """HBM usage counters for a device (empty dict if unsupported)."""
    d = device or jax.devices()[0]
    try:
        return dict(d.memory_stats() or {})
    except Exception:
        return {}


def benchmark(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    block_on: Optional[Callable] = None,
) -> Dict[str, float]:
    """Wall-time a jitted step: compile excluded, device-synchronized.

    fn(*args) must return something block-until-ready-able (a pytree of
    arrays); `block_on` optionally extracts the leaf to block on.
    Returns {'mean_s', 'min_s', 'median_s', 'iters_per_s'}.
    """
    import numpy as np

    def run_once():
        out = fn(*args)
        target = block_on(out) if block_on is not None else out
        jax.block_until_ready(target)
        return out

    for _ in range(max(warmup, 1)):
        run_once()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run_once()
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return {
        "mean_s": float(ts.mean()),
        "min_s": float(ts.min()),
        "median_s": float(np.median(ts)),
        "iters_per_s": float(1.0 / np.median(ts)),
    }


def sweeps_per_second(step: Callable, state, *args, iters: int = 10,
                      **kw) -> float:
    """Convenience: median sweeps/s of a `step(state, ...) -> state` kernel."""
    res = benchmark(step, state, *args, iters=iters, **kw)
    return res["iters_per_s"]
