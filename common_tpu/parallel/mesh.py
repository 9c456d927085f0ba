"""Device mesh construction for chain/data sharding.

The reference has no distributed backend (SURVEY.md §2.3) — its only
parallelism is multiprocessing multi-chain.  The JAX equivalent is a
`jax.sharding.Mesh` with named axes

  chains — independent MCMC chains (embarrassingly parallel; DP analog)
  data   — row sharding for likelihood + suffstat work (SP/FSDP analog)

with all cross-device communication expressed as XLA collectives (`psum`
of suffstats over `data`, diagnostics reductions over `chains`), which
XLA hands to NCCL on GPUs.  The devices of one host are joined all to
all, so the mesh shape follows the algorithm alone.  Multi-host: call
`init_distributed` before building the mesh.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from common_tpu import validator

CHAINS, DATA = "chains", "data"

# Environment markers whose presence means "this process is part of a real
# multi-host job" — an init failure then must NOT silently degrade to
# single-process (each host would compute duplicated/wrong results).
_DIST_ENV_MARKERS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def _distributed_env_detected() -> bool:
    return any(os.environ.get(k) for k in _DIST_ENV_MARKERS)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize the multi-host JAX runtime; returns this process's index.

    The multi-host entry point (SURVEY.md §2.3/§5.8): each host process
    calls this ONCE before any jax computation, then builds meshes over
    `jax.devices()` (which now spans all hosts) via `make_mesh`.  Pass
    all three arguments (`coordinator_address` as `host:port`); nothing
    detects them on a GPU cluster.  Safe to call in single-process runs
    with no distributed environment: that is a no-op returning process 0.

    Failure policy: an init error is swallowed ONLY
    when the runtime is already initialized, or when nothing indicates a
    distributed job (no coordinator argument, no multi-process request,
    no coordinator env vars) — and even then a loud warning is emitted.
    In a detectable multi-host environment the error re-raises: silently
    degrading each host to single-process mode would duplicate work and
    corrupt results.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        if "already" in str(e):
            return jax.process_index()  # already initialized: benign
        wants_distributed = (
            coordinator_address is not None
            or num_processes not in (None, 1)
            or _distributed_env_detected()
        )
        if wants_distributed:
            raise
        warnings.warn(
            "jax.distributed.initialize failed with no distributed "
            f"environment detected ({e!r}); falling back to "
            "single-process mode (process_index=0)",
            RuntimeWarning,
            stacklevel=2,
        )
    return jax.process_index()


def make_mesh(
    chains: int = 1,
    data: int = 1,
    devices: Optional[Sequence] = None,
    platform: Optional[str] = None,
) -> Mesh:
    """Mesh with (chains, data) axes over the first chains*data devices."""
    validator.validate_positive(chains, "chains")
    validator.validate_positive(data, "data")
    if devices is None:
        devices = jax.devices(platform) if platform else jax.devices()
    need = chains * data
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for a {chains}x{data} mesh, have {len(devices)}"
        )
    arr = np.array(devices[:need]).reshape(chains, data)
    return Mesh(arr, (CHAINS, DATA))


def state_pspec(state) -> object:
    """PartitionSpec pytree for a chain-batched MixtureState.

    assignments [C, N] shard over (chains, data); every other leaf
    (counts, stats, hypers, cluster_hp) is chain-sharded, data-replicated
    — each data shard holds the full global suffstats (they are small:
    O(K · suffstat dim), kept consistent by `psum` over `data`).
    """
    import dataclasses

    def rep(tree):
        return jax.tree_util.tree_map(lambda _: P(CHAINS), tree)

    return dataclasses.replace(
        state,
        assignments=P(CHAINS, DATA),
        counts=P(CHAINS),
        cluster_hp=rep(state.cluster_hp),
        stats=rep(state.stats),
        hypers=rep(state.hypers),
    )


def data_pspec(data) -> tuple:
    """Columns shard their row axis over `data`; replicated over chains."""
    return tuple((P(DATA), P(DATA)) for _ in data)


def shard_state(mesh: Mesh, state, data):
    """Place a chain-batched state + data columns onto the mesh."""
    sspec = state_pspec(state)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    state = jax.tree_util.tree_map(put, state, sspec)
    data = tuple(
        (put(v, P(DATA)), put(m, P(DATA))) for (v, m) in data
    )
    return state, data
