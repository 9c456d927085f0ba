"""Scaling-efficiency measurement harness (BASELINE.md north star:
>= 0.8 sweeps/s efficiency from 1 chip to N).

`measure_row_scaling` times the data-sharded blocked-Gibbs sweep at a
ladder of shard counts on an explicit device list and reports

  throughput[s]  sweeps/s with the row axis sharded s ways
  efficiency     (throughput[max] / throughput[min]) / (max/min)

On real multi-device hardware this is the scaling measurement; on the
virtual 8-device CPU mesh (tests) the devices share physical cores, so
the number is a *plumbing + collective-overhead* check, not a hardware
claim.

Each timing compiles the sweep for that mesh once (excluded), then runs
`sweeps` sweeps inside one `lax.scan` dispatch, ending on
`block_until_ready`.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from common_tpu import models
from common_tpu import state as state_mod
from common_tpu import validator
from common_tpu.parallel import mesh as mesh_mod
from common_tpu.parallel import sharded


def _make_problem(n, d, k_max, key):
    defn = state_mod.model_definition(n, [models.niw(d)], k_max=k_max)
    kc, kz, kn = jax.random.split(key, 3)
    centers = 4.0 * jax.random.normal(kc, (8, d), jnp.float32)
    z = jax.random.randint(kz, (n,), 0, 8)
    x = centers[z] + jax.random.normal(kn, (n, d), jnp.float32)
    data = ((x, jnp.ones(n, jnp.float32)),)
    return defn, data


def _time_sharded_sweeps(mesh, defn, data, sweeps, key, repeats=3):
    """Compile a `sweeps`-sweep scan for this mesh; return per-repeat wall
    seconds (compile + one warm-up excluded).

    `repeats` timed executions: callers take the median and report the
    spread."""
    state = sharded.initialize_chains(
        defn, data, jax.random.split(key, 1), cluster_hp={"alpha": 1.0}
    )
    state, sdata = mesh_mod.shard_state(mesh, state, data)
    sweep = sharded.make_sharded_sweep(mesh, state, sdata)

    @jax.jit
    def run(state, key):
        def body(st, t):
            return sweep(st, sdata, jax.random.fold_in(key, t)), None

        return jax.lax.scan(body, state, jnp.arange(sweeps))[0]

    # compile + one warm-up execution (buffer/layout costs)
    jax.block_until_ready(run(state, key))

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, key))
        times.append(time.perf_counter() - t0)
    return times


def measure_row_scaling(
    n: int = 65536,
    d: int = 16,
    k_max: int = 16,
    sweeps: int = 8,
    shard_counts: Sequence[int] = (1, 2, 4, 8),
    devices: Optional[Sequence] = None,
    seed: int = 0,
    repeats: int = 3,
) -> Dict:
    """Sweeps/s of the data-sharded blocked sweep at each shard count.

    Returns {"throughput": {s: median sweeps_per_s}, "spread": {s:
    (max-min)/median over `repeats` timed runs}, "efficiency": float,
    "shard_counts": [...], "n": n, "d": d, "k_max": k_max}.
    Rows must divide evenly into every shard count (n is rounded up).
    """
    validator.validate_nonempty(shard_counts, "shard_counts")
    if devices is None:
        devices = jax.devices()
    shard_counts = sorted(int(s) for s in shard_counts)
    if len(devices) < shard_counts[-1]:
        raise ValueError(
            f"need {shard_counts[-1]} devices, have {len(devices)}"
        )
    lcm = int(np.lcm.reduce(shard_counts))
    n = -(-n // lcm) * lcm

    defn, data = _make_problem(n, d, k_max, jax.random.key(seed))
    throughput = {}
    spread = {}
    for s in shard_counts:
        mesh = mesh_mod.make_mesh(chains=1, data=s, devices=devices[:s])
        times = _time_sharded_sweeps(
            mesh, defn, data, sweeps, jax.random.key(seed + 1),
            repeats=repeats,
        )
        med = float(np.median(times))
        throughput[s] = sweeps / med
        spread[s] = round((max(times) - min(times)) / med, 3)

    lo, hi = shard_counts[0], shard_counts[-1]
    efficiency = (throughput[hi] / throughput[lo]) / (hi / lo)
    return {
        "throughput": {s: round(v, 4) for s, v in throughput.items()},
        "spread": spread,
        "efficiency": round(float(efficiency), 4),
        # every rung compiled, ran its collectives, and produced finite
        # positive throughput — on a VIRTUAL (core-sharing) mesh this
        # boolean plus the raw throughputs is the honest result; the
        # `efficiency` ratio is only a hardware claim on a real
        # multi-device mesh
        "collectives_ok": bool(
            all(np.isfinite(v) and v > 0 for v in throughput.values())
        ),
        "shard_counts": shard_counts,
        "n": n,
        "d": d,
        "k_max": k_max,
        "sweeps": sweeps,
        "repeats": repeats,
    }
