"""Inference runner — kernel-config driven sweep loop.

Reference analog: the `runner` layer of the reference ecosystem
(`kernels:microscopes/kernels/runner.py` [MED]): takes a model definition,
a dataview, an initialized latent state and a *kernel config* — an ordered
list like ``[('assign', {}), ('grid_feature_hp', spec), ('theta', {})]`` —
and applies each kernel once per iteration.

Vectorized design: the whole iteration loop is one `lax.scan` under `jit`
(per-iteration keys via fold_in), optionally collecting the assignment
vector and joint score trace on-device; multi-chain execution is a `vmap`
over a batched state (see parallel/), not a multiprocessing pool.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from common_tpu import state as state_mod
from common_tpu import validator
from common_tpu.kernels import gibbs
from common_tpu.state import MixtureState


def _k_assign(state, data, key, **kw):
    return gibbs.assign_resample(state, data, key, m=kw.get("m", 1))


def _k_assign_resample(state, data, key, **kw):
    return gibbs.assign_resample(state, data, key, m=kw.get("m", 2))


def _k_assign_fixed(state, data, key, **kw):
    return gibbs.assign_resample(state, data, key, m=1)


def _k_assign_blocked(state, data, key, **kw):
    from common_tpu.kernels import blocked

    return blocked.sweep(state, data, key)


def _k_assign_blocked_fused(state, data, key, **kw):
    from common_tpu.kernels import blocked

    return blocked.sweep_fused(state, data, key, **kw)


def _k_grid_feature_hp(state, data, key, **kw):
    return gibbs.hp(state, kw["specs"], key)


def _k_grid_cluster_hp(state, data, key, **kw):
    return gibbs.cluster_hp(state, kw["prior"], kw["grid"], key)


def _k_ew_cluster_hp(state, data, key, **kw):
    return gibbs.cluster_hp_escobar_west(
        state, key, kw.get("a", 1.0), kw.get("b", 1.0)
    )


def _k_theta(state, data, key, **kw):
    return gibbs.theta(state, key)


def _k_slice_theta(state, data, key, **kw):
    from common_tpu.kernels import slice_ as slice_mod

    return slice_mod.theta(state, key, **kw)


def _k_slice_hp(state, data, key, **kw):
    from common_tpu.kernels import slice_ as slice_mod

    return slice_mod.hp(state, data, key, **kw)


def _k_nuts_hp(state, data, key, **kw):
    from common_tpu.kernels import hmc

    return hmc.hp(state, data, key, **kw)


def _k_nuts_cluster_hp(state, data, key, **kw):
    from common_tpu.kernels import hmc

    return hmc.cluster_hp(state, key, kw.pop("prior"), **kw)


def _k_nuts_theta(state, data, key, **kw):
    from common_tpu.kernels import hmc

    return hmc.theta(state, key, **kw)


def _k_split_merge(state, data, key, **kw):
    from common_tpu.kernels import splitmerge

    return splitmerge.moves(state, data, key, **kw)


KERNELS: Dict[str, Callable] = {
    "assign": _k_assign,
    "assign_resample": _k_assign_resample,
    "assign_fixed": _k_assign_fixed,
    "assign_blocked": _k_assign_blocked,
    "assign_blocked_fused": _k_assign_blocked_fused,
    "grid_feature_hp": _k_grid_feature_hp,
    "grid_cluster_hp": _k_grid_cluster_hp,
    "ew_cluster_hp": _k_ew_cluster_hp,
    "theta": _k_theta,
    "slice_theta": _k_slice_theta,
    "slice_hp": _k_slice_hp,
    "nuts_hp": _k_nuts_hp,
    "nuts_cluster_hp": _k_nuts_cluster_hp,
    "nuts_theta": _k_nuts_theta,
    "split_merge": _k_split_merge,
}


# ---------------------------------------------------------------------------
# state families: the runner drives mixture, HDP, and IRM states through the
# same kernel-config interface (reference runner parity for the lda/irm
# sibling repos).  Each family supplies its kernel registry + trace fns.
# ---------------------------------------------------------------------------
def _hdp_kernels() -> Dict[str, Callable]:
    from common_tpu.topic import hdp

    def k_assign(state, data, key, **kw):
        return hdp.collapsed_sweep(state, data, key)

    def k_blocked(state, data, key, **kw):
        return hdp.blocked_sweep(state, data, key)

    def k_beta(state, data, key, **kw):
        return hdp._sample_beta_jit(state, key, kw["max_count"])

    def k_conc(state, data, key, **kw):
        return hdp._sample_concentrations_jit(
            state, key, kw["max_count"],
            kw.get("a_alpha", 1.0), kw.get("b_alpha", 1.0),
            kw.get("a_gamma", 1.0), kw.get("b_gamma", 1.0),
        )

    return {"assign": k_assign, "assign_blocked": k_blocked,
            "beta": k_beta, "concentrations": k_conc}


def _irm_kernels() -> Dict[str, Callable]:
    from common_tpu.relational import kernels as irm_kernels

    def k_assign(state, data, key, **kw):
        if "domain" in kw:
            return irm_kernels.assign(state, data, key, domain=kw["domain"])
        return irm_kernels.assign_all(state, data, key)

    def k_blocked(state, data, key, **kw):
        return irm_kernels.sweep(state, data, key)

    def k_ew(state, data, key, **kw):
        return irm_kernels.domain_alpha_escobar_west(
            state, key, kw.get("a", 1.0), kw.get("b", 1.0)
        )

    def k_grid(state, data, key, **kw):
        return irm_kernels.domain_alpha_grid(
            state, kw["prior"], kw["grid"], key
        )

    return {"assign": k_assign, "assign_blocked": k_blocked,
            "ew_domain_alpha": k_ew, "grid_domain_alpha": k_grid}


def _device_arrays(data):
    return jax.tree_util.tree_map(jnp.asarray, data)


def _family_of(state):
    """(kernel registry, score_joint, counts, assignments, is_saturated,
    default-kw hook, data -> jit-argument pytree) for the state's family."""
    from common_tpu.relational.state import IRMState
    from common_tpu.topic.hdp import HDPState

    if isinstance(state, MixtureState):
        return dict(
            kernels=KERNELS,
            score_joint=state_mod.score_joint,
            counts=lambda st: st.counts,
            assignments=lambda st: st.assignments,
            is_saturated=state_mod.is_saturated,
            default_kw=lambda data: {},
            as_data=_device_arrays,
        )
    if isinstance(state, HDPState):
        from common_tpu.topic import hdp

        def default_kw(data):
            # static CRT cap: max tokens in any doc bounds every n_dk
            import numpy as np

            doc_ids = np.asarray(data.doc_ids)
            w = np.asarray(data.mask)
            lengths = np.bincount(doc_ids, weights=w) if doc_ids.size else [1]
            return {"max_count": max(int(np.max(lengths)), 1)}

        return dict(
            kernels=_hdp_kernels(),
            score_joint=hdp.score_joint,
            counts=lambda st: st.topic_total,
            assignments=lambda st: st.z,
            # transient nonzero counts on every truncation slot are normal
            # for blocked sweeps; the truncation only binds once the
            # remainder stick mass is exhausted too
            is_saturated=lambda st: jnp.logical_and(
                jnp.all(st.topic_total > 0), st.beta[-1] < 1e-3
            ),
            default_kw=default_kw,
            as_data=_device_arrays,
        )
    if isinstance(state, IRMState):
        from common_tpu.relational import state as irm_state

        return dict(
            kernels=_irm_kernels(),
            score_joint=irm_state.score_joint,
            # per-domain counts concatenated: k_active sums over domains
            counts=lambda st: jnp.concatenate(st.counts),
            assignments=lambda st: jnp.concatenate(st.assignments),
            is_saturated=lambda st: jnp.array(
                any(bool(jnp.all(c > 0)) for c in st.counts)
            ),
            default_kw=lambda data: {},
            as_data=irm_state.as_views,
        )
    raise TypeError(f"no runner family for state type {type(state).__name__}")


def normalize_config(
    kernel_config: Sequence, kernels: Optional[Dict[str, Callable]] = None
) -> Tuple[Tuple[str, dict], ...]:
    """Accept ['assign'] or [('assign', {...})] mixes (reference format)."""
    registry = KERNELS if kernels is None else kernels
    out: List[Tuple[str, dict]] = []
    for entry in kernel_config:
        if isinstance(entry, str):
            name, kw = entry, {}
        else:
            name, kw = entry
        validator.validate_one_of(name, registry, "kernel name")
        out.append((name, dict(kw)))
    return tuple(out)


def make_step(kernel_config: Sequence, data, family=None) -> Callable:
    """Compose a kernel config into one jit-able `step(state, data, key)`.

    `data` here only fills the family's default kernel arguments; the
    step takes the data as an argument, so under jit it is an input of
    the compiled program and not a constant baked into it (a 1 GB
    dataset would otherwise sit inside the executable)."""
    if family is None:
        config = normalize_config(kernel_config)
        kernels = KERNELS
    else:
        config = normalize_config(kernel_config, family["kernels"])
        defaults = family["default_kw"](data)
        config = tuple(
            (name, {**defaults, **kw}) for name, kw in config
        )
        kernels = family["kernels"]

    def step(state, data, key):
        for i, (name, kw) in enumerate(config):
            state = kernels[name](state, data, jax.random.fold_in(key, i), **kw)
        return state

    return step


@partial(
    jax.jit, static_argnames=("step", "trace_fn", "niters", "collect_assignments")
)
def _run_scan(state, data, key, step, trace_fn, niters, collect_assignments):
    def body(st, t):
        st = step(st, data, jax.random.fold_in(key, t))
        out = trace_fn(st, collect_assignments)
        return st, out

    return jax.lax.scan(body, state, jnp.arange(niters))


def _make_trace_fn(family):
    score_joint = family["score_joint"]
    counts = family["counts"]
    assignments = family["assignments"]

    def trace_fn(st, collect_assignments):
        c = counts(st)
        out = {
            "score": score_joint(st),
            "k_active": jnp.sum(c > 0),
            "counts": c,
        }
        if collect_assignments:
            out["assignments"] = assignments(st)
        return out

    return trace_fn


class runner:
    """Reference-parity runner: r = runner(defn, data, state, config);
    r.run(key, niters).  Traces (assignments, joint score) are collected
    on-device and exposed as host arrays.

    Drives any state family through its kernel registry: MixtureState
    (KERNELS above), HDPState (assign / assign_blocked / beta /
    concentrations), IRMState (assign / assign_blocked / ew_domain_alpha /
    grid_domain_alpha) — runner parity for the lda and irm sibling repos.

    jsonl_path: optional structured per-sweep observability (SURVEY.md
    §5.5 rebuild item) — one JSON line per sweep with the joint log-score,
    active-cluster count, occupancy histogram, and (on each run() call)
    running ESS/split-R̂ of the score trace.
    """

    def __init__(self, defn, data, state, kernel_config,
                 jsonl_path: str | None = None):
        self._defn = defn
        self._state = state
        self._family = _family_of(state)
        self._data = self._family["as_data"](data)
        self._config = normalize_config(
            kernel_config, self._family["kernels"]
        )
        self._step = make_step(self._config, data, self._family)
        self._trace_fn = _make_trace_fn(self._family)
        self._assign_width = int(
            self._family["assignments"](state).shape[0]
        )
        self._assignment_trace = []
        self._score_trace = []
        self._jsonl_path = jsonl_path
        self._sweep_idx = 0

    def run(self, key, niters: int = 1, collect: bool = True):
        validator.validate_positive(niters, "niters")
        self._state, trace = _run_scan(
            self._state, self._data, key, self._step, self._trace_fn,
            int(niters), collect,
        )
        if collect:
            import numpy as np

            self._assignment_trace.append(np.asarray(trace["assignments"]))
            self._score_trace.append(np.asarray(trace["score"]))
        if self._jsonl_path is not None:
            self._write_jsonl(trace)
        self._warn_if_saturated()
        return self._state

    def _write_jsonl(self, trace):
        import json

        import numpy as np

        from common_tpu.utils import diagnostics

        scores = np.asarray(trace["score"])
        k_active = np.asarray(trace["k_active"])
        counts = np.asarray(trace["counts"])
        full = self.score_trace
        ess = (
            float(diagnostics.ess(full)) if full.shape[-1] >= 4 else None
        )
        with open(self._jsonl_path, "a") as f:
            for i in range(scores.shape[0]):
                occ = counts[i][counts[i] > 0]
                f.write(json.dumps({
                    "sweep": self._sweep_idx,
                    "score_joint": float(scores[i]),
                    "k_active": int(k_active[i]),
                    "occupancy": np.sort(occ)[::-1].tolist(),
                    "ess": ess if i == scores.shape[0] - 1 else None,
                }) + "\n")
                self._sweep_idx += 1

    def _warn_if_saturated(self):
        import warnings

        if bool(self._family["is_saturated"](self._state)):
            warnings.warn(
                "all cluster/topic slots are occupied: the sampler can no "
                "longer open new groups and the truncation may bias the "
                "posterior. Re-pad the state (e.g. "
                "common_tpu.state.repad(state, new_k_max) for mixtures) "
                "and rebuild the runner.",
                RuntimeWarning,
                stacklevel=3,
            )

    def get_latent(self):
        return self._state

    @property
    def assignment_trace(self):
        import numpy as np

        return (
            np.concatenate(self._assignment_trace)
            if self._assignment_trace
            else np.zeros((0, self._assign_width), np.int32)
        )

    @property
    def score_trace(self):
        import numpy as np

        return (
            np.concatenate(self._score_trace)
            if self._score_trace
            else np.zeros((0,))
        )


def run_chain(state, data, key, niters, kernel_config, collect_assignments=True):
    """Functional one-shot: returns (final_state, trace dict of [T, ...])."""
    family = _family_of(state)
    data = family["as_data"](data)
    step = make_step(kernel_config, data, family)
    return _run_scan(
        state, data, key, step, _make_trace_fn(family), int(niters),
        collect_assignments,
    )
