#!/usr/bin/env python
"""Benchmark: blocked-Gibbs sweeps/s and ESS/s on a large DPMM (BASELINE.md).

One process on one GPU.  It refuses to run anywhere else: a benchmark that
finds no GPU exits non-zero and prints no result.  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", ...per-tier records};
if any tier it ran failed, it still prints the line (the failure is in
`errors`) and then exits non-zero.

Tiers, in order:

  ladder      DPMM-NIW blocked sweeps up to the 1M x 256, K_max = 64
              headline, then the fused-kernel sweep at the top shape
  ess         multi-seed >= 300-sweep ESS/s at the top shape, with the
              held-out predictive
  hdp         HDP-LDA dense blocked sweeps, 1M docs x 50 tokens, with
              held-out perplexity
  chains      on-card chain scaling (65k x 16) and C = 4 chains at the
              headline shape
  config2     bbv DPMM + slice hypers (100k x 64)
  config3     mixed NIW + GP + BB + NUTS hypers (100k)
  smc         block-SMC at 1M x 256, P = 16
  sm_ab       split-merge A/B on ESS/s (100k x 64)

Every time ends on `block_until_ready` and is the median of repeats after
a warm-up.  The share of peak is the time the counted matmuls would take
at the card's peaks, each at the precision it runs in, over the time
measured (`PEAKS`, keyed by device_kind; an unknown card is an error).
The compile cache follows
`common_tpu.utils.compile_cache`.

vs_baseline: the reference (datamicroscopes) publishes no numbers
(BASELINE.md), so the baseline is its *architecture* — a per-row collapsed
Gibbs sweep (sequential rows, per-cluster NIW predictive via Cholesky) in
vectorized numpy on the host, median of 5 fixed-budget replicates, scaled
to the full N (per-row cost is N-independent).

Usage: python bench.py [--smoke] [--tiers ladder,ess,...] [--skip-baseline]
                       [--n N --d D --k K --sweeps S]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

TIERS = ("ladder", "ess", "hdp", "chains", "config2", "config3", "smc",
         "sm_ab")

# Dense matmul peaks per second, by jax device_kind (NVIDIA's H100 SXM
# data sheet), at the precisions a sweep's matmuls run in: the score is a
# default-precision f32 product, which XLA runs in TF32; the restat runs
# as three bf16 passes (`niw.scatter_product`).
PEAKS = {"NVIDIA H100 80GB HBM3": {"tf32": 495e12, "bf16": 989e12}}


def peak_flops(device_kind: str) -> dict:
    """The card's entry of PEAKS; an unknown card is an error."""
    if device_kind not in PEAKS:
        raise ValueError(
            f"no peak FLOP/s on record for device_kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        )
    return PEAKS[device_kind]


def card_info() -> str:
    """`name, power.limit` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def timed(fn, *args, repeats=3):
    """(median seconds, all seconds, last output) of `repeats` calls after
    one warm-up call; every call ends on block_until_ready."""
    import jax
    import numpy as np

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times, out


def compile_seconds(jitted, *args):
    """(compiled program, seconds to lower and compile it)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def make_data_device(key, n, d, n_true=8):
    """Synthesize a Gaussian-mixture row block on the device (jitted)."""
    import jax
    import jax.numpy as jnp

    kc, kz, kn = jax.random.split(key, 3)
    centers = 4.0 * jax.random.normal(kc, (n_true, d), jnp.float32)
    z = jax.random.randint(kz, (n,), 0, n_true)
    return centers[z] + jax.random.normal(kn, (n, d), jnp.float32)


def niw_hyper(d):
    import jax.numpy as jnp

    return {"mu0": jnp.zeros(d, jnp.float32), "kappa": 1.0,
            "psi": jnp.eye(d, dtype=jnp.float32), "nu": float(d + 2)}


# ---------------------------------------------------------------------------
# problems: data, model and initial state of each family at a given size,
# shared by the tiers below and by chip_smoke.py
# ---------------------------------------------------------------------------
def niw_mixture(key, n, d, k_max, heldout=0):
    """DPMM-NIW on an n x d Gaussian mixture: (defn, data, initial state,
    `heldout` more rows of the same mixture)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import models
    from common_tpu import state as st

    x_all = make_data_device(jax.random.fold_in(key, 0), n + heldout, d)
    data = ((x_all[:n], jnp.ones(n, jnp.float32)),)
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    # a float32 alpha: the sampled alpha is float32, so a weakly typed
    # initial one would compile a runner's scan a second time
    s = st.initialize(defn, data, jax.random.fold_in(key, 1),
                      cluster_hp={"alpha": np.float32(1.0)},
                      feature_hps=[niw_hyper(d)])
    return defn, data, s, x_all[n:]


def smc_problem(key, n, d, k_max, n_particles, heldout=0):
    """Block-SMC over an n x d Gaussian mixture: (data, particles,
    `heldout` more rows)."""
    import jax
    import jax.numpy as jnp

    from common_tpu import models
    from common_tpu import state as st
    from common_tpu.kernels import smc

    x_all = make_data_device(jax.random.fold_in(key, 0), n + heldout, d)
    data = ((x_all[:n], jnp.ones(n, jnp.float32)),)
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    parts = smc.init_particles(defn, data, jax.random.fold_in(key, 1),
                               n_particles, cluster_hp={"alpha": 1.0},
                               feature_hps=[niw_hyper(d)])
    return data, parts, x_all[n:]


def config2_problem(key, n, d, k_max, heldout=0):
    """BASELINE config 2: Beta-Bernoulli DPMM on an [n, d] binary matrix
    (one bbv feature).  Returns (defn, data, initial state, held-out rows,
    the slice sampler's arguments)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import models, scalar_functions
    from common_tpu import state as st

    @jax.jit
    def gen(k):
        kp, kz, kx = jax.random.split(k, 3)
        probs = jax.random.beta(kp, 0.5, 0.5, (8, d))
        z = jax.random.randint(kz, (n + heldout,), 0, 8)
        return jax.random.bernoulli(kx, probs[z]).astype(jnp.float32)

    x_all = gen(jax.random.fold_in(key, 0))
    data = ((x_all[:n], jnp.ones(n, jnp.float32)),)
    defn = st.model_definition(n, [models.bbv(d)], k_max=k_max)
    state = st.initialize(
        defn, data, jax.random.fold_in(key, 1),
        cluster_hp={"alpha": np.float32(1.0)},
        feature_hps=[{"alpha": jnp.ones(d), "beta": jnp.ones(d)}],
    )
    # moderate bounds: with the uncollapsed sweep, slice-adapted
    # per-column hypers below ~0.5 make empty-slot prior draws extreme
    # and the truncated sampler collapses to one cluster
    exp1 = scalar_functions.log_exponential(1.0)
    slice_kw = {
        "specs": {0: {p: {"prior": exp1, "w": 0.5, "bounds": (0.5, 50.0)}
                      for p in ("alpha", "beta")}},
        "cluster": {"prior": exp1, "w": 0.5, "bounds": (1e-4, 1e4)},
    }
    return defn, data, state, x_all[n:], slice_kw


def config3_problem(key, n, k_max, heldout=0, d_niw=16):
    """BASELINE config 3: mixed-likelihood DPMM (NIW + GammaPoisson +
    BetaBernoulli columns).  Returns (defn, data, held-out data, initial
    state, hyperpriors of features 1 and 2, the CRP concentration's
    prior)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import models, scalar_functions
    from common_tpu import state as st

    @jax.jit
    def gen(k):
        kx, kc, kp, kb = jax.random.split(k, 4)
        nh = n + heldout  # trailing rows held out (same mixture)
        z = jax.random.randint(kc, (nh,), 0, 8)
        centers = 4.0 * jax.random.normal(jax.random.fold_in(kc, 1), (8, d_niw))
        xg = centers[z] + jax.random.normal(kx, (nh, d_niw))
        rates = jnp.exp(jax.random.normal(jax.random.fold_in(kp, 1), (8,)))
        xp = jax.random.poisson(kp, rates[z], (nh,)).astype(jnp.float32)
        pb = jax.random.beta(jax.random.fold_in(kb, 1), 0.5, 0.5, (8,))
        xb = jax.random.bernoulli(kb, pb[z], (nh,)).astype(jnp.float32)
        return xg, xp, xb

    cols = gen(jax.random.fold_in(key, 0))
    data = tuple((c[:n], jnp.ones(n, jnp.float32)) for c in cols)
    held = tuple((c[n:], jnp.ones(heldout, jnp.float32)) for c in cols)
    defn = st.model_definition(
        n, [models.niw(d_niw), models.gp, models.bb], k_max=k_max)
    state = st.initialize(
        defn, data, jax.random.fold_in(key, 1),
        cluster_hp={"alpha": np.float32(1.0)},
        feature_hps=[niw_hyper(d_niw), {"alpha": 1.0, "inv_beta": 1.0},
                     {"alpha": 1.0, "beta": 1.0}],
    )
    exp1 = scalar_functions.log_exponential(1.0)
    priors = {1: lambda h: exp1(h["alpha"]) + exp1(h["inv_beta"]),
              2: lambda h: exp1(h["alpha"]) + exp1(h["beta"])}
    return defn, data, held, state, priors, exp1


def hdp_problem(key, n_docs, doc_len, vocab, k_topics, heldout_frac=0.0):
    """HDP-LDA on equal-length docs whose words come from one of 4
    vocabulary blocks; `heldout_frac` of the token positions are masked
    out.  Returns (words, mask, held-out indicator, initial state)."""
    import jax
    import jax.numpy as jnp

    from common_tpu import topic

    kb = 4  # true topic blocks

    @jax.jit
    def gen(key):
        topic_of_doc = jnp.arange(n_docs, dtype=jnp.int32) % kb
        block = vocab // kb
        w = topic_of_doc[:, None] * block + jax.random.randint(
            key, (n_docs, doc_len), 0, block, jnp.int32)
        held = (jax.random.uniform(jax.random.fold_in(key, 1),
                                   (n_docs, doc_len)) < heldout_frac)
        return w, held.astype(jnp.float32)

    words, held = gen(jax.random.fold_in(key, 0))
    mask = 1.0 - held
    state = topic.initialize(topic.dense_token_data(words, mask), k_topics,
                             vocab, jax.random.fold_in(key, 1), n_docs=n_docs)
    return words, mask, held, state


def heldout_predictive(state, xh):
    """Mean posterior-predictive log-lik of held-out rows (BASELINE quality
    metric), outside any timed region."""
    import jax
    import jax.numpy as jnp

    from common_tpu import state as st

    lp = jax.jit(lambda s, xh: jnp.mean(st.heldout_logp(
        s, ((xh, jnp.ones(xh.shape[0], jnp.float32)),))))(state, xh)
    lp = float(lp)
    return {"heldout_rows": int(xh.shape[0]), "mean_logp": round(lp, 4),
            "per_dim": round(lp / xh.shape[1], 5)}


def build_tier_fn(n, d, k_max, sweeps, kernel="blocked", heldout=0,
                  multi_stat=False):
    """Compiled (datagen → init → S sweeps + score trace) programs.

    kernel: "blocked" (XLA path), "fused" (the fused assign kernel — the
    [N, K] table never touches HBM) or "fused+sm" / "blocked+sm" (that
    sweep chased by Jain-Neal split-merge moves).

    heldout > 0 additionally generates `heldout` rows from the SAME
    mixture for posterior-predictive scoring.  multi_stat=True makes the
    per-sweep trace a [sweeps, 2] stack of (score_joint, k_active)."""
    import jax
    import jax.numpy as jnp

    from common_tpu import state as st
    from common_tpu.kernels import blocked, splitmerge

    sweep = blocked.sweep_fused if kernel.startswith("fused") else blocked.sweep

    def setup(key):
        _, data, s, xh = niw_mixture(key, n, d, k_max, heldout)
        return data, s, xh

    def run(data, s, key):
        def body(state, t):
            kt = jax.random.fold_in(key, t)
            state = sweep(state, data, kt)
            if kernel.endswith("+sm"):
                state = splitmerge.moves(state, data, jax.random.fold_in(kt, 1),
                                         n_moves=2, t_scans=3)
            score = st.score_joint(state)
            if multi_stat:
                k_act = jnp.sum(state.counts > 0).astype(jnp.float32)
                return state, jnp.stack([score, k_act])
            return state, score

        return jax.lax.scan(body, s, jnp.arange(sweeps))

    return jax.jit(setup), jax.jit(run)


def _capped_ess(trace, n_samples):
    """Bulk ESS capped at the kept sample count, after a 20% burn-in
    discard; None for traces under 20 samples (no information there)."""
    import numpy as np

    from common_tpu.utils import diagnostics

    if n_samples < 20:
        return None
    kept = trace[int(0.2 * len(trace)):]
    e = float(diagnostics.ess(kept - kept.mean()))
    if not np.isfinite(e):
        return None
    return min(e, float(len(kept)))


def run_tier(n, d, k_max, sweeps, key, peaks, kernel="blocked", heldout=0,
             repeats=3):
    """One ladder rung: median sweeps/s over `repeats` timed scans.

    `peaks`: the card's entry of PEAKS.  The share of peak is the time the
    sweep's matmuls would take at peak over the time measured: the score
    ([N, K], 2·N·K·D²) at the TF32 rate, the restat (2·N·K·D²) as three
    bf16 passes (`niw.scatter_product`)."""
    import jax
    import numpy as np

    setup, run = build_tier_fn(n, d, k_max, sweeps, kernel, heldout)
    t0 = time.perf_counter()
    data, s, xh = jax.block_until_ready(setup(key))
    setup_s = time.perf_counter() - t0
    compiled, compile_s = compile_seconds(run, data, s, key)
    dt, times, (s_out, trace) = timed(compiled, data, s, key, repeats=repeats)

    trace = np.asarray(trace, np.float64)
    ess_est = _capped_ess(trace, sweeps)
    half = 2.0 * n * k_max * d * d  # the score's FLOPs, and the restat's
    tflops = 2.0 * half * sweeps / dt / 1e12
    t_peak = half / peaks["tf32"] + 3.0 * half / peaks["bf16"]
    return {
        "n": n, "d": d, "k_max": k_max, "kernel": kernel, "sweeps": sweeps,
        "sweeps_per_s": round(sweeps / dt, 4),
        "run_s": [round(t, 4) for t in times],
        "compile_s": round(compile_s, 2), "setup_s": round(setup_s, 2),
        "ess_est": None if ess_est is None else round(ess_est, 2),
        "ess_per_s": None if ess_est is None else round(ess_est / dt, 4),
        "tflops": round(tflops, 2),
        "tflops_share_of_peak": round(t_peak * sweeps / dt, 4),
        "k_active": int(np.sum(np.asarray(s_out.counts) > 0)),
        "score_final": float(trace[-1]),
        "predictive": heldout_predictive(s_out, xh) if heldout else None,
    }


def run_ess_tier(n, d, k_max, key, sweeps=300, n_seeds=2, kernel="blocked",
                 heldout=4096):
    """ESS/s with its spread: n_seeds independent chains (fresh data +
    init per seed), each one `sweeps`-sweep compiled scan recording
    (score_joint, k_active).  Per seed: ESS per statistic (20% burn-in,
    capped), the conservative minimum, over that seed's wall time.
    Published: the mean and spread of ess_per_s over seeds."""
    import jax
    import numpy as np

    setup, run = build_tier_fn(n, d, k_max, sweeps, kernel, heldout,
                               multi_stat=True)
    data, s, xh = setup(jax.random.fold_in(key, 0))
    compiled, compile_s = compile_seconds(run, data, s, key)

    seeds_out = []
    s_out = None
    for i in range(n_seeds):
        ki = jax.random.fold_in(key, 100 + i)
        if i > 0:
            data, s, xh = jax.block_until_ready(setup(ki))
        t0 = time.perf_counter()
        s_out, trace = jax.block_until_ready(compiled(data, s, ki))
        dt = time.perf_counter() - t0
        trace = np.asarray(trace, np.float64)          # [sweeps, 2]
        ess_by_stat = {}
        for name, tr in (("score_joint", trace[:, 0]),
                         ("k_active", trace[:, 1])):
            # a constant trace carries no autocorrelation information
            ess_by_stat[name] = (None if np.ptp(tr) == 0.0
                                 else _capped_ess(tr, sweeps))
        finite = [v for v in ess_by_stat.values() if v is not None]
        ess_min = min(finite) if finite else None
        seeds_out.append({
            "run_s": round(dt, 3),
            "sweeps_per_s": round(sweeps / dt, 4),
            "ess_by_stat": {k: None if v is None else round(v, 2)
                            for k, v in ess_by_stat.items()},
            "ess_min": None if ess_min is None else round(ess_min, 2),
            "ess_per_s": None if ess_min is None else round(ess_min / dt, 4),
            "k_active": int(np.sum(np.asarray(s_out.counts) > 0)),
            "score_final": float(trace[-1, 0]),
        })

    vals = [so["ess_per_s"] for so in seeds_out if so["ess_per_s"] is not None]
    return {
        "n": n, "d": d, "k_max": k_max, "kernel": kernel, "sweeps": sweeps,
        "n_seeds": n_seeds,
        "sweeps_per_s": round(sweeps / float(np.mean(
            [so["run_s"] for so in seeds_out])), 4),
        "compile_s": round(compile_s, 2),
        "seeds": seeds_out,
        "ess_per_s": round(float(np.mean(vals)), 4) if vals else None,
        "ess_per_s_spread": (round(float(max(vals) - min(vals)), 4)
                             if len(vals) > 1 else None),
        "predictive": (heldout_predictive(s_out, xh) if heldout else None),
    }


def _init_chains(defn, data, d, key, c):
    import jax
    import numpy as np

    from common_tpu import state as st

    return jax.jit(jax.vmap(lambda k: st.initialize(
        defn, data, k, cluster_hp={"alpha": np.float32(1.0)},
        feature_hps=[niw_hyper(d)])))(jax.random.split(key, c))


def _chains_program(sweeps):
    import jax
    import jax.numpy as jnp

    from common_tpu.kernels import blocked

    def run(states, data, key):
        def body(ss, t):
            return blocked.sweep_chains(ss, data,
                                        jax.random.fold_in(key, t)), None

        return jax.lax.scan(body, states, jnp.arange(sweeps))[0]

    return jax.jit(run)


def run_chain_scaling_tier(key, n=65536, d=16, k_max=16, sweeps=40,
                           chain_counts=(1, 2, 4), repeats=3):
    """Chain scaling on one card: total chain-sweeps/s at C = 1, 2, 4 chains
    at fixed per-chain work (`blocked.sweep_chains`, which folds the chain
    axis into the matmul K-dimension at this shape).  Per-sweep cost is
    fitted as t(C) = latency + per_chain·C."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import models
    from common_tpu import state as st

    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    x = make_data_device(jax.random.fold_in(key, 0), n, d)
    data = ((x, jnp.ones(n, jnp.float32)),)
    run = _chains_program(sweeps)
    throughput = {}
    for c in chain_counts:
        states = _init_chains(defn, data, d, jax.random.fold_in(key, c), c)
        dt, _, _ = timed(run, states, data, key, repeats=repeats)
        throughput[c] = c * sweeps / dt

    cs = sorted(chain_counts)
    lo, hi = cs[0], cs[-1]
    t_ms = [c / throughput[c] * 1e3 for c in cs]  # ms per sweep
    A = np.stack([np.ones(len(cs)), np.asarray(cs, float)], axis=1)
    (lat_ms, per_chain_ms), *_ = np.linalg.lstsq(A, np.asarray(t_ms),
                                                 rcond=None)
    return {
        "mode": "sweep_chains (wide-matmul chain batching), one card",
        "n": n, "d": d, "k_max": k_max, "sweeps": sweeps,
        "chain_sweeps_per_s": {str(c): round(v, 2)
                               for c, v in throughput.items()},
        "efficiency": round((throughput[hi] / throughput[lo]) / (hi / lo), 4),
        "sweep_ms_model": {"latency_ms": round(float(lat_ms), 3),
                           "per_chain_ms": round(float(per_chain_ms), 3)},
    }


def run_chains_headline_tier(key, n, d, k_max, chain_counts=(4,), sweeps=5,
                             repeats=3):
    """Multi-chain throughput at the headline shape: C chains through
    `sweep_chains`, which runs vmapped per-chain sweeps there (the [N, D²]
    wide-matmul features are over budget)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import models
    from common_tpu import state as st

    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    x = make_data_device(jax.random.fold_in(key, 0), n, d)
    data = ((x, jnp.ones(n, jnp.float32)),)
    run = _chains_program(sweeps)
    out_by_c = {}
    for c in chain_counts:
        states = _init_chains(defn, data, d, jax.random.fold_in(key, c), c)
        compiled, compile_s = compile_seconds(run, states, data, key)
        dt, _, out = timed(compiled, states, data, key, repeats=repeats)
        agg = c * sweeps / dt
        out_by_c[str(c)] = {
            "aggregate_chain_sweeps_per_s": round(agg, 3),
            "per_chain_sweeps_per_s": round(agg / c, 3),
            "compile_s": round(compile_s, 2),
            "k_active_per_chain": [
                int(v) for v in (np.asarray(out.counts) > 0).sum(-1)],
        }
    return {"mode": "vmapped per-chain sweeps via sweep_chains",
            "n": n, "d": d, "k_max": k_max, "sweeps": sweeps,
            "chains": out_by_c}


def run_config2_tier(key, n=100_000, d=64, k_max=32, sweeps=8, heldout=4096):
    """BASELINE config 2: Beta-Bernoulli DPMM on an [n, d] binary matrix
    (one bbv feature), blocked sweep + coordinate-wise slice sampling of
    the per-column (alpha, beta) hypers and the CRP concentration, as one
    compiled scan; held-out rows scored under the final state."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import state as st
    from common_tpu.kernels import blocked, slice_

    _, data, state, xh, slice_kw = config2_problem(key, n, d, k_max, heldout)

    def run(state, data, key):
        def body(s, t):
            kt = jax.random.fold_in(key, t)
            s = blocked.sweep(s, data, jax.random.fold_in(kt, 0))
            s = slice_._hp_impl(s, jax.random.fold_in(kt, 1), **slice_kw)
            return s, st.score_joint(s)

        return jax.lax.scan(body, state, jnp.arange(sweeps))

    kv = jax.random.fold_in(key, 2)
    compiled, compile_s = compile_seconds(jax.jit(run), state, data, kv)
    dt, _, (out, trace) = timed(compiled, state, data, kv)
    return {
        "config": "2: bb-dpmm + slice hp",
        "n": n, "d": d, "k_max": k_max, "sweeps": sweeps,
        "sweeps_per_s": round(sweeps / dt, 3),
        "compile_s": round(compile_s, 2),
        "k_active": int(np.sum(np.asarray(out.counts) > 0)),
        "alpha": float(out.cluster_hp["alpha"]),
        "score_final": float(np.asarray(trace)[-1]),
        "predictive": heldout_predictive(out, xh) if heldout else None,
    }


def run_config3_tier(key, n=100_000, k_max=32, sweeps=4):
    """BASELINE config 3: mixed-likelihood DPMM (NIW + GammaPoisson +
    BetaBernoulli columns) with NUTS on the non-conjugate hyperpriors,
    one compiled scan of (blocked sweep + NUTS hp + NUTS cluster_hp)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import state as st
    from common_tpu.kernels import blocked, hmc

    held = 2048
    _, data, held_data, state, priors, exp1 = config3_problem(
        key, n, k_max, held)

    def run(state, data, key):
        def body(s, t):
            kt = jax.random.fold_in(key, t)
            s = blocked.sweep(s, data, jax.random.fold_in(kt, 0))
            s = hmc.hp(s, data, jax.random.fold_in(kt, 1), priors,
                       num_steps=2, max_depth=5)
            s = hmc.cluster_hp(s, jax.random.fold_in(kt, 2), exp1,
                               num_steps=2, max_depth=5)
            return s, st.score_joint(s)

        return jax.lax.scan(body, state, jnp.arange(sweeps))

    kv = jax.random.fold_in(key, 2)
    compiled, compile_s = compile_seconds(jax.jit(run), state, data, kv)
    dt, _, (out, trace) = timed(compiled, state, data, kv)
    mean_lp = float(jax.jit(lambda s: jnp.mean(st.heldout_logp(s, held_data)))(out))
    return {
        "config": "3: mixed niw+gp+bb + NUTS hp",
        "n": n, "features": ["niw16", "gp", "bb"], "k_max": k_max,
        "sweeps": sweeps, "sweeps_per_s": round(sweeps / dt, 3),
        "compile_s": round(compile_s, 2),
        "k_active": int(np.sum(np.asarray(out.counts) > 0)),
        "score_final": float(np.asarray(trace)[-1]),
        "alpha": float(out.cluster_hp["alpha"]),
        "predictive": {"heldout_rows": held, "mean_logp": round(mean_lp, 4)},
    }


def run_hdp_tier(n_docs, doc_len, k_topics, vocab, sweeps, key,
                 doc_chunk=20_000, heldout_frac=0.01):
    """HDP-LDA dense blocked sweeps on an n_docs-doc synthetic corpus
    (equal-length docs, topic-block vocabulary), one compiled scan of
    (sweep + beta resample); heldout_frac of the token positions is held
    out and scored as per-token perplexity after a few more sweeps."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import topic

    T = n_docs * doc_len
    words, mask, held, state = hdp_problem(key, n_docs, doc_len, vocab,
                                           k_topics, heldout_frac)

    def run(state, words, mask, key):
        def body(st, t):
            kt = jax.random.fold_in(key, t)
            st = topic.blocked_sweep_dense(st, words, mask,
                                           jax.random.fold_in(kt, 0),
                                           doc_chunk=doc_chunk)
            st = topic.hdp._sample_beta_jit(st, jax.random.fold_in(kt, 1),
                                            doc_len)
            return st, topic.score_joint(st)

        return jax.lax.scan(body, state, jnp.arange(sweeps))

    compiled, compile_s = compile_seconds(jax.jit(run), state, words, mask, key)
    dt, _, (out, trace) = timed(compiled, state, words, mask, key)

    # a few more sweeps of the compiled program (outside the timed
    # region) so the perplexity reflects a usable posterior
    for c in range(5):
        out, _ = compiled(out, words, mask, jax.random.fold_in(key, 50 + c))
    idx = np.nonzero(np.asarray(held).reshape(-1) > 0)[0]
    held_td = topic.TokenData(
        jnp.asarray(np.asarray(words).reshape(-1)[idx]),
        jnp.asarray((idx // doc_len).astype(np.int32)),
        jnp.ones(len(idx), jnp.float32),
    )
    ppl = float(jax.jit(topic.perplexity)(out, held_td))
    return {
        "n_docs": n_docs, "tokens": T, "k_topics": k_topics, "vocab": vocab,
        "sweeps": sweeps, "sweeps_per_s": round(sweeps / dt, 3),
        "tokens_per_s": round(T * sweeps / dt, 0),
        "compile_s": round(compile_s, 2),
        "k_active": int(out.active_topics()),
        "score_final": float(np.asarray(trace)[-1]),
        "predictive": {"heldout_tokens": int(len(idx)),
                       "perplexity": round(ppl, 2),
                       "random_perplexity": vocab},
    }


def run_smc_tier(n, d, k_max, n_particles, key, block=8192, warmup=128):
    """Block-SMC rows/s (O(N/B) device steps), with the evidence estimate's
    health and the particle-cloud held-out predictive."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.scipy.special import logsumexp

    from common_tpu import state as st
    from common_tpu.kernels import smc

    h = 2048  # held-out rows from the same mixture
    data, parts, xh = smc_problem(key, n, d, k_max, n_particles, h)
    k2 = jax.random.fold_in(key, 2)
    t0 = time.perf_counter()
    compiled = smc.run_blocked.lower(parts, data, k2, block=block,
                                     warmup=warmup).compile()
    compile_s = time.perf_counter() - t0
    dt, _, res = timed(compiled, parts, data, k2, repeats=1)

    ess_trace = np.asarray(res.ess_trace)
    n_collapsed = int((ess_trace < 2.0).sum())

    @jax.jit
    def cloud_lp(parts_out, log_w, xh):
        held_ = ((xh, jnp.ones(h, jnp.float32)),)
        lw = jax.nn.log_softmax(log_w)
        lp = jax.vmap(lambda i: st.heldout_logp(
            jax.tree_util.tree_map(lambda l: l[i], parts_out), held_)
        )(jnp.arange(log_w.shape[0]))                          # [P, h]
        return jnp.mean(logsumexp(lw[:, None] + lp, axis=0))

    mean_lp = float(cloud_lp(res.particles, res.log_w, xh))
    return {
        "mode": "block-smc", "n": n, "d": d, "k_max": k_max,
        "particles": n_particles, "block": block, "warmup_rows": warmup,
        "rows_per_s": round(n / dt, 1), "run_s": round(dt, 3),
        "compile_s": round(compile_s, 2),
        "logz": float(res.logz),
        "logz_health": {
            "min_step_ess": round(float(ess_trace.min()), 2),
            "median_step_ess": round(float(np.median(ess_trace)), 2),
            "steps_ess_lt2": n_collapsed, "steps": int(ess_trace.size),
            # weights collapsed at more than half the steps
            "logz_degenerate": bool(n_collapsed > 0.5 * ess_trace.size),
        },
        "n_resamples": int(res.n_resamples),
        "predictive": {"heldout_rows": h, "mean_logp": round(mean_lp, 4),
                       "per_dim": round(mean_lp / d, 5)},
    }


def numpy_collapsed_rows_per_s(d, k_active, budget_s=2.5, seed=0,
                               replicates=5):
    """Reference-architecture baseline: sequential per-row collapsed Gibbs
    in numpy on the host (SURVEY.md §3.2's hot loop): remove row → score
    all active clusters + 1 empty (NIW Student-t predictive via Cholesky)
    → categorical draw → add row.  Returns (median, min, max) rows/s over
    `replicates` fixed-budget measurements."""
    import numpy as np
    from numpy.linalg import cholesky, slogdet
    from scipy.special import gammaln

    def one(seed):
        rng = np.random.default_rng(seed)
        m = 512
        sub = rng.normal(size=(m, d))
        alpha, kappa0, nu0 = 1.0, 1.0, d + 2.0
        mu0, psi0 = np.zeros(d), np.eye(d)
        z = rng.integers(0, k_active, size=m)
        stats = {}
        for k in range(k_active):
            rows = sub[z == k]
            stats[k] = [len(rows), rows.sum(0), rows.T @ rows]

        def pred_logpdf_all(x, ks):
            out = np.empty(len(ks))
            for i, k in enumerate(ks):
                cnt, sx, sxx = stats.get(k, [0, np.zeros(d), np.zeros((d, d))])
                kn, nun = kappa0 + cnt, nu0 + cnt
                mun = (kappa0 * mu0 + sx) / kn
                psin = (psi0 + sxx + kappa0 * np.outer(mu0, mu0)
                        - kn * np.outer(mun, mun))
                df = nun - d + 1
                S = psin * (kn + 1) / (kn * df)
                y = np.linalg.solve(cholesky(S), x - mun)
                out[i] = (gammaln((df + d) / 2) - gammaln(df / 2)
                          - 0.5 * d * (np.log(df) + np.log(np.pi))
                          - slogdet(S)[1] / 2
                          - 0.5 * (df + d) * np.log1p(y @ y / df))
            return out

        t0 = time.perf_counter()
        rows_done = 0
        while time.perf_counter() - t0 < budget_s:
            i = rows_done % m
            xi, k_old = sub[i], z[i]
            st_ = stats[k_old]
            st_[0] -= 1
            st_[1] = st_[1] - xi
            st_[2] = st_[2] - np.outer(xi, xi)
            if st_[0] == 0:
                del stats[k_old]
            ks = list(stats) + [max(stats, default=-1) + 1]
            crp = np.array([np.log(stats[k][0]) for k in ks[:-1]]
                           + [np.log(alpha)])
            logp = crp + pred_logpdf_all(xi, ks)
            p = np.exp(logp - logp.max())
            knew = ks[rng.choice(len(ks), p=p / p.sum())]
            stn = stats.setdefault(knew, [0, np.zeros(d), np.zeros((d, d))])
            stn[0] += 1
            stn[1] = stn[1] + xi
            stn[2] = stn[2] + np.outer(xi, xi)
            z[i] = knew
            rows_done += 1
        return rows_done / (time.perf_counter() - t0)

    vals = [one(seed + r) for r in range(replicates)]
    return float(np.median(vals)), float(np.min(vals)), float(np.max(vals))


# (n, d, k_max, sweeps) — smallest first; last is the BASELINE.md headline.
LADDER = [
    (20_000, 16, 16, 10),
    (100_000, 64, 32, 8),
    (250_000, 128, 64, 6),
    (500_000, 256, 64, 5),
    (1_000_000, 256, 64, 5),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="first ladder rung only")
    ap.add_argument("--tiers", default=",".join(TIERS),
                    help=f"comma-separated subset of {','.join(TIERS)}")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--n", type=int)
    ap.add_argument("--d", type=int)
    ap.add_argument("--k", type=int)
    ap.add_argument("--sweeps", type=int)
    args = ap.parse_args(argv)
    tiers = [t for t in args.tiers.split(",") if t]
    unknown = sorted(set(tiers) - set(TIERS))
    if unknown:
        ap.error(f"unknown tiers {unknown}")

    import jax

    from common_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        print(f"bench: default backend is {jax.default_backend()!r}, not "
              "'gpu'; the benchmark runs on the GPU only", file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    peaks = peak_flops(dev.device_kind)
    cache_dir = enable_compile_cache(os.path.join(REPO, ".jax_cache"))

    t_start = time.perf_counter()
    result = {
        "metric": "blocked Gibbs sweeps/s (no tier completed)",
        "value": None, "unit": "sweeps/s", "vs_baseline": None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": card_info()},
        "peak_flops": peaks,
        "compile_cache": cache_dir,
        "tiers": [], "errors": {},
    }

    def attempt(name, fn, *a, **kw):
        try:
            return fn(*a, **kw)
        except Exception as e:  # recorded; the run exits non-zero
            result["errors"][name] = repr(e)
            print(f"# tier {name} failed: {e!r}", file=sys.stderr)
            return None

    if any(v is not None for v in (args.n, args.d, args.k, args.sweeps)):
        ladder = [(args.n or 100_000, args.d or 64, args.k or 32,
                   args.sweeps or 8)]
    elif args.smoke:
        ladder = LADDER[:1]
    else:
        ladder = LADDER
    top = None
    if "ladder" in tiers or args.smoke:
        for i, (n, d, k_max, sweeps) in enumerate(ladder):
            t = attempt(f"ladder-{n}x{d}", run_tier, n, d, k_max, sweeps,
                        jax.random.key(17 + i), peaks)
            if t is not None:
                result["tiers"].append(t)
                top = t
        if top is not None and not args.smoke:
            fused = attempt("fused", run_tier, top["n"], top["d"],
                            top["k_max"], top["sweeps"], jax.random.key(99),
                            peaks, kernel="fused")
            result["fused_tier"] = fused
            if fused is not None and fused["sweeps_per_s"] > top["sweeps_per_s"]:
                top = fused
    if top is not None:
        result.update({
            "metric": (f"{top['kernel']} Gibbs sweeps/s, {top['n']}x{top['d']}"
                       f" DPMM-NIW K_max={top['k_max']}"),
            "value": top["sweeps_per_s"],
            "tflops": top["tflops"],
            "tflops_share_of_peak": top["tflops_share_of_peak"],
            "k_active": top["k_active"],
        })
    shape = ((top["n"], top["d"], top["k_max"]) if top is not None
             else LADDER[-1][:3])
    fused_wins = top is not None and top["kernel"] == "fused"
    if args.smoke:
        tiers = []

    if "ess" in tiers:
        et = attempt("ess", run_ess_tier, *shape, jax.random.key(7),
                     kernel="fused" if fused_wins else "blocked")
        result["ess_tier"] = et
        if et is not None:
            result["ess_per_s"] = et["ess_per_s"]
            result["ess_per_s_spread"] = et["ess_per_s_spread"]
            result["predictive"] = et["predictive"]
    if "hdp" in tiers:
        result["hdp"] = attempt("hdp", run_hdp_tier, 1_000_000, 50, 32,
                                10_000, 3, jax.random.key(6))
    if "chains" in tiers:
        result["chains_on_card"] = attempt(
            "chains", run_chain_scaling_tier, jax.random.key(11))
        result["chains_headline"] = attempt(
            "chains_headline", run_chains_headline_tier, jax.random.key(13),
            *shape)
    if "config2" in tiers:
        result["config2"] = attempt("config2", run_config2_tier,
                                    jax.random.key(21))
    if "config3" in tiers:
        result["config3"] = attempt("config3", run_config3_tier,
                                    jax.random.key(22))
    if "smc" in tiers:
        result["smc"] = attempt("smc", run_smc_tier, 1_000_000, 256, 64, 16,
                                jax.random.key(5))
    if "sm_ab" in tiers:
        # split-merge A/B on ESS/s at 100k x 64: the same sweep with and
        # without the split-merge chaser, same seeds
        base_kernel = "fused" if fused_wins else "blocked"
        sm = attempt("sm_ab", run_ess_tier, 100_000, 64, 32,
                     jax.random.key(8), sweeps=300, n_seeds=2,
                     kernel=base_kernel + "+sm", heldout=0)
        plain = attempt("sm_ab_plain", run_ess_tier, 100_000, 64, 32,
                        jax.random.key(8), sweeps=300, n_seeds=2,
                        kernel=base_kernel, heldout=0)
        if sm is not None and plain is not None:
            sm["plain_ess_per_s"] = plain["ess_per_s"]
            sm["ess_per_s_ratio_vs_plain"] = (
                round(sm["ess_per_s"] / plain["ess_per_s"], 4)
                if sm["ess_per_s"] and plain["ess_per_s"] else None)
        result["sm_ab"] = sm

    if not args.skip_baseline and top is not None:
        med, lo, hi = numpy_collapsed_rows_per_s(top["d"],
                                                 max(top["k_active"], 2))
        base = med / top["n"]
        result["vs_baseline"] = round(result["value"] / base, 1)
        result["baseline"] = ("reference-architecture per-row collapsed "
                              "Gibbs (numpy, host), median of 5 "
                              "fixed-budget replicates, scaled to full N")
        result["baseline_sweeps_per_s"] = float(f"{base:.3e}")
        result["baseline_range"] = [float(f"{lo / top['n']:.3e}"),
                                    float(f"{hi / top['n']:.3e}")]

    result["total_s"] = round(time.perf_counter() - t_start, 1)
    print(json.dumps(result), flush=True)
    return 1 if result["errors"] or top is None else 0


if __name__ == "__main__":
    sys.exit(main())
