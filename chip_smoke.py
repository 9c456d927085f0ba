#!/usr/bin/env python
"""Bring-up check on the GPU: drive the main paths at full width, once.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the sharded paths on 4 cards only

Phases (each prints one line: name, seconds, result; every phase runs, and
any failure ends the run with a non-zero exit code and no result line):

  device    the card's name and power limit (nvidia-smi) and jax.devices();
            the default backend must be `gpu` — there is no CPU fallback
  recovery  600-row NIW cluster recovery (collapsed `assign` +
            `grid_cluster_hp`), co-assignment agreement > 0.95
  headline  DPMM-NIW blocked Gibbs at 1M rows x 256 dims, K_max = 64,
            through state.initialize -> runner(assign_blocked,
            ew_cluster_hp), then the held-out predictive on 4096 rows
  kernel    the fused Gaussian assign kernel against the plain reference
            (well separated rows, ambiguous-row frequencies), and the plain
            sweep's restat against float64
  fused_vs_plain  assign_blocked_fused beside assign_blocked through the
            runner, at the headline and at 100k x 16, K = 16
  families/*  one short run of every other model family through its entry
            point, with its invariants checked

With --four-cards only the sharded paths run, on a (chains=1, data=4) mesh,
each beside what it is compared with.  The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from bench import (  # noqa: E402
    card_info,
    config2_problem,
    config3_problem,
    hdp_problem,
    heldout_predictive,
    make_data_device,
    niw_hyper,
    niw_mixture,
    smc_problem,
)

HEADLINE = dict(n=1_000_000, d=256, k_max=64)
HELDOUT_ROWS = 4096
SMALL_D = dict(n=100_000, d=16, k_max=16)


def check(cond, msg):
    """A phase's invariant (an explicit raise: `assert` vanishes under -O)."""
    if not cond:
        raise AssertionError(msg)


def run_phase(name, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s: {out}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_recovery():
    """The 600-row NIW recovery drive of the verify notes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import models, query
    from common_tpu import scalar_functions as sf
    from common_tpu import state as st
    from common_tpu.runner import runner

    r = np.random.default_rng(0)
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    z = r.integers(0, 3, 600)
    X = centers[z] + r.normal(scale=0.6, size=(600, 2))
    defn = st.model_definition(600, [models.niw(2)], k_max=32)
    data = ((jnp.asarray(X, jnp.float32), jnp.ones(600)),)
    s = st.initialize(defn, data, jax.random.key(42),
                      cluster_hp={"alpha": 1.0})
    run = runner(defn, data, s, [
        ("assign", {}),
        ("grid_cluster_hp", {"prior": sf.log_exponential(1.0),
                             "grid": np.geomspace(0.1, 10, 30)}),
    ])
    run.run(jax.random.key(1), 60)
    co = query.zmatrix(run.assignment_trace[-20:]) > 0.5
    agree = float((co == (z[:, None] == z[None, :])).mean())
    check(agree > 0.95, f"co-assignment agreement {agree:.4f} <= 0.95")
    check(np.isfinite(run.score_trace).all(), "non-finite joint score")
    return {"agreement": round(agree, 4)}


def _timed_runs(run, key, sweeps, repeats):
    """Median seconds per sweep over `repeats` runs of `sweeps` sweeps."""
    import jax
    import numpy as np

    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        s = run.run(jax.random.fold_in(key, 1000 + i), sweeps, collect=False)
        jax.block_until_ready(s)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / sweeps, times


def mixture_drive(n, d, k_max, kernel, key, sweeps=3, repeats=5,
                  heldout=HELDOUT_ROWS, kernel_kw=None):
    """One DPMM-NIW run through the user entry points, timed.

    state.model_definition -> state.initialize -> runner(kernel,
    ew_cluster_hp); one warm-up run (compiles), then `repeats` timed runs
    of `sweeps` sweeps, each ending on block_until_ready.  Returns the
    measurements and the final state.
    """
    import jax
    import numpy as np

    from common_tpu import state as st
    from common_tpu.runner import runner

    defn, data, s, xh = niw_mixture(key, n, d, k_max, heldout)
    run = runner(defn, data, s, [(kernel, dict(kernel_kw or {})),
                                 ("ew_cluster_hp", {"a": 1.0, "b": 1.0})])
    t0 = time.perf_counter()
    jax.block_until_ready(run.run(jax.random.fold_in(key, 2), sweeps,
                                  collect=False))
    first_s = time.perf_counter() - t0
    per_sweep, times = _timed_runs(run, key, sweeps, repeats)
    s = run.get_latent()
    counts = np.asarray(s.counts)
    score = float(st.score_joint(s))
    check(int(counts.sum()) == n, f"{kernel}: counts sum {counts.sum()} != {n}")
    check(np.isfinite(score), f"{kernel}: non-finite joint score {score}")
    out = {
        "kernel": kernel, "n": n, "d": d, "k_max": k_max,
        "sweeps_per_s": round(1.0 / per_sweep, 4),
        "run_s": [round(t, 4) for t in times],
        "compile_s": round(first_s - per_sweep * sweeps, 2),
        "k_active": int((counts > 0).sum()),
        "score": score,
    }
    if heldout:
        lp = heldout_predictive(s, xh)["per_dim"]
        check(np.isfinite(lp), f"{kernel}: non-finite held-out logp")
        out["heldout_logp_per_dim"] = lp
    return out, s


def phase_headline(n=HEADLINE["n"], d=HEADLINE["d"], k_max=HEADLINE["k_max"],
                   sweeps=3, repeats=5, heldout=HELDOUT_ROWS):
    import jax

    out, _ = mixture_drive(n, d, k_max, "assign_blocked", jax.random.key(17),
                           sweeps, repeats, heldout)
    return out


def assign_problem(key, n, d, k, sep=3.0):
    """Well-separated rows, a non-diagonal B_k per cluster, Gumbel noise."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        km, kz, kx, kb, kbase, kg = jax.random.split(key, 6)
        mu = sep * jax.random.normal(km, (k, d), jnp.float32)
        z = jax.random.randint(kz, (n,), 0, k)
        X = mu[z] + 0.5 * jax.random.normal(kx, (n, d), jnp.float32)
        binv = 2.0 * jnp.eye(d, dtype=jnp.float32) + (
            0.2 / jnp.sqrt(d)) * jax.random.normal(kb, (k, d, d), jnp.float32)
        base = jax.random.normal(kbase, (k,), jnp.float32)
        g = jax.random.gumbel(kg, (n, k), jnp.float32)
        return X, mu, binv, base, g

    return gen(key)


def kernel_agreement(n, d, k, key, interpret=False):
    """Row agreement of the kernel with the `highest`-precision reference."""
    import jax
    import numpy as np

    from common_tpu.ops.gaussian_assign import (
        fused_gaussian_assign,
        gaussian_assign_reference,
    )

    X, mu, binv, base, g = assign_problem(key, n, d, k)
    z = fused_gaussian_assign(X, mu, binv, base, g, interpret=interpret)
    with jax.default_matmul_precision("highest"):
        zr = gaussian_assign_reference(X, mu, binv, base, g)
    z, zr = np.asarray(z), np.asarray(zr)
    check(z.shape == (n,), f"kernel output shape {z.shape}")
    return float((z == zr).mean())


def kernel_distribution(key, reps=300, interpret=False):
    """Ambiguous rows: per-row frequencies against softmax probabilities.

    Returns (max abs error, error of the mean over rows)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu.ops.gaussian_assign import fused_gaussian_assign

    d, k, n = 4, 5, 64
    r = np.random.default_rng(1)
    mu = jnp.asarray(r.normal(scale=0.8, size=(k, d)), jnp.float32)
    X = jnp.asarray(r.normal(scale=1.0, size=(n, d)), jnp.float32)
    binv = jnp.asarray(np.stack([np.eye(d, dtype=np.float32)] * k))
    base = jnp.asarray(r.normal(size=k), jnp.float32)
    dev = np.asarray(X)[:, None, :] - np.asarray(mu)[None]
    logp = np.asarray(base)[None, :] - 0.5 * np.sum(dev * dev, axis=-1)
    e = np.exp(logp - logp.max(1, keepdims=True))
    probs = e / e.sum(1, keepdims=True)

    counts = np.zeros((n, k))
    for i in range(reps):
        g = jax.random.gumbel(jax.random.fold_in(key, i), (n, k))
        z = np.asarray(fused_gaussian_assign(X, mu, binv, base, g,
                                             interpret=interpret))
        counts[np.arange(n), z] += 1
    freq = counts / reps
    return (float(np.abs(freq - probs).max()),
            float(np.abs(freq.mean(0) - probs.mean(0)).max()))


def restat_vs_float64(n, d, k_max, key):
    """One plain `blocked.sweep`; its stats against a float64 numpy restat
    of its own z.  Returns the worst error of each leaf, relative to the
    largest entry of that cluster's leaf."""
    import jax
    import numpy as np

    from common_tpu.kernels import blocked

    _, data, s, _ = niw_mixture(key, n, d, k_max)
    s = blocked.sweep(s, data, jax.random.fold_in(key, 2))
    z = np.asarray(s.assignments)
    X = np.asarray(data[0][0], np.float64)
    counts = np.bincount(z, minlength=k_max)
    check(np.array_equal(np.asarray(s.counts), counts),
          "restat counts differ from bincount of z")
    worst = {"sum_x": 0.0, "sum_xxT": 0.0}
    X = X[np.argsort(z, kind="stable")]  # clusters become contiguous runs
    ends = np.cumsum(counts)
    for c in np.nonzero(counts)[0]:
        Xc = X[ends[c] - counts[c]:ends[c]]
        want = {"sum_x": Xc.sum(0), "sum_xxT": Xc.T @ Xc}
        for leaf, w in want.items():
            got = np.asarray(s.stats[0][leaf][c], np.float64)
            err = np.abs(got - w).max() / np.abs(w).max()
            worst[leaf] = max(worst[leaf], float(err))
    check(np.array_equal(np.asarray(s.stats[0]["n"]), counts),
          "stats n differ from counts")
    return worst


# Bounds of the kernel phase.  Agreement: TF32 input rounding moves a
# well-separated row's score by far less than its margin.  Frequencies:
# binomial se <= sqrt(.25/300) = 0.029, so 0.15 is > 5 se per row; the
# mean over 64 rows is ~8x tighter.  Restat: sum_x is a float32 (HIGHEST)
# product; sum_xxT runs as three bf16 passes (niw.scatter_product),
# 1.4e-5 of a cluster's largest entry at 1M x 256, K = 64 on an H100.  A
# TF32 product (5.7e-4 there: its error does not average down over rows)
# fails the bound.
AGREE_MIN = 0.999
FREQ_MAX_ABS, FREQ_MEAN_ABS = 0.15, 0.03
RESTAT_TOL = {"sum_x": 1e-5, "sum_xxT": 1e-4}


def phase_kernel(n_sep=1_048_576, n_odd=1_000_003, d=256, ks=(64, 50),
                 restat_shape=HEADLINE, interpret=False):
    """The kernel against the plain reference, and the plain restat."""
    import jax

    out = {"precision": "tf32 (in-kernel dot); reference highest"}
    key = jax.random.key(5)
    for n in (n_sep, n_odd):
        for k in ks:
            a = kernel_agreement(n, d, k, jax.random.fold_in(key, n + k),
                                 interpret=interpret)
            out[f"agree_n{n}_d{d}_k{k}"] = round(a, 6)
            check(a >= AGREE_MIN, f"agreement {a} < {AGREE_MIN} "
                                  f"(n={n}, d={d}, K={k})")
    mx, mean = kernel_distribution(jax.random.key(100), interpret=interpret)
    out["freq_max_abs_err"] = round(mx, 4)
    out["freq_mean_abs_err"] = round(mean, 4)
    check(mx < FREQ_MAX_ABS and mean < FREQ_MEAN_ABS,
          f"ambiguous-row frequencies off: max {mx}, mean {mean}")
    worst = restat_vs_float64(restat_shape["n"], restat_shape["d"],
                              restat_shape["k_max"], jax.random.key(9))
    out["restat_rel_err"] = {k: float(f"{v:.3e}") for k, v in worst.items()}
    for leaf, tol in RESTAT_TOL.items():
        check(worst[leaf] < tol, f"restat {leaf} error {worst[leaf]} >= {tol}")
    return out


def phase_fused_vs_plain(shapes=(HEADLINE, SMALL_D), sweeps=3, repeats=5,
                         interpret=False):
    """assign_blocked_fused beside assign_blocked, through the runner."""
    import jax

    kw = {"interpret": True} if interpret else {}
    out = {}
    for shape in shapes:
        pair = {}
        for kernel in ("assign_blocked", "assign_blocked_fused"):
            m, _ = mixture_drive(
                shape["n"], shape["d"], shape["k_max"], kernel,
                jax.random.key(17), sweeps, repeats, heldout=0,
                kernel_kw=kw if kernel == "assign_blocked_fused" else None,
            )
            pair[kernel] = {"sweeps_per_s": m["sweeps_per_s"],
                            "run_s": m["run_s"], "compile_s": m["compile_s"]}
        out[f"{shape['n']}x{shape['d']}_k{shape['k_max']}"] = pair
    return out


# families: (name, fn, arguments at the full size)
FAMILIES = (
    ("config2", "family_config2", (100_000, 64, 32)),
    ("config3", "family_config3", (100_000,)),
    ("hdp_dense", "family_hdp_dense", (100_000, 50, 10_000, 32)),
    ("block_smc", "family_block_smc", (100_000, 32, 16)),
    ("irm", "family_irm", (4096,)),
    ("split_merge", "family_split_merge", (100_000, 64, 32)),
)


def family_config2(n, d, k_max, sweeps=3):
    """bbv DPMM + slice hyper updates (BASELINE config 2)."""
    import jax

    from common_tpu.runner import runner

    defn, data, s, _, slice_kw = config2_problem(jax.random.key(21), n, d,
                                                 k_max)
    run = runner(defn, data, s, [("assign_blocked", {}),
                                 ("slice_hp", slice_kw)])
    s = run.run(jax.random.key(23), sweeps)
    return _mixture_invariants(s, n, run.score_trace)


def family_config3(n, sweeps=2):
    """Mixed NIW + GammaPoisson + BetaBernoulli with NUTS hypers (config 3)."""
    import jax

    from common_tpu.runner import runner

    defn, data, _, s, priors, exp1 = config3_problem(jax.random.key(31), n,
                                                     k_max=32)
    run = runner(defn, data, s, [
        ("assign_blocked", {}),
        ("nuts_hp", {"priors": priors, "num_steps": 2, "max_depth": 5}),
        ("nuts_cluster_hp", {"prior": exp1, "num_steps": 2, "max_depth": 5}),
    ])
    s = run.run(jax.random.key(33), sweeps)
    return _mixture_invariants(s, n, run.score_trace)


def _mixture_invariants(s, n, scores):
    import numpy as np

    counts = np.asarray(s.counts)
    check(int(counts.sum()) == n, f"counts sum {counts.sum()} != {n}")
    check(np.isfinite(scores).all(), "non-finite joint score")
    return {"k_active": int((counts > 0).sum()),
            "score": float(scores[-1])}


def family_hdp_dense(n_docs, doc_len, vocab, k_topics, sweeps=2):
    import jax
    import numpy as np

    from common_tpu import topic

    words, mask, _, s = hdp_problem(jax.random.key(41), n_docs, doc_len,
                                    vocab, k_topics)

    @jax.jit
    def step(s, key):
        s = topic.blocked_sweep_dense(s, words, mask, jax.random.fold_in(key, 0))
        return topic.hdp._sample_beta_jit(s, jax.random.fold_in(key, 1),
                                          doc_len)

    for t in range(sweeps):
        s = step(s, jax.random.fold_in(jax.random.key(43), t))
    total = float(np.asarray(s.topic_total).sum())
    score = float(topic.score_joint(s))
    check(total == n_docs * doc_len, f"topic totals {total} != tokens")
    check(np.isfinite(score), "non-finite HDP joint score")
    return {"tokens": n_docs * doc_len, "k_active": int(s.active_topics()),
            "score": score}


def family_block_smc(n, d, n_particles, block=4096, warmup=128):
    import jax
    import numpy as np

    from common_tpu.kernels import smc

    data, parts, _ = smc_problem(jax.random.key(51), n, d, 32, n_particles)
    res = smc.run_blocked(parts, data, jax.random.key(53), block=block,
                          warmup=warmup)
    logz = float(res.logz)
    counts = np.asarray(res.particles.counts).sum(-1)
    check(np.isfinite(logz), f"non-finite logz {logz}")
    check((counts == n).all(), f"particle counts {counts} != {n}")
    return {"logz": logz, "n_resamples": int(res.n_resamples)}


def family_irm(n, k_max=32):
    """IRM blocked sweep on one n x n Beta-Bernoulli relation."""
    import jax
    import numpy as np

    from common_tpu import models, relational
    from common_tpu.data.sparse import sparse_ndarray_dataview

    r = np.random.default_rng(61)
    zt = r.integers(0, 4, n)
    p = r.uniform(0.05, 0.95, size=(4, 4))
    rel = (r.random((n, n)) < p[zt[:, None], zt[None, :]]).astype(np.float32)
    defn = relational.model_definition([n], [((0, 0), models.bb)], k_max=k_max)
    views = [sparse_ndarray_dataview(dense=rel)]
    s = relational.initialize(defn, views, jax.random.key(62),
                              cluster_hps=[{"alpha": 1.0}])
    for t in range(2):
        s = relational.kernels.sweep(s, views, jax.random.fold_in(
            jax.random.key(63), t))
    counts = np.asarray(s.counts[0])
    score = float(relational.score_joint(s))
    check(int(counts.sum()) == n, f"IRM counts {counts.sum()} != {n}")
    check(np.isfinite(score), "non-finite IRM joint score")
    return {"cells": n * n, "k_active": int((counts > 0).sum()),
            "score": score}


def family_split_merge(n, d, k_max):
    import jax
    import numpy as np

    from common_tpu.runner import runner

    defn, data, s, _ = niw_mixture(jax.random.key(71), n, d, k_max)
    run = runner(defn, data, s, [("split_merge", {"n_moves": 1})])
    s = run.run(jax.random.key(73), 1)
    out = _mixture_invariants(s, n, run.score_trace)
    check(np.array_equal(np.asarray(s.counts), np.bincount(
        np.asarray(s.assignments), minlength=k_max)), "counts != bincount(z)")
    return out


# ---------------------------------------------------------------------------
# four cards: the sharded paths, each beside its single-card comparison
# ---------------------------------------------------------------------------
def four_mixture(devices, n, d, k_max):
    """Sharded sweep over (chains=1, data=4): psum'd counts and stats
    against a single-card restat of the gathered z."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from common_tpu import models, parallel
    from common_tpu import state as st
    from common_tpu.kernels import blocked

    x = make_data_device(jax.random.key(81), n, d)
    defn = st.model_definition(n, [models.niw(d)], k_max=k_max)
    data = ((x, jnp.ones(n, jnp.float32)),)
    mesh = parallel.make_mesh(chains=1, data=len(devices), devices=devices)
    states = parallel.initialize_chains(
        defn, data, jax.random.split(jax.random.key(82), 1),
        cluster_hp={"alpha": 1.0}, feature_hps=[niw_hyper(d)])
    states, sdata = parallel.shard_state(mesh, states, data)
    sweep = parallel.make_sharded_sweep(mesh, states, sdata)
    out = jax.block_until_ready(sweep(states, sdata, jax.random.key(83)))
    one = parallel.gather_chain(out, 0)
    one = jax.device_put(one, devices[0])
    ref = blocked.restat(one, jax.device_put(data, devices[0]),
                         one.assignments)
    check(np.array_equal(np.asarray(one.counts), np.asarray(ref.counts)),
          "sharded counts != single-card restat")
    check(int(np.asarray(one.counts).sum()) == n, "sharded counts sum != n")
    errs = {}
    for leaf in ("n", "sum_x", "sum_xxT"):
        a = np.asarray(one.stats[0][leaf], np.float64)
        b = np.asarray(ref.stats[0][leaf], np.float64)
        errs[leaf] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
        # same products, summed in another order (4 partial sums + psum)
        check(errs[leaf] < 1e-4, f"sharded {leaf} off by {errs[leaf]}")
    return {"rows": n, "rel_err": {k: float(f"{v:.3e}") for k, v in errs.items()}}


def four_block_smc(devices, n, d, n_particles, block=4096, warmup=128,
                   n_single=4):
    """Particle-sharded block-SMC against run_blocked on one card.

    Monte Carlo band: `n_single` single-card runs with different keys give
    the mean m and sample deviation s of logz; one sharded run (other keys
    by design) must lie within max(5 s sqrt(1 + 1/n_single), 1e-3 |m|)
    of m."""
    import jax
    import numpy as np

    from common_tpu.kernels import smc

    data, parts, _ = smc_problem(jax.random.key(91), n, d, 32, n_particles)
    single = []
    for i in range(n_single):
        res = smc.run_blocked(parts, data, jax.random.key(93 + i),
                              block=block, warmup=warmup)
        single.append(float(res.logz))
    pmesh = smc.make_particle_mesh(devices=devices)
    sparts, sdata = smc.shard_particles(pmesh, parts, data)
    res = smc.run_blocked_sharded(pmesh, sparts, sdata, jax.random.key(90),
                                  block=block, warmup=warmup)
    logz = float(res.logz)
    mean = float(np.mean(single))
    sd = float(np.std(single, ddof=1))
    band = max(5.0 * sd * float(np.sqrt(1.0 + 1.0 / n_single)),
               1e-3 * abs(mean))
    check(np.isfinite(logz), "sharded SMC logz not finite")
    check((np.asarray(res.particles.counts).sum(-1) == n).all(),
          "sharded SMC particles do not seat every row")
    check(abs(logz - mean) <= band,
          f"sharded logz {logz} outside {mean} +- {band}")
    return {"logz_sharded": logz, "logz_single": single,
            "band": round(band, 2)}


def four_hdp_dense(devices, n_docs, doc_len, vocab, k_topics):
    import jax
    import numpy as np

    from common_tpu import parallel, topic

    words, mask, _, s = hdp_problem(jax.random.key(101), n_docs, doc_len,
                                    vocab, k_topics)
    mesh = parallel.make_mesh(chains=1, data=len(devices), devices=devices)
    s, wsh, msh = topic.shard_dense_corpus(mesh, s, words, mask)
    sweep = topic.make_sharded_sweep_dense(mesh, s, wsh, msh)
    for t in range(2):
        s = sweep(s, wsh, msh, jax.random.fold_in(jax.random.key(103), t))
    total = float(np.asarray(s.topic_total).sum())
    check(total == n_docs * doc_len, f"sharded topic totals {total} != tokens")
    check(float(np.asarray(s.topic_word).sum()) == total,
          "topic_word does not sum to topic totals")
    return {"tokens": n_docs * doc_len}


# four cards: (name, fn, arguments at the full size, after the devices)
FOUR_CARDS = (
    ("four_cards/mixture", "four_mixture", (1_000_000, 256, 64)),
    ("four_cards/block_smc", "four_block_smc", (100_000, 32, 16)),
    ("four_cards/hdp_dense", "four_hdp_dense", (100_000, 50, 10_000, 32)),
)


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on 4 cards")
    args = ap.parse_args(argv)

    import jax

    from common_tpu.utils.compile_cache import enable_compile_cache

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: default backend is {backend!r}, not 'gpu'; "
              "this check runs on the GPU only", file=sys.stderr)
        return 2
    enable_compile_cache(os.path.join(REPO, ".jax_cache"))
    devices = jax.devices()
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: need {need} GPUs, have {len(devices)}",
              file=sys.stderr)
        return 2
    devices = devices[:need]

    run_phase("device", lambda: {"jax_devices": [str(d) for d in devices]})
    print(f"card: {card_info()}", flush=True)
    here = globals()
    if args.four_cards:
        phases = [(name, here[fn], (devices, *a)) for name, fn, a in FOUR_CARDS]
    else:
        phases = [("recovery", phase_recovery, ()),
                  ("headline", phase_headline, ()),
                  ("kernel", phase_kernel, ()),
                  ("fused_vs_plain", phase_fused_vs_plain, ())]
        phases += [(f"families/{name}", here[fn], a) for name, fn, a in FAMILIES]
    failed = []
    for name, fn, args_ in phases:
        # every phase runs, so one failure does not hide another; any
        # failure still ends the run non-zero, with no result line
        try:
            run_phase(name, fn, *args_)
        except Exception:
            traceback.print_exc()
            print(f"phase {name}: FAILED", flush=True)
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    d0 = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
