"""bench.py: the pieces that run without a GPU.

The benchmark itself refuses to run anywhere but on a GPU; its tier
functions are plain JAX and run here at toy shapes.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


def test_chains_headline_tier_structure_cpu():
    """run_chains_headline_tier at a toy shape on CPU.

    d=72 > d_max_xx forces the same vmapped per-chain dispatch inside
    `sweep_chains` that the 1M x 256 headline shape takes, so the
    production code path of the tier is what runs here.
    """
    import jax

    out = bench.run_chains_headline_tier(
        jax.random.key(0), 256, 72, 4, chain_counts=(2,), sweeps=2,
        repeats=1,
    )
    info = out["chains"]["2"]
    assert info["aggregate_chain_sweeps_per_s"] > 0
    assert len(info["k_active_per_chain"]) == 2
    assert all(1 <= k <= 4 for k in info["k_active_per_chain"])
    # both fields are independently rounded to 3 decimals
    assert info["per_chain_sweeps_per_s"] == pytest.approx(
        info["aggregate_chain_sweeps_per_s"] / 2, abs=2e-3
    )


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_refuses_unknown_device(kind):
    with pytest.raises(ValueError, match="no peak FLOP/s on record"):
        bench.peak_flops(kind)


def test_peak_of_known_card_is_its_tf32_rate():
    peaks = bench.peak_flops("NVIDIA H100 80GB HBM3")
    assert peaks["tf32"] == 495e12 and peaks["bf16"] == 989e12


def test_bench_refuses_cpu():
    """No GPU: a non-zero exit and no result line (no CPU fallback)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--smoke",
         "--skip-baseline"],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO,
    )
    assert r.returncode != 0
    assert '"metric"' not in r.stdout
    assert "GPU only" in r.stderr


def test_bench_rejects_unknown_tier():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--tiers", "nope"],
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=REPO,
    )
    assert r.returncode != 0 and "unknown tiers" in r.stderr


def test_run_tier_record_cpu():
    """One ladder rung at a toy shape: the record's fields and units."""
    import jax

    peaks = {"tf32": 495e12, "bf16": 990e12}
    t = bench.run_tier(1000, 4, 4, 3, jax.random.key(0), peaks,
                       heldout=32, repeats=2)
    assert t["sweeps_per_s"] > 0 and len(t["run_s"]) == 2
    # half the FLOPs at the TF32 rate, half as three bf16 passes: the
    # same time at peak as all of them at 396e12
    assert t["tflops_share_of_peak"] == pytest.approx(
        t["tflops"] * 1e12 / 396e12, abs=1e-4)
    assert 1 <= t["k_active"] <= 4
    assert t["predictive"]["heldout_rows"] == 32
    json.dumps(t)


def test_timed_blocks_and_takes_the_median():
    import jax.numpy as jnp

    calls = []

    def fn(x):
        calls.append(1)
        return jnp.sum(x)

    med, times, out = bench.timed(fn, jnp.ones(8), repeats=3)
    assert len(calls) == 4  # one warm-up + three timed
    assert len(times) == 3 and med == sorted(times)[1]
    assert float(out) == 8.0
