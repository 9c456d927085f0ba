"""chip_smoke.py and the compile-cache helper, on the CPU.

The script itself refuses to run without a GPU; its phases are plain
functions of their sizes, so each runs here at a toy size (the fused
kernel through the Pallas interpreter, the four-card paths on four
virtual CPU devices).
"""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from common_tpu.utils import compile_cache  # noqa: E402


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=240, env=env, cwd=cwd)


def test_chip_smoke_refuses_cpu():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "GPU only" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.fixture
def _restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_wins(monkeypatch, tmp_path, _restore_cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    got = compile_cache.enable_compile_cache(str(tmp_path / "default"))
    assert got == str(tmp_path / "env")
    # JAX reads the variable itself; no other path is set
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_dir(monkeypatch, tmp_path,
                                   _restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    default = str(tmp_path / ".jax_cache")
    assert compile_cache.enable_compile_cache(default) == default
    assert jax.config.jax_compilation_cache_dir == default


def test_gitignore_lists_the_default_cache():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_phase_recovery():
    assert cs.phase_recovery()["agreement"] > 0.95


def test_phase_kernel_tiny():
    out = cs.phase_kernel(n_sep=1024, n_odd=1003, d=32, ks=(8, 5),
                          restat_shape=dict(n=2000, d=8, k_max=8),
                          interpret=True)
    assert all(v >= cs.AGREE_MIN for k, v in out.items()
               if k.startswith("agree_"))
    assert out["restat_rel_err"]["sum_xxT"] < cs.RESTAT_TOL["sum_xxT"]


def test_fused_vs_plain_tiny():
    out = cs.phase_fused_vs_plain(shapes=(dict(n=1000, d=4, k_max=4),),
                                  sweeps=2, repeats=2, interpret=True)
    pair = out["1000x4_k4"]
    assert set(pair) == {"assign_blocked", "assign_blocked_fused"}
    assert all(v["sweeps_per_s"] > 0 for v in pair.values())


def test_headline_drive_tiny():
    out = cs.phase_headline(n=1500, d=6, k_max=8, sweeps=2, repeats=2,
                            heldout=32)
    assert out["kernel"] == "assign_blocked" and len(out["run_s"]) == 2
    assert out["heldout_logp_per_dim"] < 0


TINY_FAMILIES = {
    "config2": (500, 8, 8), "config3": (500,), "hdp_dense": (64, 10, 40, 4),
    "block_smc": (600, 4, 4), "irm": (64,), "split_merge": (500, 4, 8),
}


@pytest.mark.parametrize("name,fn", [(n, f) for n, f, _ in cs.FAMILIES])
def test_family_tiny(name, fn):
    assert getattr(cs, fn)(*TINY_FAMILIES[name])


TINY_FOUR = {
    "four_cards/mixture": (2000, 8, 8),
    "four_cards/block_smc": (600, 4, 8),
    "four_cards/hdp_dense": (64, 10, 40, 4),
}


@pytest.mark.parametrize("name,fn", [(n, f) for n, f, _ in cs.FOUR_CARDS])
def test_four_card_path_on_virtual_devices(name, fn, cpu_devices):
    assert getattr(cs, fn)(cpu_devices[:4], *TINY_FOUR[name])


def test_dryrun_multichip_refuses_too_few_devices(cpu_devices):
    """No silent swap to other devices: too few is an error."""
    import __graft_entry__

    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        __graft_entry__.dryrun_multichip(4, devices=cpu_devices[:2])
