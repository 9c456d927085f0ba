"""Test harness config.

- Forces an 8-device virtual CPU platform (the SURVEY.md §7 recipe) so
  sharding/collective tests run without several accelerators:
  XLA_FLAGS=--xla_force_host_platform_device_count=8, then grab
  jax.devices("cpu") and pin computations there via jax.default_device.
- Unit tests run on the CPU.  Tests of compiled GPU kernels carry the
  `gpu` marker: they are implicitly `slow`, run on the card's default
  device, and skip (inside a fixture, never at import or collection time)
  when no GPU is present.  On the card: `python -m pytest tests/ -m gpu`.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def cpu_devices():
    cpus = jax.devices("cpu")
    assert len(cpus) >= 8, f"expected >= 8 virtual CPU devices, got {len(cpus)}"
    return cpus


def _gpu_devices():
    try:
        return jax.devices("gpu")
    except RuntimeError:
        return []


@pytest.fixture(autouse=True)
def _placement(request):
    """Pin every test to the CPU; `gpu` tests run on the card or skip."""
    if request.node.get_closest_marker("gpu") is None:
        with jax.default_device(jax.devices("cpu")[0]):
            yield
        return
    gpus = _gpu_devices()
    if not gpus:
        pytest.skip("no GPU device available")
    with jax.default_device(gpus[0]):
        yield


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: requires a GPU (skipped otherwise)")
    config.addinivalue_line("markers", "slow: long-running statistical test")


def pytest_collection_modifyitems(config, items):
    # the default gate (`-m "not slow"`) stays free of card-only tests
    for item in items:
        if "gpu" in item.keywords:
            item.add_marker(pytest.mark.slow)
