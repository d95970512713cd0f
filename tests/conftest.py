"""Test configuration: CPU backend with 8 virtual devices by default.

Multi-device sharding logic is validated on a virtual CPU mesh
(SURVEY.md §4c).  Tests marked ``gpu`` need a card and skip elsewhere; run
them on a GPU host with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
(an explicit JAX_PLATFORMS is kept; only an unset one defaults to cpu).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop live compiled executables after each test module.

    The suite compiles hundreds of shape-distinct XLA:CPU modules in one
    process; with them all held live, XLA:CPU has segfaulted on a 1-vCPU
    host deep into the suite (large interpret-mode Pallas HLO in
    tests/test_ring.py — each such test passes standalone).  Cross-module
    jit cache hits are rare here (modules use distinct shapes), so
    clearing costs little and bounds the executable footprint."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.  Decided
    here, at run time, so every test worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX backend is {jax.default_backend()}")
    return jax.devices()[0]
