"""Test configuration: pin every test process to the CPU backend (set
programmatically, before any JAX use, so it holds whatever
JAX_PLATFORMS says) and expose an 8-device virtual CPU mesh for the
multi-device sharding tests.  GPU checks live in chip_smoke.py."""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
    # Cap codegen at SSE4.2: no FMA instructions exist there, so LLVM
    # cannot contract mul+add pairs anywhere.  Contraction changes
    # last-ulp rounding vs NumPy's two-rounding arithmetic and flips
    # floor() at integer flow boundaries; exact-parity mode guards its
    # own products (engine._nofma), and this pin keeps the bitwise
    # path-equality tests free of it too.
    + " --xla_cpu_max_isa=SSE4_2"
    # Tests are compile-dominated on this 1-vCPU host: dialing the CPU
    # backend's optimization pipeline down cuts suite wall-clock ~35%
    # with bit-exact golden parity preserved (verified: the parity
    # suites pass under these flags — no arithmetic rewrites happen at
    # SSE4.2 that the optimizer level would change).
    + " --xla_backend_optimization_level=0"
    + " --xla_llvm_disable_expensive_passes=true"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def x64():
    """Enable float64 for numerical-parity tests."""
    jax.config.update("jax_enable_x64", True)
    yield
    # leave enabled for the session; parity tests dominate


def pytest_configure(config):
    # markers are declared in pytest.ini; re-registering here keeps
    # direct `pytest tests/test_x.py` invocations from warning when the
    # ini is not picked up (e.g. copied-out test files)
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line("markers", "xslow: very long-running test")
