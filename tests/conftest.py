"""Test configuration: force CPU JAX with 8 virtual devices for mesh tests."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # tests are hermetic-CPU
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# test workers compile concurrently: keep them off the persistent cache
jax.config.update("jax_enable_compilation_cache", False)

import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pytest  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
GOLDEN = os.path.join(HERE, "golden")


@pytest.fixture(scope="session")
def fixtures_dir():
    return FIXTURES


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


def hermetic_cpu_env() -> dict:
    """Subprocess env pinned to the CPU backend, with the repo importable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["JAX_PLATFORMS"] = "cpu"
    return env
