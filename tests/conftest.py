"""Test configuration: hold JAX to a virtual 8-device CPU mesh so sharding
and multi-device code paths run without accelerators.

The environment is set before JAX is imported and is inherited by the
subprocesses tests start (CLI runs, dry runs): `JAX_PLATFORMS=cpu`, unless
the run names other platforms, keeps them on the host, and
`JAX_COMPILATION_CACHE_DIR` shares one persistent compile cache, at a fixed
path inside the checkout, across the suite.

Tests of what only the GPU runs carry the `gpu` marker and skip here; the
decision is taken in a fixture, never while a module is imported (workers
under pytest-xdist must collect identical tests).
"""

import importlib
import os
import pathlib

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_timeout_seconds" not in flags:
    # XLA:CPU's collective rendezvous LOG(FATAL)s the whole process when a
    # participant does not arrive within this timeout (default ~30s).  With
    # 8 virtual devices' threads oversubscribing a small host, the pp
    # trainer steps (ppermute + all-reduce mixes) can legitimately keep a
    # participant busy past the default mid-suite.  A true deadlock still
    # aborts eventually — but only after a 20-min stall that timestamps
    # attribute to the stuck test, instead of a 30s window that reads as a
    # random mid-suite death.
    flags = (flags + " --xla_cpu_collective_timeout_seconds=1200").strip()
os.environ["XLA_FLAGS"] = flags
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# hundreds of tiny executables recompile identically across tests and
# subprocess children; one warm cache cuts the suite's wall time
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(pathlib.Path(__file__).resolve().parents[1] / ".jax_cache" / "tests"))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: runs only on a GPU (chip_smoke.py runs it there)")


@pytest.fixture(autouse=True)
def _skip_gpu_only(request):
    if request.node.get_closest_marker("gpu") is not None \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; this run is held to the CPU")


@pytest.fixture
def torch_reference():
    """The reference implementation's `reference.models` package; skips
    the test where it, or torch, is not installed."""
    try:
        importlib.import_module("torch")
        return importlib.import_module("reference.models")
    except ImportError:
        pytest.skip("the torch reference implementation is not installed")
