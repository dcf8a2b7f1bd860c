"""Test environment: the CPU with 8 virtual devices, so the sharding tests
run anywhere.  The suite is run as `JAX_PLATFORMS=cpu python -m pytest
tests/`; JAX_PLATFORMS defaults to cpu here too.

Tests marked `gpu` need the card and skip elsewhere (the `gpu` fixture
decides at run time, never at import).  On the GPU machine they run with
`JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/`: the CPU stays the
default backend for everything else, and the fixture hands out the card.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _bounded_jit_caches():
    """XLA:CPU has segfaulted compiling large wavefront programs ONLY when
    ~100 tests' jit caches had accumulated in-process.  Clearing at module
    boundaries bounds the cache pressure at negligible recompile cost
    (cross-module jit sharing is minimal)."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="session")
def reference_renders():
    """Directory of the upstream project's checked-in renders
    (testPPM*.ppm).  They are not part of this repository: a test that
    reads them skips, with this reason, where they are absent."""
    from test_golden import GOLDEN_PATH

    ref_dir = os.path.dirname(GOLDEN_PATH)
    if not os.path.isdir(ref_dir):
        pytest.skip(f"the reference renders are not present ({ref_dir})")
    return ref_dir


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cpu,cuda on the "
                    "card)")
