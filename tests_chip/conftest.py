"""On-card test tier: run on a machine with an NVIDIA GPU.

    python -m pytest -m chip tests_chip/ -q

A sibling of tests/ so that tests/conftest.py (which pins every unit test
to local CPU + x64) does not apply. chip_smoke.py runs this tier in its own
process as its last phase. Without a GPU every test skips with a reason;
whether a GPU is present is decided in a fixture, never at collection.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceres_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a GPU (tests_chip/)")
    config.addinivalue_line("markers", "slow: long-running; tier-1 skips it")


@pytest.fixture(autouse=True)
def require_gpu():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"on-card tier needs a GPU; JAX found {platform!r}")
    enable_compile_cache()
