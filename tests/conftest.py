"""Test configuration: local CPU with an 8-device virtual mesh + x64.

Mirrors the reference's differential-test strategy (SURVEY.md §4): tests run
the identical math in float64 on CPU against NumPy/SciPy references; the
8-device virtual platform exercises the multi-device sharding path without
an accelerator. Tests that need the card live in tests_chip/ and run there
with `pytest -m chip tests_chip/`.
"""

import os
import sys

# must precede first backend initialization
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceres_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a GPU (tests_chip/)")
    config.addinivalue_line("markers", "slow: long-running; tier-1 skips it")
