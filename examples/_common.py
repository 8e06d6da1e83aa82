"""Shared bootstrap for the runnable examples: repo path + jit cache."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceres_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
