"""Repo-root pytest config: path setup + a virtual 8-device CPU mesh.

The suite runs on the CPU; sharding tests use 8 virtual CPU devices
(SURVEY.md §4.4). Tests that need an NVIDIA GPU carry the `gpu` marker
and skip here (tests/conftest.py decides inside a fixture).
`chip_smoke.py` runs them on the card with BNN_TESTS_ON_GPU=1, which lifts
the CPU pin below.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

if os.environ.get("BNN_TESTS_ON_GPU") != "1":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

    import jax  # noqa: E402

    # pin the CPU even where JAX_PLATFORMS is unset and a card is visible
    # (must happen before any backend is initialized)
    jax.config.update("jax_platforms", "cpu")
