"""Test harness config: run on a virtual 8-device CPU mesh.

The CPU is forced only when ``JAX_PLATFORMS`` is unset, so a process that
has already chosen its platforms (``chip_smoke.py`` runs the ``gpu``-marked
tests with the card visible) keeps them. The fake-device count must land in
``XLA_FLAGS`` before the CPU client is created; conftest runs before any
test imports jax.numpy, so this is early enough.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
