"""Test harness: run everything on a virtual 8-device CPU mesh.

Must set the env before jax is first imported anywhere in the test process.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
import jax

# tests run on the virtual 8-device CPU mesh even where a GPU is present
jax.config.update("jax_platforms", "cpu")

from longreadselfcorrect_tpu.jaxcache import configure_compile_cache

# persistent compile cache: the walk-engine tests are XLA-compile-bound
configure_compile_cache()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)
