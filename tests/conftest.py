"""Test harness: an 8-device virtual CPU mesh, and the `gpu` fixture.

Under pytest the program runs on the CPU (`JAX_PLATFORMS=cpu`): multi-device
sharding logic is validated on host-platform virtual devices. Tests marked
`gpu` need the card; they take the `gpu` fixture, which skips them on any
other platform, and run on the card with
`python -m pytest tests -m gpu`. Speed is measured by `bench.py`, not under
pytest.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """The first JAX device; skips the test unless it is a GPU. Decided
    here, at run time, so every worker collects the same tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, JAX found {dev.platform}")
    return dev
