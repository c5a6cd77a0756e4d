import os

# jax may already be imported when this file runs, so JAX_PLATFORMS /
# XLA_FLAGS set via os.environ here could be too late.  jax.config.update
# takes effect at first backend use.
import jax

# CPU backend with 8 virtual devices so the multi-device sharding paths
# compile and execute without accelerator hardware.  Tests that need the
# GPU carry the ``gpu`` marker and skip on the CPU (see the ``gpu``
# fixture); on the card run them with JAX_PLATFORMS=cuda -m gpu.
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from pangulu_jax.utils import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none.  Decided
    here, at run time, never at import or collection."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run with -m gpu on the card)")
    return devices[0]
