"""Test configuration: force a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding is validated on a
host-platform device mesh per SURVEY.md §4 (test strategy).

With RADIATION_TESTS_ON_GPU=1 the suite keeps JAX's default (GPU)
platform instead; that mode is for the `gpu`-marked tests
(python -m pytest -m gpu tests/ on a machine with an NVIDIA GPU).
"""

import os

ON_GPU = os.environ.get("RADIATION_TESTS_ON_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8, (
        "tests require the virtual 8-device CPU mesh; got "
        + str(jax.devices()))
