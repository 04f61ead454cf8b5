"""Test configuration: run everything on a virtual 8-device CPU mesh.

The suite runs on the CPU. Multi-device sharding is validated on virtual
CPU devices (XLA_FLAGS=--xla_force_host_platform_device_count=8), so the
flag is added before JAX is imported.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
