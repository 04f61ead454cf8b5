"""The accelerator a measurement runs on, and the card's name and power limit."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """The default device as JAX reports it; raises unless it is a GPU.

    Measurements name the device they ran on and never fall back to the CPU.
    """
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {jax.default_backend()!r} "
            f"({devices})")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def nvidia_smi_name_power() -> str:
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
