"""What a measurement runs on: the accelerator JAX sees, and the card's
name and power limit as ``nvidia-smi`` reports them.

Every timed result names its device; a measurement that finds no GPU
fails instead of timing the CPU backend.
"""

from __future__ import annotations

import subprocess

import jax


class NoGPUError(RuntimeError):
    """JAX found no GPU to measure on."""


def require_gpu() -> dict:
    """The device record printed with every result; raises NoGPUError
    unless JAX's default devices are GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGPUError(f"no GPU: JAX runs on {devs[0].platform!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per
    card (a child process that never imports JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
