"""The card a measurement runs on, named beside every number it prints.

Measurement entry points (bench.py, chip_smoke.py, tools/) refuse to run
without a GPU rather than fall back to the CPU: a CPU number printed under
a device metric would be read as the card's.
"""

from __future__ import annotations

import subprocess


class NoGpuError(RuntimeError):
    """JAX found no GPU."""


def require_gpu():
    """The first JAX device, or NoGpuError naming what JAX found instead."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:  # a requested platform failed to initialize
        raise NoGpuError(f"no GPU: JAX could not initialize a backend ({e})")
    if devices[0].platform != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's devices are {devices} (platform "
            f"'{devices[0].platform}'); this measurement needs an NVIDIA GPU"
        )
    return devices[0]


def nvidia_smi_line() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def describe(device) -> dict:
    """What every printed result carries: platform, kind, count, card."""
    import jax

    return {
        "platform": device.platform,
        "kind": device.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": nvidia_smi_line(),
    }
