"""Backend identification for the GPU kernel path.

The Pallas (Triton) tracking-scan kernel compiles only for a GPU; every
other backend runs the ``lax.scan`` implementation (bit-identical by
contract). This is the one place that decides which is which.
"""

from __future__ import annotations

__all__ = ["card_name_and_power_limit", "is_gpu_backend"]


def is_gpu_backend() -> bool:
    """True when the default jax backend is a GPU."""
    import jax

    return jax.default_backend() == "gpu"


def card_name_and_power_limit() -> str:
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them. Every reported device number goes out beside this line:
    a card set below its maximum power runs slower under load.

    Raises ``RuntimeError`` where there is no NVIDIA driver.
    """
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"nvidia-smi unavailable: {exc}") from exc
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()
