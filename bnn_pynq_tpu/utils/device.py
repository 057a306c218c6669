"""What card a measurement ran on, read without touching JAX.

`nvidia-smi` runs as a child process, so the caller's JAX state (and the
card's memory) is untouched; a card set below its maximum power limit
runs slower under load, so every kept number carries this string.
"""

from __future__ import annotations

import subprocess
from typing import Optional


def card_name_and_power() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` for every visible card,
    one line each (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), or None where
    there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip() or None
