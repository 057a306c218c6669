"""Structured metrics + roofline accounting (SURVEY.md §5.1/§5.5 rebuild:
the reference only had print-based usecPerImage; here every run can emit
machine-readable JSON and compare against hardware ceilings).

Peak rates live in one table keyed by `device_kind` as JAX reports it. A
device that is not in the table is an error, never a default.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class ChipSpec:
    device_kind: str
    int8_ops_per_sec: float      # dense int8 tensor-core ops (2 per MAC)
    bf16_flops_per_sec: float    # dense bf16 tensor-core FLOP/s
    hbm_bytes_per_sec: float
    source: str


# Published dense peaks (no sparsity), at the part's full power limit; a
# card capped below it cannot hold its top clock under load, so report
# `nvidia-smi --query-gpu=power.limit` beside any share of these.
_CHIPS = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        "NVIDIA H100 80GB HBM3", 1979e12, 989e12, 3.35e12,
        "NVIDIA H100 Tensor Core GPU data sheet, SXM5 column (700 W)"),
}


def chip_specs(device_kind: Optional[str] = None) -> ChipSpec:
    """Peaks of `device_kind` (default: the first JAX device's). Raises
    KeyError for a device the table does not know."""
    if device_kind is None:
        import jax
        device_kind = jax.devices()[0].device_kind
    try:
        return _CHIPS[device_kind]
    except KeyError:
        raise KeyError(f"no peak rates for device_kind {device_kind!r}; "
                       f"known: {sorted(_CHIPS)}") from None


def network_macs(config) -> int:
    """Integer MACs per image for a NetworkConfig (conv + dense layers)."""
    from bnn_pynq_tpu.models.network import make_plan
    h, w, _ = config.input_shape
    total = 0
    for lp in make_plan(config):
        if lp.kind == "pool":
            h //= lp.window
            w //= lp.window
        elif lp.kind in ("conv", "conv_int8"):
            oh = (h - lp.kernel) // lp.stride + 1
            ow = (w - lp.kernel) // lp.stride + 1
            total += oh * ow * lp.k * lp.n
            h, w = oh, ow
        else:
            total += lp.k * lp.n
            h = w = 1
    return total


def int8_roofline_images_per_sec(config,
                                 chip: Optional[ChipSpec] = None) -> float:
    """Speed-of-light images/s if every MAC ran at the chip's dense int8
    tensor-core peak (the production path runs every layer as an int8 or
    bf16-exact GEMM/convolution)."""
    chip = chip or chip_specs()
    return chip.int8_ops_per_sec / (2 * network_macs(config))


def roofline_fraction(config, images_per_sec: float,
                      chip: Optional[ChipSpec] = None) -> float:
    return images_per_sec / int8_roofline_images_per_sec(config, chip)


@dataclass
class RunMetrics:
    """Accumulates a run's metrics and writes one JSON file/line."""
    name: str
    values: Dict[str, float] = field(default_factory=dict)
    t0: float = field(default_factory=time.time)

    def record(self, **kw):
        self.values.update({k: float(v) for k, v in kw.items()})
        return self

    def emit(self, path: Optional[str] = None) -> str:
        payload = {"run": self.name, "wall_s": time.time() - self.t0,
                   **self.values}
        line = json.dumps(payload)
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a") as f:
                f.write(line + "\n")
        return line
