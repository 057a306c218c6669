"""Device mesh construction (SURVEY.md §2 parallelism table: the
replacement for the reference's single-board PE/SIMD spatial parallelism is
a ('data', 'model') mesh — batch over 'data', weight output channels over
'model'. On a host whose cards are joined all to all by NVLink the mesh
shape follows the algorithm alone)."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh


def make_mesh(data: Optional[int] = None, model: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'model') mesh.

    Defaults: all devices on the data axis (pure DP) unless `model` is
    given. data*model must equal the device count used.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if model is None and data is None:
        data, model = n, 1
    elif model is None:
        model = n // data
    elif data is None:
        data = n // model
    if data * model != n:
        devices = devices[: data * model]
        if data * model > n:
            raise ValueError(f"mesh {data}x{model} needs {data * model} "
                             f"devices, have {n}")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def gather_channels(x, axis_name: str = "model"):
    """Inside shard_map: all-gather the last (channel) axis of `x` over
    `axis_name`, shards in device order — what
    `lax.all_gather(x, axis_name, axis=-1, tiled=True)` means.

    It gathers along a new leading axis and moves that axis next to the
    channels with an explicit transpose. On 4 H100s (jax 0.9) the tiled
    minor-axis form feeding an int8 GEMM returned wrong values
    ([256, 512]·[512, 10]: 2548 of 2560 wrong; an optimization barrier or
    an int32 gather did not help) while this form was exact (PERF.md,
    PR 1)."""
    g = jax.lax.all_gather(x, axis_name, axis=0, tiled=False)  # [d, ..., c]
    return jnp.moveaxis(g, 0, -2).reshape(x.shape[:-1] + (-1,))
