"""Scaling-efficiency benchmark harness (BASELINE.md: ≥80% at 2 hosts).

Measures tensor-parallel + data-parallel throughput of a compiled network
at increasing device counts on whatever devices are available (GPUs when
present; the virtual CPU mesh only validates the harness logic). Emits a JSON report of images/s and efficiency vs ideal linear
scaling from the 1-device point.

    python -m bnn_pynq_tpu.parallel.benchmark --network cnv-w1a1
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np


def measure_tp_scaling(compiled, device_counts: Optional[List[int]] = None,
                       batch_per_device: int = 256, iters: int = 10,
                       data_axis: bool = True):
    import jax
    from bnn_pynq_tpu.parallel.mesh import make_mesh
    from bnn_pynq_tpu.parallel.tp import TPInferenceEngine

    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16) if d <= n_avail]
    cfg = compiled.config
    rng = np.random.default_rng(0)
    results = []
    for nd in device_counts:
        if data_axis and nd > 1:
            data, model = 2, nd // 2
        else:
            data, model = 1, nd
        mesh = make_mesh(data=data, model=model,
                         devices=jax.devices()[:nd])
        engine = TPInferenceEngine(compiled, mesh)
        batch = batch_per_device * nd
        if cfg.input_kind == "bipolar":
            x = rng.choice([-1, 1], size=(
                batch, int(np.prod(cfg.input_shape)))).astype(np.int8)
        else:
            x = rng.integers(-128, 128,
                             size=(batch,) + cfg.input_shape).astype(np.int8)
        engine.logits(x)  # compile
        t0 = time.perf_counter()
        outs = [engine._fn(engine.params, engine.out_scale, engine.out_bias,
                           x) for _ in range(iters)]
        jax.block_until_ready(outs)
        dt = (time.perf_counter() - t0) / iters
        results.append({"devices": nd, "mesh": f"{data}x{model}",
                        "batch": batch, "images_per_sec": batch / dt})
    base = results[0]["images_per_sec"]
    for r in results:
        r["scaling_efficiency"] = r["images_per_sec"] / (base * r["devices"])
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="cnv-w1a1")
    ap.add_argument("--batch-per-device", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
    from bnn_pynq_tpu.models import get_config
    from bnn_pynq_tpu.models.network import init_random_params

    cfg = get_config(args.network)
    layers = init_random_params(cfg, seed=0)
    compiled = CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers],
        out_scale=np.ones(cfg.num_classes, np.float32),
        out_bias=np.zeros(cfg.num_classes, np.float32))
    for r in measure_tp_scaling(compiled,
                                batch_per_device=args.batch_per_device,
                                iters=args.iters):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
