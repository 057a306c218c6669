"""Serving walkthrough: continuous batching with every serving feature.

    python examples/serving_pipeline.py [artifact.npz]

Demonstrates (the C17 notebook analogue for the serving stack):
- multi-image requests (`submit_many`: one future per client batch);
- pipelined dispatch (batch t+1 launches while batch t's device fetch
  is in flight — pipeline_depth=2 default);
- automatic packed-word transport for bipolar (MLP) engines
  (32× smaller host→device transfer);
- oversized-request splitting (one giant request never forces a new
  jit bucket);
- the stats surface (requests vs images vs batches, p50/p99);
- the latency tier (adaptive_wait: a lone request at an idle server
  dispatches immediately instead of waiting out max_wait_ms) and bucket
  warmup (a warmed server never pays a first-request jit compile).

Runs on whatever backend JAX has (a GPU in production, the CPU in
tests — same results either way, SURVEY.md §4.1).
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from bnn_pynq_tpu.runtime.engine import InferenceEngine
from bnn_pynq_tpu.runtime.serving import BatchingServer


def main():
    artifact = sys.argv[1] if len(sys.argv) > 1 else "pretrained/sfc-w1a1.npz"
    engine = InferenceEngine.from_artifact(artifact, route="xla",
                                           batch_buckets=(1, 64, 256))
    print(f"engine: {engine.config.name} runtime={engine.runtime}")

    for b in (1, 64, 256):        # warm every bucket's serving program
        engine.warmup(b)
    server = BatchingServer(engine, max_batch=256, max_wait_ms=2.0)
    print(f"packed_transport={server.packed_transport} "
          f"pipeline_depth={server.pipeline_depth} "
          f"adaptive_wait={server.adaptive_wait}")

    rng = np.random.default_rng(0)
    shape = (engine.config.input_shape
             if engine.config.input_kind == "int8"
             else (int(np.prod(engine.config.input_shape)),))

    try:
        # single-image requests (the reference's `inference` contract).
        # generous first timeout: the first request compiles the jitted
        # program
        img = rng.integers(0, 256, size=(1,) + shape).astype(np.uint8)
        one = server.submit(engine.prepare(img)[0]).result(600)
        print(f"single request -> class {one}")

        # one client batch = one request = one future
        imgs = rng.integers(0, 256, size=(100,) + shape).astype(np.uint8)
        t0 = time.perf_counter()
        classes = server.submit_many(engine.prepare(imgs)).result(600)
        dt = time.perf_counter() - t0
        print(f"batch request: 100 images in {dt*1e3:.1f} ms "
              f"-> {np.bincount(classes, minlength=10).tolist()}")

        # oversized request: split transparently into max_batch chunks
        big = rng.integers(0, 256, size=(700,) + shape).astype(np.uint8)
        classes = server.submit_many(engine.prepare(big)).result(300)
        assert len(classes) == 700
        print(f"oversized request: 700 images -> {len(classes)} results "
              "(split into max_batch chunks internally)")

        print("stats:", server.stats.summary())
    finally:
        server.stop()


if __name__ == "__main__":
    main()
