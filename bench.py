"""Headline benchmark: CNV-W1A1 CIFAR-10 inference throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"} plus the
device it ran on: platform, device_kind and device count as JAX reports
them, and the card's name and power limit from nvidia-smi.
Baseline: the reference's published CNV-max throughput, 21_900 images/s
(FINN paper, ZC706 @200 MHz — BASELINE.md).

The parent process never touches the card: the measurement runs in one
child process with a hard timeout, so a wedged device yields an error line
instead of a hang. Without a GPU the child refuses to measure and the
script exits non-zero; there is no fallback route or device.
"""

import json
import os
import subprocess
import sys

BASELINE_IMAGES_PER_SEC = 21_900.0
METRIC = "cnv-w1a1_cifar10_images_per_sec_1gpu"
ROUTE = "s2d"
BATCH = 1024
INNER_TIMEOUT_S = 1500


def bench_cnv_w1a1(batch: int = BATCH, iters: int = 200):
    """Runs in the child: returns (images_per_sec, device fields)."""
    import numpy as np
    import jax
    from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
    from bnn_pynq_tpu.models import get_config
    from bnn_pynq_tpu.models.network import init_random_params
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    from bnn_pynq_tpu.utils.compile_cache import enable_compile_cache
    from bnn_pynq_tpu.utils.profiling import steady_state_stats

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform!r}")

    cfg = get_config("cnv-w1a1")
    layers = init_random_params(cfg, seed=0)
    ncls = cfg.num_classes
    compiled = CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers],
        out_scale=np.ones(ncls, np.float32),
        out_bias=np.zeros(ncls, np.float32))
    engine = InferenceEngine(compiled, route=ROUTE, batch_buckets=(batch,))

    rng = np.random.default_rng(0)
    xd = jax.device_put(engine.prepare(rng.integers(
        0, 256, size=(batch,) + cfg.input_shape).astype(np.uint8)))
    sec, _ = steady_state_stats(
        lambda: engine._fn(engine.params, engine.out_scale,
                           engine.out_bias, xd),
        iters=iters, repeats=5, warmup=3)
    return batch / sec, device


def main() -> int:
    from bnn_pynq_tpu.utils.device import card_name_and_power

    root = os.path.dirname(os.path.abspath(__file__))
    payload = {"metric": METRIC, "unit": "images/s", "route": ROUTE,
               "batch": BATCH, "card": card_name_and_power()}
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--inner"],
            capture_output=True, text=True, timeout=INNER_TIMEOUT_S,
            cwd=root)
        lines = [l for l in (proc.stdout or "").splitlines()
                 if l.startswith("{")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError((proc.stderr or "no result")[-300:])
        inner = json.loads(lines[-1])
    except (subprocess.TimeoutExpired, RuntimeError) as e:
        payload.update(value=None, error=str(e))
        print(json.dumps(payload))
        return 1
    imgs = inner.pop("images_per_sec")
    payload.update(value=imgs, vs_baseline=imgs / BASELINE_IMAGES_PER_SEC,
                   **inner)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    if "--inner" in sys.argv:
        imgs, device = bench_cnv_w1a1()
        print(json.dumps({"images_per_sec": imgs, **device}))
        sys.exit(0)
    sys.exit(main())
