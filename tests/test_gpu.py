"""Tests that need an NVIDIA GPU (`gpu` marker): they skip on the CPU test
backend and run on the card through `python chip_smoke.py`.

No float32 matmul exists on the inference path (int8 GEMMs with int32
accumulation, bf16 convolutions with float32 accumulation of exact
integers), so TF32 cannot enter any result checked here.
"""

import numpy as np
import pytest

import chip_smoke
from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
from bnn_pynq_tpu.models import get_config
from bnn_pynq_tpu.models.network import init_random_params


def _compiled(name, seed=0):
    cfg = get_config(name)
    layers = init_random_params(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    return CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers],
        out_scale=rng.uniform(0.5, 2, cfg.num_classes).astype(np.float32),
        out_bias=rng.normal(size=cfg.num_classes).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sfc-w1a2", "cnv-w1a2", "cnv-w2a2-gtsrb"])
@pytest.mark.parametrize("route", ["s2d", "xla", "xlaconv"])
def test_device_runtime_bit_exact_on_gpu(name, route):
    compiled = _compiled(name)
    images = chip_smoke.random_images(compiled.config, 32, seed=1)
    report = chip_smoke.check_exact(compiled, route, images)
    assert report["acc_exact"] and report["classes_exact"]


@pytest.mark.gpu
@pytest.mark.parametrize("name,route", [
    ("cnv-w1a1", "s2d"), ("cnv-w1a1", "xla"), ("lfc-w1a1", "xla")])
def test_every_dot_lowers_to_a_gemm(name, route):
    """No dot of the production programs may fall back to XLA's naive
    loop emitter (an int16-accumulating dot did, at ~50x the time)."""
    import jax
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    eng = InferenceEngine(_compiled(name), route=route, batch_buckets=(64,))
    x = jax.device_put(np.zeros((64,) + (
        (int(np.prod(eng.config.input_shape)),)
        if eng.config.input_kind == "bipolar" else eng.config.input_shape),
        np.int8))
    hlo = eng._fn.lower(eng.params, eng.out_scale, eng.out_bias,
                        x).compile().as_text()
    summary = chip_smoke.hlo_dot_summary(hlo)
    assert summary["all_gemm"], summary


@pytest.mark.gpu
def test_peak_table_knows_this_card():
    from bnn_pynq_tpu.utils.metrics import chip_specs
    assert chip_specs().int8_ops_per_sec > 0
