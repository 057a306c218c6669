"""Every network config × every route of the `device` runtime against the
`ref` golden twin, through the engine at batch 3 (the engine pads it to
its 16-image bucket, so padding is covered too)."""

import functools

import numpy as np
import pytest

from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
from bnn_pynq_tpu.models import AVAILABLE_CONFIGS, get_config
from bnn_pynq_tpu.models.network import init_random_params
from bnn_pynq_tpu.runtime.engine import ROUTES, InferenceEngine

BATCH = 3


@functools.lru_cache(maxsize=None)
def _case(name):
    cfg = get_config(name)
    layers = init_random_params(cfg, seed=5)
    rng = np.random.default_rng(5)
    compiled = CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers],
        out_scale=rng.uniform(0.5, 2, cfg.num_classes).astype(np.float32),
        out_bias=rng.normal(size=cfg.num_classes).astype(np.float32))
    images = rng.integers(0, 256, size=(BATCH,) + cfg.input_shape,
                          dtype=np.uint8)
    want = InferenceEngine(compiled, runtime="ref").logits(images)
    return compiled, images, want


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(AVAILABLE_CONFIGS))
def test_route_matches_ref(name, route):
    compiled, images, want = _case(name)
    eng = InferenceEngine(compiled, runtime="device", route=route)
    assert eng._bucket(BATCH) == 16
    got = eng.logits(images)
    assert got.shape == (BATCH, compiled.config.num_classes)
    np.testing.assert_array_equal(got, want)
