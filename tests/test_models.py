"""Network plans and the golden reference forward (SURVEY.md §4.1). The
production path is checked against this forward per config and route in
tests/test_routes.py."""

import numpy as np

from bnn_pynq_tpu.models import get_config
from bnn_pynq_tpu.models.network import (forward, init_random_params,
                                         make_plan)


def _bipolar_batch(rng, b):
    return rng.choice([-1, 1], size=(b, 784)).astype(np.int8)


def _image_batch(rng, b, shape):
    return rng.integers(-128, 128, size=(b,) + shape).astype(np.int8)


def test_plan_shapes_cnv():
    cfg = get_config("cnv-w1a1")
    plan = make_plan(cfg)
    kinds = [p.kind for p in plan]
    assert kinds == ["conv_int8", "conv", "pool", "conv", "conv", "pool",
                     "conv", "conv", "dense", "dense", "dense"]
    # spatial trace 32→30→28→14→12→10→5→3→1 ⇒ final dense K=256, 512, 512
    dense_ks = [p.k for p in plan if p.kind == "dense"]
    assert dense_ks == [256, 512, 512]
    conv_ks = [p.k for p in plan if p.kind in ("conv", "conv_int8")]
    assert conv_ks == [27, 576, 576, 1152, 1152, 2304]


def test_gtsrb_classes():
    cfg = get_config("cnv-w2a2-gtsrb")
    params = init_random_params(cfg, seed=1)
    rng = np.random.default_rng(0)
    x = _image_batch(rng, 1, cfg.input_shape)
    logits = np.asarray(forward(cfg, params, x))
    assert logits.shape == (1, 43)


def test_forward_is_jittable():
    import jax
    cfg = get_config("sfc-w1a1")
    params = init_random_params(cfg, seed=0)
    fn = jax.jit(lambda p, x: forward(cfg, p, x))
    rng = np.random.default_rng(0)
    x = _bipolar_batch(rng, 8)
    out = np.asarray(fn(params, x))
    base = np.asarray(forward(cfg, params, x))
    assert out.shape == (8, 10) and out.dtype == np.int32
    np.testing.assert_array_equal(out, base)
