"""Float model ⇔ integer engine equivalence — the exactness gate flagged in
SURVEY.md §7 hard-part #2 (BN folding ceil/sign conventions).

Strategy: random float params with aggressively perturbed BatchNorm
(including negative and zero slopes to exercise the flip and sentinel
paths), then assert the compiled integer engine reproduces the float
model's logits (up to float32 epsilon) and argmax on every input.
"""

import numpy as np
import jax
import pytest
from flax import traverse_util
from flax.core import freeze, unfreeze

from bnn_pynq_tpu.models.config import (ConvSpec, DenseSpec, NetworkConfig,
                                        PoolSpec)
from bnn_pynq_tpu.compiler import (compile_network, load_artifact,
                                   save_artifact)
from bnn_pynq_tpu.runtime.engine import InferenceEngine
from bnn_pynq_tpu.train import data as data_mod
from bnn_pynq_tpu.train.model import QuantNet


def mini_mlp(wbits, abits):
    return NetworkConfig(
        name=f"sfc-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="bipolar", input_shape=(8, 8, 1),
        layers=(DenseSpec(64), DenseSpec(32), DenseSpec(10)),
        num_classes=10, dataset="mnist")


def mini_cnv(wbits, abits):
    return NetworkConfig(
        name=f"cnv-w{wbits}a{abits}", wbits=wbits, abits=abits,
        input_kind="int8", input_shape=(10, 10, 3),
        layers=(ConvSpec(16), PoolSpec(), ConvSpec(32),
                DenseSpec(24), DenseSpec(10)),
        num_classes=10, dataset="cifar10")


def init_perturbed(cfg, seed):
    """Init params and aggressively perturb BN to hit flip/sentinel paths."""
    model = QuantNet(cfg)
    shape = ((2, int(np.prod(cfg.input_shape)))
             if cfg.input_kind == "bipolar" else (2,) + cfg.input_shape)
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros(shape, np.float32), train=False)
    params = unfreeze(variables["params"])
    stats = unfreeze(variables["batch_stats"])
    rng = np.random.default_rng(seed)
    flat_p = traverse_util.flatten_dict(params)
    for path, leaf in flat_p.items():
        if path[-1] == "scale":
            v = rng.normal(1.0, 0.6, size=leaf.shape).astype(np.float32)
            v[0] = -0.5          # guaranteed negative slope channel
            if leaf.shape[0] > 1:
                v[1] = 0.0       # guaranteed degenerate channel
            flat_p[path] = v
        elif path[-1] == "bias":
            flat_p[path] = rng.normal(0.0, 1.0, size=leaf.shape).astype(np.float32)
    params = traverse_util.unflatten_dict(flat_p)
    flat_s = traverse_util.flatten_dict(stats)
    for path, leaf in flat_s.items():
        if path[-1] == "mean":
            flat_s[path] = rng.normal(0.0, 3.0, size=leaf.shape).astype(np.float32)
        elif path[-1] == "var":
            flat_s[path] = np.abs(
                rng.normal(1.0, 0.5, size=leaf.shape)).astype(np.float32) + 0.01
    stats = traverse_util.unflatten_dict(flat_s)
    return model, freeze(params), freeze(stats)


def _inputs(cfg, rng, b=16):
    x_uint8 = rng.integers(0, 256, size=(b,) + cfg.input_shape).astype(np.uint8)
    x_float = data_mod.train_inputs(cfg.dataset, x_uint8, cfg.input_kind)
    return x_uint8, x_float


@pytest.mark.parametrize("make_cfg,wbits,abits", [
    (mini_mlp, 1, 1), (mini_mlp, 1, 2),
    (mini_cnv, 1, 1), (mini_cnv, 1, 2), (mini_cnv, 2, 2),
])
def test_float_vs_integer_engine(make_cfg, wbits, abits):
    cfg = make_cfg(wbits, abits)
    model, params, stats = init_perturbed(cfg, seed=42 + wbits * 10 + abits)
    rng = np.random.default_rng(0)
    x_uint8, x_float = _inputs(cfg, rng)

    float_logits = np.asarray(
        model.apply({"params": params, "batch_stats": stats},
                    x_float, train=False))

    engine = InferenceEngine.from_training(cfg, params, stats, runtime="ref")
    int_logits = engine.logits(x_uint8)

    np.testing.assert_allclose(int_logits, float_logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(int_logits.argmax(-1), float_logits.argmax(-1))


@pytest.mark.parametrize("make_cfg,wbits,abits", [
    (mini_mlp, 1, 1), (mini_cnv, 1, 2), (mini_cnv, 2, 2),
])
def test_xla_route_matches_ref_runtime(make_cfg, wbits, abits):
    cfg = make_cfg(wbits, abits)
    model, params, stats = init_perturbed(cfg, seed=6)
    rng = np.random.default_rng(1)
    x_uint8, _ = _inputs(cfg, rng, b=8)
    compiled = compile_network(cfg, params, stats)
    e_ref = InferenceEngine(compiled, runtime="ref")
    e_xla = InferenceEngine(compiled, runtime="device", route="xla")
    np.testing.assert_array_equal(e_ref.logits(x_uint8), e_xla.logits(x_uint8))


@pytest.mark.parametrize("make_cfg,wbits,abits", [
    (mini_cnv, 1, 1), (mini_cnv, 1, 2), (mini_cnv, 2, 2),
])
def test_xlaconv_route_matches_ref_runtime(make_cfg, wbits, abits):
    """The native bf16 conv path must be bit-exact with the integer
    reference (exactness argument: models/network.py _conv_bf16_exact)."""
    cfg = make_cfg(wbits, abits)
    model, params, stats = init_perturbed(cfg, seed=7)
    rng = np.random.default_rng(2)
    x_uint8, _ = _inputs(cfg, rng, b=8)
    compiled = compile_network(cfg, params, stats)
    e_ref = InferenceEngine(compiled, runtime="ref")
    e_nc = InferenceEngine(compiled, runtime="device", route="xlaconv")
    np.testing.assert_array_equal(e_ref.logits(x_uint8), e_nc.logits(x_uint8))


def test_artifact_roundtrip(tmp_path):
    cfg = mini_mlp(1, 1)
    model, params, stats = init_perturbed(cfg, seed=9)
    compiled = compile_network(cfg, params, stats, meta={"val_acc": 0.5})
    path = str(tmp_path / "mini.npz")
    save_artifact(path, compiled)
    loaded = load_artifact(path)
    assert loaded.meta["val_acc"] == 0.5
    rng = np.random.default_rng(2)
    x_uint8, _ = _inputs(cfg, rng, b=8)
    a = InferenceEngine(compiled, runtime="ref").logits(x_uint8)
    b = InferenceEngine(loaded, runtime="ref").logits(x_uint8)
    np.testing.assert_array_equal(a, b)


def test_negative_gamma_exercised():
    cfg = mini_mlp(1, 1)
    model, params, stats = init_perturbed(cfg, seed=3)
    flat = traverse_util.flatten_dict(unfreeze(params))
    negs = sum((np.asarray(v) < 0).sum()
               for k, v in flat.items() if k[-1] == "scale")
    assert negs > 0
