"""Multi-chip logic on the virtual 8-device CPU mesh (SURVEY.md §4.4)."""

import numpy as np
import jax
import optax
import pytest

from bnn_pynq_tpu.compiler import compile_network
from bnn_pynq_tpu.parallel.mesh import make_mesh
from bnn_pynq_tpu.parallel.tp import TPInferenceEngine, make_tp_forward
from bnn_pynq_tpu.parallel.train_sharded import (init_sharded,
                                                 make_sharded_train_step)
from bnn_pynq_tpu.runtime.engine import InferenceEngine
from tests.test_finnthesizer import init_perturbed, mini_cnv, mini_mlp


def test_mesh_shapes():
    mesh = make_mesh(data=2, model=4)
    assert mesh.shape == {"data": 2, "model": 4}
    mesh2 = make_mesh(model=8)
    assert mesh2.shape == {"data": 1, "model": 8}


@pytest.mark.parametrize("make_cfg,wbits,abits", [
    (mini_mlp, 1, 1), (mini_cnv, 1, 1), (mini_cnv, 2, 2),
])
def test_tp_inference_matches_single_device(make_cfg, wbits, abits):
    cfg = make_cfg(wbits, abits)
    model, params, stats = init_perturbed(cfg, seed=11)
    compiled = compile_network(cfg, params, stats)
    rng = np.random.default_rng(0)
    x_uint8 = rng.integers(0, 256, size=(16,) + cfg.input_shape).astype(np.uint8)

    single = InferenceEngine(compiled, runtime="ref")
    expected = single.logits(x_uint8)

    mesh = make_mesh(data=2, model=4)
    tp = TPInferenceEngine(compiled, mesh)
    got = tp.logits(single.prepare(x_uint8))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), expected.argmax(-1))


def test_tp_pure_model_axis():
    cfg = mini_mlp(1, 1)
    model, params, stats = init_perturbed(cfg, seed=2)
    compiled = compile_network(cfg, params, stats)
    rng = np.random.default_rng(3)
    x_uint8 = rng.integers(0, 256, size=(8,) + cfg.input_shape).astype(np.uint8)
    single = InferenceEngine(compiled, runtime="ref")
    mesh = make_mesh(data=1, model=8)
    tp = TPInferenceEngine(compiled, mesh)
    np.testing.assert_allclose(tp.logits(single.prepare(x_uint8)),
                               single.logits(x_uint8), rtol=1e-5, atol=1e-5)


def test_scaling_harness_runs():
    from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
    from bnn_pynq_tpu.models import get_config
    from bnn_pynq_tpu.models.network import init_random_params
    from bnn_pynq_tpu.parallel.benchmark import measure_tp_scaling
    cfg = get_config("sfc-w1a1")
    layers = init_random_params(cfg, seed=0)
    compiled = CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers],
        out_scale=np.ones(10, np.float32), out_bias=np.zeros(10, np.float32))
    rows = measure_tp_scaling(compiled, device_counts=[1, 2],
                              batch_per_device=8, iters=1)
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["images_per_sec"] > 0 for r in rows)
    assert rows[0]["scaling_efficiency"] == 1.0


def test_gspmd_engine_matches_single_device():
    from bnn_pynq_tpu.parallel.tp import make_gspmd_engine
    cfg = mini_cnv(1, 1)
    model, params, stats = init_perturbed(cfg, seed=13)
    compiled = compile_network(cfg, params, stats)
    rng = np.random.default_rng(1)
    x_uint8 = rng.integers(0, 256, size=(16,) + cfg.input_shape).astype(np.uint8)
    single = InferenceEngine(compiled, runtime="ref")
    expected = single.logits(x_uint8)
    mesh = make_mesh(data=2, model=4)
    logits_fn = make_gspmd_engine(compiled, mesh)
    got = logits_fn(single.prepare(x_uint8))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


def test_sharded_train_step_runs_and_matches_unsharded():
    cfg = mini_cnv(1, 1)
    mesh = make_mesh(data=2, model=4)
    model, params, stats, opt_state, tx = init_sharded(cfg, mesh, seed=0)
    step = make_sharded_train_step(cfg, mesh, tx)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8,) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, size=8).astype(np.int32)
    p2, s2, o2, loss_sharded = step(params, stats, opt_state, x, y)
    assert np.isfinite(float(loss_sharded))

    # unsharded single-device reference step
    from bnn_pynq_tpu.train.trainer import make_train_step
    import jax.tree_util as jtu
    params_host = jax.device_get(params)
    stats_host = jax.device_get(stats)
    tx2 = optax.adam(1e-3)
    o0 = tx2.init(params_host)
    base = make_train_step(cfg, model, tx2)
    p_ref, s_ref, _, loss_ref = base(params_host, stats_host, o0, x, y)
    np.testing.assert_allclose(float(loss_sharded), float(loss_ref),
                               rtol=1e-5, atol=1e-6)
    # distributed reductions change float summation order; allow small
    # elementwise drift (Adam's rsqrt amplifies tiny grad differences)
    for a, b in zip(jtu.tree_leaves(jax.device_get(p2)),
                    jtu.tree_leaves(p_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-2, atol=2e-3)


def test_sharded_epoch_scan_matches_stepwise():
    """The dp×tp epoch scan (one jitted dispatch) must reproduce the
    per-step sharded path exactly over the same batch sequence."""
    from bnn_pynq_tpu.parallel.train_sharded import make_sharded_epoch_fn
    cfg = mini_cnv(1, 1)
    mesh = make_mesh(data=2, model=4)
    model, params, stats, opt_state, tx = init_sharded(cfg, mesh, seed=3)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(3, 4) + cfg.input_shape).astype(np.float32)
    ys = rng.integers(0, cfg.num_classes, size=(3, 4)).astype(np.int32)

    step = make_sharded_train_step(cfg, mesh, tx)
    p, s, o = params, stats, opt_state
    step_losses = []
    for i in range(3):
        p, s, o, loss = step(p, s, o, xs[i], ys[i])
        step_losses.append(float(loss))

    epoch_fn = make_sharded_epoch_fn(cfg, mesh, tx)
    p2, s2, o2, losses = epoch_fn(params, stats, opt_state, xs, ys)
    np.testing.assert_allclose(np.asarray(losses), step_losses,
                               rtol=1e-5, atol=1e-6)
    flat_a = jax.tree_util.tree_leaves(p)
    flat_b = jax.tree_util.tree_leaves(p2)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(6, 16), (2, 5, 5, 8)])
def test_gather_channels_matches_tiled_all_gather(shape):
    """gather_channels is the tiled minor-axis all-gather, shards in
    device order, built from a leading-axis gather + transpose."""
    from jax.sharding import PartitionSpec as P
    from bnn_pynq_tpu.parallel.mesh import gather_channels
    mesh = make_mesh(data=2, model=4)
    x = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    spec = P("data", *([None] * (len(shape) - 2)), "model")

    def both(xl):
        want = jax.lax.all_gather(xl, "model", axis=xl.ndim - 1, tiled=True)
        return gather_channels(xl), want

    got, want = jax.jit(jax.shard_map(
        both, mesh=mesh, in_specs=(spec,), out_specs=(P("data"), P("data")),
        check_vma=False))(x)
    np.testing.assert_array_equal(np.asarray(got), x)
    np.testing.assert_array_equal(np.asarray(want), x)
