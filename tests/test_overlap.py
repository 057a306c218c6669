"""Overlapped-TP engine tests (SURVEY.md §5.8 collective/compute overlap).

Teeth on a single-host CI (2 CPU cores — wall-clock "efficiency" of 8
virtual devices is physics-free here):
1. exact logits equality vs the single-device reference engine;
2. HLO STRUCTURE: the compiled program must contain collective-permute
   (the ring) and must NOT contain all-gather between hidden layers —
   i.e. the overlap transformation is provably in the compiled artifact;
3. a wall-clock ≥80% weak-scaling assertion that runs only on ≥2 GPUs
   (BASELINE.md 2-host target; `gpu` marker).
"""

import numpy as np
import pytest
import jax

from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
from bnn_pynq_tpu.models import get_config
from bnn_pynq_tpu.models.network import init_random_params
from bnn_pynq_tpu.parallel.mesh import make_mesh
from bnn_pynq_tpu.parallel.overlap import OverlapTPEngine
from bnn_pynq_tpu.runtime.engine import InferenceEngine


def _compiled(name="lfc-w1a1"):
    cfg = get_config(name)
    layers = init_random_params(cfg, seed=0)
    return CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers],
        out_scale=np.ones(cfg.num_classes, np.float32),
        out_bias=np.zeros(cfg.num_classes, np.float32))


@pytest.mark.parametrize("data,model", [(1, 8), (2, 4), (4, 2)])
def test_overlap_tp_matches_single_device(data, model):
    compiled = _compiled()
    mesh = make_mesh(data=data, model=model)
    eng = OverlapTPEngine(compiled, mesh)
    ref = InferenceEngine(compiled, runtime="ref", route="xla",
                          batch_buckets=(64,))
    rng = np.random.default_rng(0)
    x = rng.choice([-1, 1], size=(64, 784)).astype(np.int8)
    got = eng.logits(x)
    want = ref.logits(x, prepared=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_overlap_tp_hlo_structure():
    """The compiled module must ring (collective-permute) instead of
    gathering between hidden layers, and psum only the tiny logits."""
    compiled = _compiled()
    mesh = make_mesh(data=1, model=8)
    eng = OverlapTPEngine(compiled, mesh)
    x = jax.device_put(
        np.ones((64, 784), np.int8),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data")))
    hlo = eng._fn.lower(tuple(eng.weights), tuple(eng.thrs), eng.out_scale,
                        eng.out_bias, x).compile().as_text()
    assert "collective-permute" in hlo, "ring ppermute missing"
    # the only all-* collective allowed is the final logits psum
    # (all-reduce); activation all-gathers would mark a blocking layer
    # boundary like the non-overlap engine's
    assert "all-gather" not in hlo, "blocking activation all-gather present"


def test_arm_auto_selection_exact_and_recorded():
    """arm='auto' measures ring vs blocking on the actual (network, mesh),
    keeps the faster, and records the decision. Whichever arm wins,
    logits must stay exact vs the single-device reference."""
    compiled = _compiled()
    mesh = make_mesh(data=2, model=4)
    eng = OverlapTPEngine(compiled, mesh, arm="auto", calib_iters=3)
    assert eng.arm in ("ring", "blocking")
    assert "measured ring" in eng.arm_reason
    assert eng.arm in repr(eng)
    ref = InferenceEngine(compiled, runtime="ref", route="xla",
                          batch_buckets=(32,))
    rng = np.random.default_rng(2)
    x = rng.choice([-1, 1], size=(32, 784)).astype(np.int8)
    np.testing.assert_allclose(eng.logits(x),
                               ref.logits(x, prepared=True),
                               rtol=1e-5, atol=1e-5)


def test_arm_forced_matches_blocking_kwarg():
    compiled = _compiled()
    mesh = make_mesh(data=2, model=4)
    assert OverlapTPEngine(compiled, mesh, blocking=True).arm == "blocking"
    assert OverlapTPEngine(compiled, mesh).arm == "ring"
    with pytest.raises(ValueError):
        OverlapTPEngine(compiled, mesh, arm="nope")


def test_overlap_tp_w1a2():
    compiled = _compiled("lfc-w1a2")
    mesh = make_mesh(data=2, model=4)
    eng = OverlapTPEngine(compiled, mesh)
    ref = InferenceEngine(compiled, runtime="ref", route="xla",
                          batch_buckets=(32,))
    rng = np.random.default_rng(1)
    x = rng.choice([-1, 1], size=(32, 784)).astype(np.int8)
    np.testing.assert_allclose(eng.logits(x),
                               ref.logits(x, prepared=True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_overlap_tp_scaling_efficiency_real_hw():
    """BASELINE.md: >=80% weak-scaling efficiency at 2 devices. Only
    meaningful on real cards with a real interconnect."""
    import time
    if len(jax.devices("gpu")) < 2:
        pytest.skip("needs >=2 GPUs")
    compiled = _compiled()
    per_dev = 4096
    times = {}
    for nd in (1, 2):
        mesh = make_mesh(data=1, model=nd, devices=jax.devices()[:nd])
        eng = OverlapTPEngine(compiled, mesh)
        rng = np.random.default_rng(0)
        x = rng.choice([-1, 1], size=(per_dev * nd, 784)).astype(np.int8)
        eng.logits(x)  # compile
        t0 = time.perf_counter()
        for _ in range(20):
            out = eng._fn(tuple(eng.weights), tuple(eng.thrs),
                          eng.out_scale, eng.out_bias, x)
        jax.block_until_ready(out)
        times[nd] = (time.perf_counter() - t0) / 20
    eff = times[1] / times[2]   # weak scaling: ideal = equal step time
    assert eff >= 0.8, f"2-device weak-scaling efficiency {eff:.2f} < 0.8"


# -- conv networks (round 3: BASELINE config #5 — CNV tensor-sharded) -------

def _compiled_mini_cnv(wbits=1, abits=1, seed=11):
    from bnn_pynq_tpu.compiler import compile_network
    from tests.test_finnthesizer import init_perturbed, mini_cnv
    cfg = mini_cnv(wbits, abits)
    _, params, stats = init_perturbed(cfg, seed=seed)
    return compile_network(cfg, params, stats)


@pytest.mark.parametrize("wbits,abits", [(1, 1), (2, 2)])
def test_overlap_tp_conv_matches_ref(wbits, abits):
    compiled = _compiled_mini_cnv(wbits, abits)
    mesh = make_mesh(data=2, model=4)
    eng = OverlapTPEngine(compiled, mesh)
    ref = InferenceEngine(compiled, runtime="ref", batch_buckets=(8,))
    rng = np.random.default_rng(2)
    x = rng.integers(-128, 128, size=(8, 10, 10, 3)).astype(np.int8)
    np.testing.assert_allclose(eng.logits(x), ref.logits(x, prepared=True),
                               rtol=1e-5, atol=1e-5)


def test_overlap_tp_conv_blocking_arm_matches_ref():
    """The blocking control arm (all-gather instead of rings) must agree
    bit-for-bit too — it is the baseline of every overlap-vs-blocking
    wall-clock comparison (`arm='auto'`)."""
    compiled = _compiled_mini_cnv(1, 1)
    mesh = make_mesh(data=1, model=4)
    eng = OverlapTPEngine(compiled, mesh, blocking=True)
    ref = InferenceEngine(compiled, runtime="ref", batch_buckets=(8,))
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, size=(8, 10, 10, 3)).astype(np.int8)
    np.testing.assert_allclose(eng.logits(x), ref.logits(x, prepared=True),
                               rtol=1e-5, atol=1e-5)


def test_overlap_tp_conv_hlo_structure():
    """The flagship CNV path must ring between layers: collective-permute
    present, NO all-gather anywhere (the blocking engine's signature),
    and exactly one all-reduce (the final logits psum)."""
    compiled = _compiled_mini_cnv(1, 1)
    mesh = make_mesh(data=1, model=4)
    eng = OverlapTPEngine(compiled, mesh)
    x = jax.device_put(
        np.ones((8, 10, 10, 3), np.int8),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data")))
    hlo = eng._fn.lower(tuple(eng.weights), tuple(eng.thrs), eng.out_scale,
                        eng.out_bias, x).compile().as_text()
    assert "collective-permute" in hlo, "conv ring ppermute missing"
    assert "all-gather" not in hlo, "blocking activation all-gather present"


def test_overlap_tp_conv_blocking_hlo_has_all_gather():
    """Sanity check of the control arm: blocking=True really does gather."""
    compiled = _compiled_mini_cnv(1, 1)
    mesh = make_mesh(data=1, model=4)
    eng = OverlapTPEngine(compiled, mesh, blocking=True)
    x = jax.device_put(
        np.ones((8, 10, 10, 3), np.int8),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data")))
    hlo = eng._fn.lower(tuple(eng.weights), tuple(eng.thrs), eng.out_scale,
                        eng.out_bias, x).compile().as_text()
    assert "all-gather" in hlo


def test_batching_server_owns_tp_engine():
    """BASELINE config #5 serving path: continuous batching over the
    tensor-sharded engine (BatchingServer drains requests into batches
    that the TP engine pads to the data-axis multiple)."""
    from bnn_pynq_tpu.runtime.serving import BatchingServer
    compiled = _compiled_mini_cnv(1, 1)
    mesh = make_mesh(data=2, model=4)
    eng = OverlapTPEngine(compiled, mesh)
    ref = InferenceEngine(compiled, runtime="ref", batch_buckets=(16,))
    server = BatchingServer(eng, max_batch=16, max_wait_ms=5.0)
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, size=(13, 10, 10, 3)).astype(np.int8)
    try:
        futures = [server.submit(x[i]) for i in range(13)]
        got = np.asarray([f.result(120) for f in futures])
    finally:
        server.stop()
    want = ref.classify(x, prepared=True)
    np.testing.assert_array_equal(got, want)


def test_overlap_tp_full_cnv_w1a1():
    """Full-size CNV-W1A1 (the flagship) through the conv overlap engine
    on the virtual mesh — the shapes the serving deployment would run."""
    compiled = _compiled("cnv-w1a1")
    mesh = make_mesh(data=1, model=4)
    eng = OverlapTPEngine(compiled, mesh)
    ref = InferenceEngine(compiled, runtime="ref", batch_buckets=(4,))
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, size=(4, 32, 32, 3)).astype(np.int8)
    np.testing.assert_allclose(eng.logits(x), ref.logits(x, prepared=True),
                               rtol=1e-5, atol=1e-5)


# -- round-5: TP engines as first-class serving citizens ------------------

def test_tp_serving_pipelined_and_packed():
    """An OverlapTPEngine owned by BatchingServer must get the serving
    features a one-device engine gets: pipelined dispatch (depth > 1 via
    logits_device) and packed uint32 word transport for bipolar nets
    (words_device)."""
    from bnn_pynq_tpu.runtime.serving import BatchingServer
    compiled = _compiled()                      # lfc-w1a1, bipolar input
    mesh = make_mesh(data=2, model=4)
    eng = OverlapTPEngine(compiled, mesh)
    ref = InferenceEngine(compiled, runtime="ref", route="xla",
                          batch_buckets=(16,))
    server = BatchingServer(eng, max_batch=16, max_wait_ms=5.0)
    assert server.pipeline_depth == 2, "TP engine must pipeline"
    assert server.packed_transport, "bipolar TP engine must ship words"
    rng = np.random.default_rng(11)
    x = rng.choice([-1, 1], size=(13, 784)).astype(np.int8)
    try:
        futures = [server.submit(x[i]) for i in range(13)]
        got = np.asarray([f.result(120) for f in futures])
    finally:
        server.stop()
    np.testing.assert_array_equal(got, ref.classify(x, prepared=True))


def test_tp_words_device_exact():
    """words_device (host-packed sign bits, device unpack) is bit-exact
    with the int8-code path on the sharded engine."""
    from bnn_pynq_tpu import native
    compiled = _compiled()
    mesh = make_mesh(data=2, model=4)
    eng = OverlapTPEngine(compiled, mesh)
    rng = np.random.default_rng(12)
    x = rng.choice([-1, 1], size=(16, 784)).astype(np.int8)
    words = native.pack_bits(x)
    dev, b = eng.words_device(words, argmax=False)
    np.testing.assert_allclose(np.asarray(dev)[:b], eng.logits(x),
                               rtol=1e-5, atol=1e-5)
    cls, b = eng.words_device(words, argmax=True)
    np.testing.assert_array_equal(np.asarray(cls)[:b],
                                  eng.logits(x).argmax(-1))


def test_tp_hot_swap_mid_serve():
    """load_parameters on a live, serving OverlapTPEngine: requests after
    the swap see the new parameters, no engine rebuild, no downtime
    (SURVEY.md §3.2 doInit-while-live contract on the multi-chip path)."""
    from bnn_pynq_tpu.runtime.serving import BatchingServer
    ca = _compiled_mini_cnv(1, 1)
    cfg = ca.config
    layers_b = init_random_params(cfg, seed=99)
    cb = CompiledNetwork(
        config=cfg,
        layers=[{k: np.asarray(v) for k, v in l.items()} for l in layers_b],
        out_scale=np.ones(cfg.num_classes, np.float32),
        out_bias=np.zeros(cfg.num_classes, np.float32))
    mesh = make_mesh(data=2, model=4)
    eng = OverlapTPEngine(ca, mesh)
    ref_a = InferenceEngine(ca, runtime="ref", batch_buckets=(16,))
    ref_b = InferenceEngine(cb, runtime="ref", batch_buckets=(16,))
    rng = np.random.default_rng(13)
    x = rng.integers(-128, 128, size=(6, 10, 10, 3)).astype(np.int8)
    server = BatchingServer(eng, max_batch=16, max_wait_ms=5.0)
    try:
        got_a = server.submit_many(x).result(120)
        eng.load_parameters(cb)               # live hot-swap
        got_b = server.submit_many(x).result(120)
    finally:
        server.stop()
    np.testing.assert_array_equal(got_a, ref_a.classify(x, prepared=True))
    np.testing.assert_array_equal(got_b, ref_b.classify(x, prepared=True))
    # the swap refuses a different topology
    other = _compiled()                        # lfc: different layers
    with pytest.raises(ValueError, match="topology"):
        eng.load_parameters(other)


def test_tpinference_engine_serving_hooks():
    """TPInferenceEngine (all-gather TP) gets the same hooks: bucketed
    async launch with device argmax + topology-checked hot-swap."""
    from bnn_pynq_tpu.parallel.tp import TPInferenceEngine
    compiled = _compiled()
    mesh = make_mesh(data=2, model=4)
    eng = TPInferenceEngine(compiled, mesh,
                            batch_buckets=(16,))
    rng = np.random.default_rng(14)
    x = rng.choice([-1, 1], size=(10, 784)).astype(np.int8)
    dev, b = eng.logits_device(x, argmax=True)
    assert b == 10
    got = np.asarray(dev)[:b]
    np.testing.assert_array_equal(got, eng.classify(x))
    eng.load_parameters(compiled)              # same topology: fine
    with pytest.raises(ValueError, match="topology"):
        eng.load_parameters(_compiled_mini_cnv(1, 1))


@pytest.mark.parametrize("engine", ["tp", "overlap"])
def test_no_engine_array_lives_on_one_device(engine):
    """Every array a TP engine holds is sharded or replicated over the
    whole mesh — none lands whole on device 0 (which would serialize the
    other devices' reads through it)."""
    from bnn_pynq_tpu.parallel.tp import TPInferenceEngine
    compiled = _compiled_mini_cnv(1, 1)
    mesh = make_mesh(data=2, model=4)
    if engine == "tp":
        eng = TPInferenceEngine(compiled, mesh)
        arrays = jax.tree_util.tree_leaves(eng.params)
    else:
        eng = OverlapTPEngine(compiled, mesh)
        arrays = list(eng.weights) + list(eng.thrs)
    arrays += [eng.out_scale, eng.out_bias]
    for a in arrays:
        assert a.sharding.device_set == set(mesh.devices.flat), a.sharding
