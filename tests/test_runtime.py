"""Classifier API + continuous-batching server (SURVEY.md C12 + serving)."""

import threading

import numpy as np
import pytest

from bnn_pynq_tpu.compiler import compile_network
from bnn_pynq_tpu.runtime.classifier import (Classifier, GTSRB_CLASSES,
                                             available_params)
from bnn_pynq_tpu.runtime.engine import InferenceEngine
from bnn_pynq_tpu.runtime.serving import BatchingServer
from tests.test_finnthesizer import init_perturbed, mini_cnv, mini_mlp


@pytest.fixture(scope="module")
def cnv_engine():
    cfg = mini_cnv(1, 1)
    _, params, stats = init_perturbed(cfg, seed=20)
    return InferenceEngine(compile_network(cfg, params, stats),
                           runtime="ref")


def test_classifier_single_and_batch(cnv_engine):
    clf = Classifier(cnv_engine)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(5, 10, 10, 3)).astype(np.uint8)
    batch_pred = clf.classify_images(imgs)
    assert batch_pred.shape == (5,)
    one = clf.classify_image(imgs[0])
    assert one == batch_pred[0]
    assert isinstance(clf.class_name(one), str)
    assert clf.usecPerImage is not None and clf.usecPerImage > 0


def test_classifier_resizes_and_converts(cnv_engine):
    clf = Classifier(cnv_engine)
    rng = np.random.default_rng(1)
    big_gray = rng.integers(0, 256, size=(40, 50)).astype(np.uint8)
    pred = clf.classify_image(big_gray)   # grayscale → RGB + resize
    assert 0 <= pred < 10


def test_classifier_details_match_logits(cnv_engine):
    clf = Classifier(cnv_engine)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(10, 10, 3)).astype(np.uint8)
    logits = clf.classify_image_details(img)
    assert logits.shape == (10,)
    assert logits.argmax() == clf.classify_image(img)


def test_gtsrb_names_complete():
    assert len(GTSRB_CLASSES) == 43
    assert len(set(GTSRB_CLASSES)) == 43


def test_available_params(tmp_path, monkeypatch):
    # search path covers $BNN_PARAMS_DIR plus the shipped pretrained/ dir
    monkeypatch.setenv("BNN_PARAMS_DIR", str(tmp_path))
    (tmp_path / "zz-custom.npz").write_bytes(b"x")
    names = available_params()
    assert "zz-custom.npz" in names
    assert "cnv-w1a1.npz" in names          # shipped pretrained artifact
    assert available_params("zz") == ["zz-custom.npz"]


@pytest.mark.parametrize("route", ["xla", "s2d"])
@pytest.mark.parametrize("bits", [(1, 1), (1, 2)])
def test_logits_words_matches_standard(route, bits):
    """Packed word transport into the production path: uint32 words →
    on-device unpack → same logits as prepare()+logits(), bit-exact
    (the reference's binarizeAndPack contract «foldedmv-offload»)."""
    wb, ab = bits
    cfg = mini_mlp(wb, ab)
    _, params, stats = init_perturbed(cfg, seed=31)
    compiled = compile_network(cfg, params, stats)
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, size=(6,) + cfg.input_shape).astype(np.uint8)
    e = InferenceEngine(compiled, runtime="device", route=route,
                        batch_buckets=(8,))
    standard = e.logits(imgs)
    words = e.logits_words(imgs)
    np.testing.assert_array_equal(words, standard)


def test_logits_words_rejects_image_input_nets():
    cfg = mini_cnv(1, 1)
    _, params, stats = init_perturbed(cfg, seed=32)
    e = InferenceEngine(compile_network(cfg, params, stats), runtime="ref")
    with pytest.raises(ValueError):
        e.logits_words(np.zeros((1, 10, 10, 3), np.uint8))


def test_batching_server_correct_and_batches(cnv_engine):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, size=(32, 10, 10, 3)).astype(np.uint8)
    prepared = cnv_engine.prepare(imgs)
    expected = cnv_engine.classify(prepared, prepared=True)

    server = BatchingServer(cnv_engine, max_batch=16, max_wait_ms=20.0)
    try:
        futures = [server.submit(prepared[i]) for i in range(32)]
        got = np.array([f.result(30) for f in futures])
    finally:
        server.stop()
    np.testing.assert_array_equal(got, expected)
    assert server.stats.requests == 32
    # batching actually grouped requests (fewer engine calls than requests)
    assert server.stats.batches < 32
    s = server.stats.summary()
    assert s["p50_ms"] > 0


def test_batching_server_multi_image_requests(cnv_engine):
    """submit_many: one queue entry per k-image request, results split
    back per request, interleaved with single submits — the serving
    contract behind HTTP POST batches and tools/serving_bench.py."""
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, size=(20, 10, 10, 3)).astype(np.uint8)
    prepared = cnv_engine.prepare(imgs)
    expected = cnv_engine.classify(prepared, prepared=True)
    server = BatchingServer(cnv_engine, max_batch=16, max_wait_ms=20.0)
    try:
        f_a = server.submit_many(prepared[0:7])
        f_one = server.submit(prepared[7])
        f_b = server.submit_many(prepared[8:20])
        np.testing.assert_array_equal(f_a.result(60), expected[0:7])
        assert f_one.result(60) == expected[7]
        np.testing.assert_array_equal(f_b.result(60), expected[8:20])
    finally:
        server.stop()
    assert server.stats.requests == 3
    assert server.stats.images == 20
    assert server.stats.summary()["mean_batch"] > 1


def test_batching_server_packed_transport_mlp():
    """Bipolar (MLP) engines serve through the packed-word transport:
    the dispatcher packs each dispatched batch to uint32 words (32×
    smaller transfer) and the device unpacks + argmaxes in one program.
    Results must match the engine's own classify bit-for-bit."""
    cfg = mini_mlp(1, 1)
    _, params, stats = init_perturbed(cfg, seed=33)
    engine = InferenceEngine(compile_network(cfg, params, stats),
                             runtime="device", route="xla",
                             batch_buckets=(16,))
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, size=(10,) + cfg.input_shape
                        ).astype(np.uint8)
    prepared = engine.prepare(imgs)
    expected = engine.classify(prepared, prepared=True)
    server = BatchingServer(engine, max_batch=16, max_wait_ms=20.0)
    assert server.packed_transport
    try:
        got = np.asarray(server.submit_many(prepared).result(60))
        one = server.submit(prepared[0]).result(60)
    finally:
        server.stop()
    np.testing.assert_array_equal(got, expected)
    assert one == expected[0]


def test_batching_server_oversized_request_split(cnv_engine):
    """A single request larger than max_batch is split into max_batch
    chunks internally (one giant POST must never force an unplanned jit
    compile of a new bucket on the serving hot path) and still resolves
    to one in-order result array."""
    rng = np.random.default_rng(15)
    imgs = rng.integers(0, 256, size=(37, 10, 10, 3)).astype(np.uint8)
    prepared = cnv_engine.prepare(imgs)
    expected = cnv_engine.classify(prepared, prepared=True)
    server = BatchingServer(cnv_engine, max_batch=8, max_wait_ms=5.0)
    try:
        got = np.asarray(server.submit_many(prepared).result(120))
    finally:
        server.stop()
    np.testing.assert_array_equal(got, expected)
    assert server.stats.requests >= 5     # 37 images / 8 per chunk
    assert server.stats.images == 37


def test_batching_server_pipeline_depths_agree(cnv_engine):
    """depth=1 (sync r3 behavior) and depth=2 (pipelined collector) must
    produce identical results for the same requests."""
    rng = np.random.default_rng(16)
    imgs = rng.integers(0, 256, size=(12, 10, 10, 3)).astype(np.uint8)
    prepared = cnv_engine.prepare(imgs)
    outs = {}
    for depth in (1, 2):
        server = BatchingServer(cnv_engine, max_batch=8, max_wait_ms=5.0,
                                pipeline_depth=depth)
        assert server.pipeline_depth == depth
        try:
            outs[depth] = np.asarray(
                server.submit_many(prepared).result(120))
        finally:
            server.stop()
    np.testing.assert_array_equal(outs[1], outs[2])


def test_load_parameters_hot_swap():
    cfg = mini_cnv(1, 1)
    _, p1, s1 = init_perturbed(cfg, seed=40)
    _, p2, s2 = init_perturbed(cfg, seed=41)
    c1 = compile_network(cfg, p1, s1)
    c2 = compile_network(cfg, p2, s2)
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, size=(4, 10, 10, 3)).astype(np.uint8)
    e = InferenceEngine(c1, runtime="ref")
    out1 = e.logits(imgs)
    e.load_parameters(c2)
    out2 = e.logits(imgs)
    expected2 = InferenceEngine(c2, runtime="ref").logits(imgs)
    np.testing.assert_array_equal(out2, expected2)
    assert not np.array_equal(out1, out2)


def test_http_server_roundtrip(tmp_path):
    import io as _io
    import json
    import urllib.request
    from bnn_pynq_tpu.compiler import save_artifact
    from bnn_pynq_tpu.runtime.http_server import serve

    cfg = mini_cnv(1, 1)
    _, params, stats = init_perturbed(cfg, seed=21)
    compiled = compile_network(cfg, params, stats)
    path = str(tmp_path / "mini.npz")
    save_artifact(path, compiled)

    httpd, batcher = serve(path, port=0, runtime="ref", block=False)
    port = httpd.server_address[1]
    try:
        r = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10)
        assert r.read() == b"ok"

        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, size=(3, 10, 10, 3)).astype(np.uint8)
        buf = _io.BytesIO()
        np.savez(buf, x=imgs)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/classify", data=buf.getvalue(),
            method="POST")
        resp = json.loads(urllib.request.urlopen(req, timeout=30).read())
        engine = InferenceEngine(compiled, runtime="ref")
        expected = engine.classify(imgs).tolist()
        assert resp["classes"] == expected
        assert len(resp["names"]) == 3

        stats_resp = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=10).read())
        # one POST of 3 images = ONE multi-image request
        assert stats_resp["requests"] >= 1
        assert stats_resp["images"] >= 3
    finally:
        httpd.shutdown()
        batcher.stop()


def test_batching_server_concurrent_clients(cnv_engine):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(24, 10, 10, 3)).astype(np.uint8)
    prepared = cnv_engine.prepare(imgs)
    expected = cnv_engine.classify(prepared, prepared=True)
    server = BatchingServer(cnv_engine, max_batch=8, max_wait_ms=5.0)
    results = {}
    lock = threading.Lock()

    def client(i):
        r = server.classify(prepared[i])
        with lock:
            results[i] = r

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        server.stop()
    got = np.array([results[i] for i in range(24)])
    np.testing.assert_array_equal(got, expected)


def test_engine_s2d_route_matches_ref():
    """route='s2d' through the full engine (compile_network artifacts,
    trained-stats thresholds) is bit-identical to the golden ref
    runtime — the engine-level twin check for the round-3 conv route."""
    cfg = mini_cnv(1, 1)
    _, params, stats = init_perturbed(cfg, seed=21)
    compiled = compile_network(cfg, params, stats)
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, size=(5,) + cfg.input_shape).astype(np.uint8)
    ref = InferenceEngine(compiled, runtime="ref").logits(imgs)
    s2d = InferenceEngine(compiled, runtime="device",
                          route="s2d").logits(imgs)
    np.testing.assert_allclose(s2d, ref, atol=1e-4)


def test_engine_microbatch_split_exact(monkeypatch):
    """Batches above MICROBATCH run as lax.map chunks inside one jitted
    program — results must be identical to the unchunked program."""
    import bnn_pynq_tpu.runtime.engine as eng_mod
    cfg = mini_cnv(1, 1)
    _, params, stats = init_perturbed(cfg, seed=22)
    compiled = compile_network(cfg, params, stats)
    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 256, size=(8,) + cfg.input_shape).astype(np.uint8)
    whole = InferenceEngine(compiled, runtime="device", route="s2d",
                            batch_buckets=(8,)).logits(imgs)
    monkeypatch.setattr(eng_mod, "MICROBATCH", 4)
    split = InferenceEngine(compiled, runtime="device", route="s2d",
                            batch_buckets=(8,)).logits(imgs)
    np.testing.assert_array_equal(split, whole)


# -- serving hardening ---------------------------------------------------

class _RecordingEngine:
    """Sync fake engine (no logits_device → BatchingServer falls back to
    depth 1): records every dispatched batch size, optional delay."""

    def __init__(self, delay_s=0.0):
        self.batch_sizes = []
        self.delay_s = delay_s

    def classify(self, x, prepared=True):
        self.batch_sizes.append(len(x))
        if self.delay_s:
            import time
            time.sleep(self.delay_s)
        return np.zeros(len(x), np.int32)

    def logits(self, x, prepared=True):
        self.batch_sizes.append(len(x))
        return np.zeros((len(x), 10), np.float32)


def test_batching_server_never_exceeds_max_batch():
    """The carry-over invariant: interleaved multi-
    image requests must never produce a dispatched batch > max_batch —
    an overflowing request waits for the next batch instead of pushing
    this one into a never-warmed bucket."""
    eng = _RecordingEngine(delay_s=0.05)
    server = BatchingServer(eng, max_batch=8, max_wait_ms=30.0,
                            adaptive_wait=False)
    try:
        futs = [server.submit_many(np.zeros((5, 3), np.int8))
                for _ in range(6)]
        outs = [f.result(30) for f in futs]
    finally:
        server.stop()
    assert all(len(o) == 5 for o in outs)
    assert eng.batch_sizes and max(eng.batch_sizes) <= 8
    # 6 x 5 = 30 images flowed through in <=8-image batches
    assert sum(eng.batch_sizes) == 30


def test_batching_server_survives_cancelled_future():
    """A client cancelling its future (e.g. after a result() timeout)
    must not kill the dispatcher thread (set_result on a
    CANCELLED future raises InvalidStateError)."""
    eng = _RecordingEngine(delay_s=0.05)
    server = BatchingServer(eng, max_batch=4, max_wait_ms=1.0)
    try:
        f_a = server.submit(np.zeros(3, np.int8))   # occupies the engine
        f_b = server.submit(np.zeros(3, np.int8))
        assert f_b.cancel()                         # cancel while queued
        f_a.result(30)
        # dispatcher must still be alive and serving
        f_c = server.submit(np.zeros(3, np.int8))
        assert f_c.result(30) == 0
    finally:
        server.stop()


def test_batching_server_adaptive_wait_low_load():
    """Latency tier: with the device idle and the queue shallow, a lone
    request dispatches immediately instead of waiting max_wait_ms."""
    import time
    eng = _RecordingEngine()
    server = BatchingServer(eng, max_batch=64, max_wait_ms=500.0,
                            adaptive_wait=True)
    try:
        t0 = time.perf_counter()
        server.submit(np.zeros(3, np.int8)).result(30)
        dt = time.perf_counter() - t0
    finally:
        server.stop()
    assert dt < 0.25, f"adaptive dispatch took {dt * 1e3:.0f} ms"


def test_batching_server_throughput_wait_honored():
    """adaptive_wait=False keeps the r4 behavior: a lone request waits
    out max_wait_ms for stragglers (the throughput tier)."""
    import time
    eng = _RecordingEngine()
    server = BatchingServer(eng, max_batch=64, max_wait_ms=300.0,
                            adaptive_wait=False)
    try:
        t0 = time.perf_counter()
        server.submit(np.zeros(3, np.int8)).result(30)
        dt = time.perf_counter() - t0
    finally:
        server.stop()
    assert dt >= 0.28, f"expected >=280 ms wait, got {dt * 1e3:.0f} ms"


class _SlowFetch:
    """Array whose host fetch (np.asarray) blocks — a slow device fetch."""

    def __init__(self, vals, delay_s):
        self.vals = vals
        self.delay_s = delay_s

    def __array__(self, dtype=None, copy=None):
        import time
        time.sleep(self.delay_s)
        a = np.asarray(self.vals)
        return a.astype(dtype) if dtype else a


class _PipelinedEngine:
    """Fake engine exposing the async-launch API (pipelined dispatch)."""

    def classify(self, x, prepared=True):
        return np.zeros(len(x), np.int32)

    def logits_device(self, x, prepared=True, argmax=True):
        return _SlowFetch(np.zeros(len(x), np.int32), 0.1), len(x)


def test_batching_server_stop_resolves_inflight():
    """Requests accepted and computed before stop() must resolve with
    their results, not 'server stopped' (the dispatcher's
    final put + stop()'s inflight drain)."""
    server = BatchingServer(_PipelinedEngine(), max_batch=4,
                            max_wait_ms=1.0, pipeline_depth=2)
    futs = [server.submit(np.zeros(3, np.int8)) for _ in range(8)]
    import time
    time.sleep(0.15)          # let some batches launch into the pipeline
    server.stop()
    for f in futs:
        assert f.result(1) == 0    # resolved with the computed result


def test_warmup_compiles_serving_programs():
    """warmup() must warm the programs the serving hot path dispatches
    (classify + packed-words), not just the logits program."""
    cfg = mini_mlp(1, 1)
    _, params, stats = init_perturbed(cfg, seed=23)
    eng = InferenceEngine(compile_network(cfg, params, stats),
                          runtime="ref")
    assert eng._fn_cls is None and eng._fn_words is None
    eng.warmup(batch=4)
    assert eng._fn_cls is not None
    assert eng._fn_words is not None and eng._fn_words_cls is not None


def test_upload_pipeline_active_and_exact(cnv_engine):
    """The 3-stage {upload || launch || fetch} pipeline (r5 upload-wall
    fix) engages automatically for engines with the upload/launch split
    and is bit-identical to the 2-stage and sync paths."""
    rng = np.random.default_rng(31)
    imgs = rng.integers(-128, 128, size=(13, 10, 10, 3)).astype(np.int8)
    want = cnv_engine.classify(imgs, prepared=True)
    s3 = BatchingServer(cnv_engine, max_batch=8, max_wait_ms=5.0,
                        upload_pipeline=True)
    assert s3.upload_pipeline
    s2 = BatchingServer(cnv_engine, max_batch=8, max_wait_ms=5.0,
                        upload_pipeline=False)
    assert not s2.upload_pipeline and s2.pipeline_depth == 2
    try:
        got3 = s3.submit_many(imgs).result(60)
        got2 = s2.submit_many(imgs).result(60)
    finally:
        s3.stop()
        s2.stop()
    np.testing.assert_array_equal(got3, want)
    np.testing.assert_array_equal(got2, want)


def test_upload_pipeline_packed_mlp():
    """Packed word transport composes with the uploader stage: the
    dispatcher packs, the uploader ships words, the device unpacks."""
    cfg = mini_mlp(1, 1)
    _, params, stats = init_perturbed(cfg, seed=33)
    eng = InferenceEngine(compile_network(cfg, params, stats),
                          runtime="ref")
    rng = np.random.default_rng(34)
    n_in = int(np.prod(cfg.input_shape))
    x = rng.choice([-1, 1], size=(11, n_in)).astype(np.int8)
    want = eng.classify(x, prepared=True)
    server = BatchingServer(eng, max_batch=16, max_wait_ms=5.0,
                            upload_pipeline=True)
    assert server.upload_pipeline and server.packed_transport
    try:
        got = server.submit_many(x).result(60)
    finally:
        server.stop()
    np.testing.assert_array_equal(got, want)


def test_load_parameters_hot_swap_device_runtime():
    """The device runtime re-decodes swapped weights to int8 levels; the
    jitted program takes them as an argument, so a swap recompiles
    nothing and later calls see the new parameters."""
    cfg = mini_mlp(1, 1)
    _, p1, s1 = init_perturbed(cfg, seed=42)
    _, p2, s2 = init_perturbed(cfg, seed=43)
    c1 = compile_network(cfg, p1, s1)
    c2 = compile_network(cfg, p2, s2)
    rng = np.random.default_rng(8)
    n_in = int(np.prod(cfg.input_shape))
    x = rng.choice([-1, 1], size=(4, n_in)).astype(np.int8)
    e = InferenceEngine(c1, runtime="device", route="xla",
                        batch_buckets=(4,))
    out1 = e.logits(x, prepared=True)
    e.load_parameters(c2)
    assert "w_int8" in e.params[0] and "w_packed" not in e.params[0]
    out2 = e.logits(x, prepared=True)
    expected2 = InferenceEngine(c2, runtime="ref",
                                batch_buckets=(4,)).logits(x, prepared=True)
    np.testing.assert_array_equal(out2, expected2)
    assert not np.array_equal(out1, out2)
    assert e._fn._cache_size() == 1
