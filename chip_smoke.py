"""GPU bring-up check: the inference engine and its HTTP server on the card.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the tensor-sharded
                                       # serving path only

The first line is the card as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives it; then one JSON object per line, one or
more per phase. The last line,

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

is printed only when every phase passed. Without a GPU the script exits
non-zero at its first phase and prints no result; there is no CPU
fallback.

One-GPU phases:
  device    a child process asks JAX for its backend (the parent stays
            off the card until the GPU tests are done);
  gpu-tests every test marked `gpu`, in a child process on the card;
  serve     runtime.http_server.serve() of pretrained CNV-W1A1 and
            LFC-W1A1 with its normal defaults: POST /classify (1, 7 and
            64 images), GET /healthz and /stats, POST /reload, one more
            request; every class equals the CPU `ref` runtime's;
  exact     all 11 pretrained networks × routes s2d/xla/xlaconv at batch
            256: int32 logits and classes bit-exact with the CPU `ref`
            runtime, float logits within 1e-6 relative;
  memory    compiled.memory_analysis() of the CNV serving program and the
            device's peak bytes in use;
  readings  informational img/s (block_until_ready after warm-up) and how
            every dot and convolution lowered (cuBLAS, Triton, cuDNN or a
            loop fusion).

Compilation is reported as set-up time (`setup_s`), apart from `run_s`.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PRETRAINED = os.path.join(ROOT, "pretrained")
EXACT_BATCH = 256
SEED = 0                 # every input image is made from it
LOGITS_RTOL = 1e-6
FAILURES = []


def emit(**fields):
    print(json.dumps(fields, default=str), flush=True)


def check(ok, what):
    """Fail the phase unless `ok` (an explicit raise: asserts vanish under
    `python -O`)."""
    if not ok:
        raise AssertionError(what)


def phase(name, fn, *args, **kw):
    """Run one phase; record (not raise) its failure so later phases still
    report. Returns fn's result or None."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — every failure is reported
        FAILURES.append(name)
        emit(phase=name, ok=False, seconds=time.perf_counter() - t0,
             error=f"{type(e).__name__}: {e}"[:2000])
        return None


# -- helpers that need no card (tested on the CPU) ---------------------------

_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INS = re.compile(r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*.*?\s([\w\-]+)\((.*)$")


def hlo_dot_summary(hlo_text: str) -> dict:
    """How the dots and convolutions of an optimized GPU HLO module
    lowered: cuBLAS custom calls, Triton GEMM fusions, cuDNN
    convolutions, and dots left in loop/input fusions or unfused (the
    slow, naive emitters)."""
    comps, cur = {}, None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            m = _HDR.match(line)
            cur = m.group(1) if m else None
            comps[cur] = []
        elif cur is not None:
            m = _INS.match(line)
            if m:
                comps[cur].append((m.group(1), line))
    out = {"cublas_gemm": 0, "triton_gemm": 0, "cudnn_conv": 0,
           "loop_fusion_dot": 0, "unfused_dot": 0, "unfused_conv": 0}
    caller_kind = {}
    for ins in comps.values():
        for op, line in ins:
            if op == "custom-call":
                out["cublas_gemm"] += "__cublas" in line
                out["cudnn_conv"] += "__cudnn$conv" in line
            elif op == "fusion":
                called = re.search(r"calls=%?([\w.\-]+)", line)
                kind = re.search(r"kind=(\w+)", line)
                triton = '"kind":"__triton' in line and "gemm" in line
                if called:
                    caller_kind[called.group(1)] = (
                        "triton" if triton else kind.group(1) if kind
                        else "?")
    for name, ins in comps.items():
        dots = sum(op == "dot" for op, _ in ins)
        out["unfused_conv"] += sum(op == "convolution" for op, _ in ins)
        if not dots:
            continue
        kind = caller_kind.get(name)
        if kind == "triton":
            out["triton_gemm"] += dots
        elif kind is not None:
            out["loop_fusion_dot"] += dots
        else:
            out["unfused_dot"] += dots
    out["all_gemm"] = (out["loop_fusion_dot"] == 0 and out["unfused_dot"] == 0
                       and out["unfused_conv"] == 0)
    return out


def logits_close(got, want, acc, scale, bias, rtol=LOGITS_RTOL) -> bool:
    """Float logits = acc·scale + bias from identical int32 `acc`. The GPU
    may fuse that into one FMA (one rounding instead of two), so the two
    sides differ by at most ~2⁻²⁴·(|acc·scale| + |bias|) per element;
    rtol is applied to that magnitude, not to the (possibly cancelling)
    result."""
    mag = np.abs(acc.astype(np.float64) * scale) + np.abs(bias)
    return bool(np.all(np.abs(got.astype(np.float64) - want) <= rtol * mag))


def random_images(config, batch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(batch,) + config.input_shape,
                        dtype=np.uint8)


def cpu_reference(compiled, images):
    """(int32 logits, float logits, classes) of the `ref` runtime on the
    CPU device for uint8 images."""
    import jax
    from bnn_pynq_tpu.runtime.engine import InferenceEngine, _epilogue
    with jax.default_device(jax.devices("cpu")[0]):
        eng = InferenceEngine(compiled, runtime="ref",
                              batch_buckets=(len(images),))
        fn = jax.jit(lambda p, s, b, x: (
            (acc := eng._forward_acc(p, x)), _epilogue(acc, s, b)))
        acc, logits = fn(eng.params, eng.out_scale, eng.out_bias,
                         eng.prepare(images))
        acc, logits = np.asarray(acc), np.asarray(logits)
    return acc, logits, logits.argmax(-1)


def check_exact(compiled, route: str, images, ref=None) -> dict:
    """Run `route` on the default device and compare with the CPU `ref`
    runtime: int32 logits and classes bit-exact, float logits within
    LOGITS_RTOL (see logits_close). Returns a report; raises on a
    mismatch."""
    import jax
    from bnn_pynq_tpu.runtime.engine import InferenceEngine, _epilogue
    ref_acc, ref_logits, ref_cls = ref or cpu_reference(compiled, images)
    eng = InferenceEngine(compiled, route=route,
                          batch_buckets=(len(images),))
    fn = jax.jit(lambda p, s, b, x: (
        (acc := eng._forward_acc(p, x)), _epilogue(acc, s, b)))
    x = jax.device_put(eng.prepare(images))
    t0 = time.perf_counter()
    prog = fn.lower(eng.params, eng.out_scale, eng.out_bias, x).compile()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc, logits = jax.block_until_ready(
        prog(eng.params, eng.out_scale, eng.out_bias, x))
    run = time.perf_counter() - t0
    acc, logits = np.asarray(acc), np.asarray(logits)
    report = {"route": route, "batch": len(images), "setup_s": setup,
              "run_s": run,
              "acc_exact": bool(np.array_equal(acc, ref_acc)),
              "classes_exact": bool(np.array_equal(logits.argmax(-1),
                                                   ref_cls)),
              "logits_close": logits_close(
                  logits, ref_logits, acc, np.asarray(compiled.out_scale),
                  np.asarray(compiled.out_bias))}
    if not (report["acc_exact"] and report["classes_exact"]
            and report["logits_close"]):
        bad = int((acc != ref_acc).any(-1).sum())
        raise AssertionError(f"{compiled.config.name}/{route} differs from "
                             f"the CPU ref ({bad} rows): {report}")
    return report


# -- phases ------------------------------------------------------------------

def env_phase():
    import jax
    import jaxlib
    from bnn_pynq_tpu import native
    from bnn_pynq_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    t0 = time.perf_counter()
    built = native.available() or native.build()
    emit(phase="env", ok=True, jax=jax.__version__,
         jaxlib=jaxlib.__version__, compile_cache_dir=cache,
         native_host_library=bool(built),
         native_build_setup_s=time.perf_counter() - t0)


def device_phase(expect: int):
    """Ask JAX for its backend in a child process, so this process holds
    no card while the GPU tests run."""
    code = ("import jax, json; d = jax.devices(); print(json.dumps("
            "{'backend': jax.default_backend(), 'platform': d[0].platform,"
            " 'kind': d[0].device_kind, 'count': len(d)}))")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    info = json.loads(r.stdout.strip().splitlines()[-1]) \
        if r.returncode == 0 and r.stdout.strip() else {}
    ok = info.get("backend") == "gpu" and info.get("count", 0) >= expect
    emit(phase="device", ok=ok, seconds=time.perf_counter() - t0, **info,
         **({} if ok else {"error": (
             f"needs {expect} GPU(s); JAX reports {info or r.stderr[-500:]}"
         )}))
    if not ok:
        sys.exit(2)


def gpu_tests_phase():
    tests = os.path.join(ROOT, "tests")
    files = sorted(
        os.path.join(tests, f) for f in os.listdir(tests)
        if f.startswith("test_") and f.endswith(".py")
        and "pytest.mark.gpu" in open(os.path.join(tests, f)).read())
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "gpu", *files],
        capture_output=True, text=True, cwd=ROOT, timeout=900,
        env=dict(os.environ, BNN_TESTS_ON_GPU="1"))
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    emit(phase="gpu-tests", ok=r.returncode == 0,
         seconds=time.perf_counter() - t0, files=[os.path.basename(f)
                                                  for f in files],
         summary=tail)
    if r.returncode != 0:
        raise RuntimeError(r.stdout[-3000:] + r.stderr[-2000:])


def _http(port, path, body=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body,
                                 method="POST" if body is not None
                                 else "GET")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.read()


def serve_phase(name: str, seed: int):
    from bnn_pynq_tpu.compiler.artifacts import load_artifact
    from bnn_pynq_tpu.runtime.http_server import serve
    path = os.path.join(PRETRAINED, f"{name}.npz")
    compiled = load_artifact(path)
    t0 = time.perf_counter()
    httpd, batcher = serve(path, port=0, block=False)
    setup = time.perf_counter() - t0
    port = httpd.server_address[1]
    t0 = time.perf_counter()
    try:
        checked = []
        for i, n in enumerate((1, 7, 64, "reload", 5)):
            if n == "reload":
                with open(path, "rb") as f:
                    r = json.loads(_http(port, "/reload", f.read()))
                check(r == {"reloaded": compiled.config.name}, r)
                check(_http(port, "/healthz") == b"ok", "healthz")
                stats = json.loads(_http(port, "/stats"))
                check(stats["requests"] >= 3 and stats["images"] >= 72,
                      stats)
                continue
            imgs = random_images(compiled.config, n, seed + i)
            buf = io.BytesIO()
            np.savez(buf, x=imgs)
            got = json.loads(_http(port, "/classify", buf.getvalue()))
            want = cpu_reference(compiled, imgs)[2]
            check(got["classes"] == want.tolist(), (n, got, want))
            checked.append(n)
    finally:
        httpd.shutdown()
        batcher.stop()
    emit(phase="serve", ok=True, net=name, setup_s=setup,
         run_s=time.perf_counter() - t0, requests_checked=checked,
         packed_transport=batcher.packed_transport, stats=stats)


def exact_phase(names, batch: int, seed: int):
    from bnn_pynq_tpu.compiler.artifacts import load_artifact
    for i, name in enumerate(names):
        compiled = load_artifact(os.path.join(PRETRAINED, f"{name}.npz"))
        images = random_images(compiled.config, batch, seed + i)
        t0 = time.perf_counter()
        ref = cpu_reference(compiled, images)
        ref_s = time.perf_counter() - t0
        rows = [check_exact(compiled, route, images, ref)
                for route in ("s2d", "xla", "xlaconv")]
        emit(phase="exact", ok=True, net=name, cpu_ref_s=ref_s,
             routes=rows)


def memory_phase():
    import jax
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    eng = InferenceEngine.from_artifact(
        os.path.join(PRETRAINED, "cnv-w1a1.npz"))
    x = jax.device_put(np.zeros((EXACT_BATCH,) + eng.config.input_shape,
                                np.int8))
    mem = eng._classify_fn().lower(eng.params, eng.out_scale, eng.out_bias,
                                   x).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    stats = jax.devices()[0].memory_stats() or {}
    emit(phase="memory", ok=True, program="cnv-w1a1 s2d classify",
         batch=EXACT_BATCH,
         **{f: getattr(mem, f, None) for f in fields},
         peak_bytes_in_use=stats.get("peak_bytes_in_use"))


READINGS = [("cnv-w1a1", r, 1024) for r in ("s2d", "xla", "xlaconv")] + \
    [(n, "xla", b) for n in ("sfc-w1a1", "lfc-w1a1") for b in (4096, 65536)]


def readings_phase(cells=READINGS, iters: int = 50):
    import jax
    from bnn_pynq_tpu.runtime.engine import InferenceEngine
    from bnn_pynq_tpu.utils.metrics import (chip_specs,
                                            int8_roofline_images_per_sec)
    from bnn_pynq_tpu.utils.profiling import steady_state_stats
    kind = jax.devices()[0].device_kind
    for name, route, batch in cells:
        eng = InferenceEngine.from_artifact(
            os.path.join(PRETRAINED, f"{name}.npz"), route=route,
            batch_buckets=(batch,))
        images = random_images(eng.config, batch, 7)
        x = jax.device_put(eng.prepare(images))
        args = (eng.params, eng.out_scale, eng.out_bias, x)
        t0 = time.perf_counter()
        prog = eng._fn.lower(*args).compile()
        setup = time.perf_counter() - t0
        sec, half_range = steady_state_stats(lambda: prog(*args),
                                             iters=iters, repeats=5)
        try:
            share = batch / sec / int8_roofline_images_per_sec(
                eng.config, chip_specs(kind))
        except KeyError:
            share = None
        emit(phase="readings", ok=True, net=name, route=route, batch=batch,
             setup_s=setup, ms_per_batch=sec * 1e3,
             ms_half_range=half_range * 1e3, images_per_sec=batch / sec,
             int8_peak_share=share, lowering=hlo_dot_summary(
                 prog.as_text()))


def four_card_phase(devices, seed: int = 11, calib_batch: int = 256):
    """The tensor-sharded serving path (BASELINE config #5) on a data=1 ×
    model=4 mesh, and what it is compared with: the one-device CPU `ref`
    runtime."""
    import jax
    from bnn_pynq_tpu.compiler.artifacts import load_artifact
    from bnn_pynq_tpu.parallel.mesh import make_mesh
    from bnn_pynq_tpu.parallel.overlap import OverlapTPEngine
    from bnn_pynq_tpu.parallel.tp import TPInferenceEngine
    from bnn_pynq_tpu.runtime.engine import prepare_host
    from bnn_pynq_tpu.runtime.serving import BatchingServer
    from bnn_pynq_tpu.utils.profiling import steady_state_stats

    mesh = make_mesh(data=1, model=4, devices=devices[:4])
    everywhere = set(mesh.devices.flat)

    def spread(arrays):
        return all(a.sharding.device_set == everywhere for a in arrays)

    cnv = load_artifact(os.path.join(PRETRAINED, "cnv-w2a2.npz"))
    t0 = time.perf_counter()
    ring = OverlapTPEngine(cnv, mesh, arm="ring")
    x0 = jax.device_put(np.zeros((8,) + cnv.config.input_shape, np.int8),
                        ring._data_sh)
    hlo = ring._fn.lower(tuple(ring.weights), tuple(ring.thrs),
                         ring.out_scale, ring.out_bias, x0
                         ).compile().as_text()
    check("all-gather" not in hlo, "CNV overlap TP must not all-gather")
    check("collective-permute" in hlo, "CNV overlap TP ring missing")
    check(spread(list(ring.weights) + list(ring.thrs)
                 + [ring.out_scale, ring.out_bias]), "array on one device")
    server = BatchingServer(ring, max_batch=64, max_wait_ms=5.0)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        for i, n in enumerate((1, 7, 64)):
            imgs = random_images(cnv.config, n, seed + i)
            got = server.submit_many(prepare_host(cnv.config, imgs)
                                     ).result(600)
            want = cpu_reference(cnv, imgs)[2]
            check(np.array_equal(np.asarray(got), want), (n, got, want))
    finally:
        server.stop()
    emit(phase="four-cards", ok=True, what="cnv-w2a2 ring-arm overlap TP "
         "behind BatchingServer", mesh=dict(mesh.shape), setup_s=setup,
         run_s=time.perf_counter() - t0, requests_checked=[1, 7, 64],
         pipelined=server.pipeline_depth > 1, no_all_gather=True,
         collective_permute_start_done=(
             "collective-permute-start" in hlo
             and "collective-permute-done" in hlo),
         arrays_spread_over_mesh=True)

    # ring vs blocking on the same network, mesh and batch
    blocking = OverlapTPEngine(cnv, mesh, arm="blocking")
    imgs = random_images(cnv.config, calib_batch, seed + 5)
    ref_cls = cpu_reference(cnv, imgs)[2]
    xd = jax.device_put(prepare_host(cnv.config, imgs), ring._data_sh)
    times = {}
    for name, eng in (("ring", ring), ("blocking", blocking)):
        w, t = tuple(eng.weights), tuple(eng.thrs)
        out = np.asarray(eng._fn(w, t, eng.out_scale, eng.out_bias, xd))
        bad = int((out.argmax(-1) != ref_cls).sum())
        check(bad == 0, f"{name}: {bad} classes differ")
        times[name] = steady_state_stats(
            lambda: eng._fn(w, t, eng.out_scale, eng.out_bias, xd),
            iters=20, repeats=5)[0]
    emit(phase="four-cards", ok=True, what="cnv-w2a2 ring vs blocking",
         batch=calib_batch, ring_ms=times["ring"] * 1e3,
         blocking_ms=times["blocking"] * 1e3, classes_exact=True)

    # the all-gather TP engine on the same network
    tp = TPInferenceEngine(cnv, mesh)
    check(spread(jax.tree_util.tree_leaves(tp.params)
                 + [tp.out_scale, tp.out_bias]), "array on one device")
    got = np.asarray(tp.classify(prepare_host(cnv.config, imgs)))
    bad = int((got != ref_cls).sum())
    check(bad == 0, f"TPInferenceEngine: {bad} classes differ")
    emit(phase="four-cards", ok=True, what="cnv-w2a2 TPInferenceEngine",
         batch=calib_batch, classes_exact=True, arrays_spread_over_mesh=True)

    # LFC with the arm chosen by measurement
    lfc = load_artifact(os.path.join(PRETRAINED, "lfc-w1a1.npz"))
    auto = OverlapTPEngine(lfc, mesh, arm="auto", calib_batch=calib_batch)
    imgs = random_images(lfc.config, calib_batch, seed + 6)
    got = np.asarray(auto.classify(prepare_host(lfc.config, imgs)))
    want = cpu_reference(lfc, imgs)[2]
    bad = int((got != want).sum())
    check(bad == 0, f"lfc arm={auto.arm}: {bad} classes differ")
    emit(phase="four-cards", ok=True, what="lfc-w1a1 OverlapTPEngine "
         "arm=auto", arm=auto.arm, arm_reason=auto.arm_reason,
         classes_exact=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU tensor-sharded serving "
                    "phase")
    args = ap.parse_args(argv)
    expect = 4 if args.four_cards else 1

    from bnn_pynq_tpu.utils.device import card_name_and_power
    print(card_name_and_power() or "nvidia-smi: not found", flush=True)
    device_phase(expect)
    phase("env", env_phase)
    if not args.four_cards:
        phase("gpu-tests", gpu_tests_phase)

    import jax
    if jax.default_backend() != "gpu" or len(jax.devices()) < expect:
        emit(phase="device", ok=False, error="this process sees "
             f"{jax.default_backend()} x{len(jax.devices())}")
        return 2
    if args.four_cards:
        phase("four-cards", four_card_phase, jax.devices())
    else:
        for i, name in enumerate(("cnv-w1a1", "lfc-w1a1")):
            phase("serve", serve_phase, name, SEED + 100 * i)
        names = sorted(f[:-4] for f in os.listdir(PRETRAINED)
                       if f.endswith(".npz"))
        phase("exact", exact_phase, names, EXACT_BATCH, SEED)
        phase("memory", memory_phase)
        phase("readings", readings_phase)
    if FAILURES:
        emit(ok=False, failed_phases=FAILURES)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
