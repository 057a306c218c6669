"""Minimal HTTP serving endpoint over the continuous-batching server —
the network-facing half of multi-host serving (each host runs one of
these per card; `runtime/frontend.Frontend` or any LB fans requests out).

    python -m bnn_pynq_tpu.runtime.http_server artifacts/cnv-w1a1.npz

Protocol (stdlib-only on both sides):
  POST /classify   body = npz bytes with array 'x' (uint8 image batch)
                   → JSON {"classes": [...], "usec_per_image": float}
  POST /reload     body = npz ARTIFACT bytes (compiler/artifacts.py
                   format) → hot-swaps parameters on the live engine
                   with zero downtime (the reference's
                   load_parameters-on-a-live-overlay contract, SURVEY
                   §3.2; in-flight and queued requests keep the old
                   weights, later batches the new). 409 on topology
                   mismatch.
  GET  /healthz    → 200 "ok" (the Frontend heartbeat probe)
  GET  /stats      → JSON batching stats
"""

from __future__ import annotations

import io
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from bnn_pynq_tpu.runtime.classifier import Classifier
from bnn_pynq_tpu.runtime.serving import BatchingServer


def make_handler(classifier: Classifier, server: BatchingServer):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 + Content-Length on every response → keep-alive, so
        # HttpBackend's per-worker persistent connections actually reuse
        # sockets instead of reconnecting per request.
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                # A stopping server must fail its health check even on an
                # already-open keep-alive connection (handler threads
                # outlive shutdown()), or failover never triggers.
                if server.stopped:
                    self.close_connection = True
                    self._send(503, b"stopping", "text/plain")
                    return
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                self._send(200, json.dumps(
                    server.stats.summary()).encode())
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path not in ("/classify", "/reload"):
                self._send(404, b"not found", "text/plain")
                return
            if server.stopped:
                self.close_connection = True
                self._send(503, json.dumps(
                    {"error": "server stopped"}).encode())
                return
            if self.path == "/reload":
                from bnn_pynq_tpu.compiler.artifacts import load_artifact
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    compiled = load_artifact(
                        io.BytesIO(self.rfile.read(length)))
                    classifier.engine.load_parameters(compiled)
                    self._send(200, json.dumps(
                        {"reloaded": compiled.config.name}).encode())
                except ValueError as e:       # topology mismatch
                    self._send(409, json.dumps({"error": str(e)}).encode())
                except Exception as e:
                    self._send(400, json.dumps({"error": str(e)}).encode())
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                data = np.load(io.BytesIO(self.rfile.read(length)),
                               allow_pickle=False)
                x = data["x"]
                prepared = classifier.engine.prepare(
                    classifier._to_batch(x))
                # one POST = one multi-image request: a single queue
                # entry + future instead of k (the per-image submit path
                # caps a client near 10^5 img/s of pure Python overhead)
                classes = [int(c) for c in
                           server.submit_many(prepared).result(60)]
                self._send(200, json.dumps({
                    "classes": classes,
                    "names": [classifier.class_name(c) for c in classes],
                }).encode())
            except Exception as e:
                self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


def serve(artifact: str, host: str = "127.0.0.1", port: int = 8476,
          runtime: str = "device", route: str = "s2d", block: bool = True,
          warmup: bool = True, max_batch: int = 256,
          max_wait_ms: float = 3.0, batch_buckets=None):
    clf = Classifier.from_artifact(artifact, runtime=runtime, route=route)
    if batch_buckets:
        clf.engine.batch_buckets = tuple(sorted(batch_buckets))
    batcher = BatchingServer(clf.engine, max_batch=max_batch,
                             max_wait_ms=max_wait_ms)
    if warmup:
        # compile every bucket's serving program BEFORE accepting traffic,
        # so no live request waits out a jit compile
        for b in clf.engine.batch_buckets:
            if b <= batcher.max_batch:
                clf.engine.warmup(b)
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(clf, batcher))
    if block:
        print(f"serving {clf.config.name} on http://{host}:{port}")
        try:
            httpd.serve_forever()
        finally:
            batcher.stop()
    else:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd, batcher


if __name__ == "__main__":
    from bnn_pynq_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    serve(sys.argv[1] if len(sys.argv) > 1 else "artifacts/cnv-w1a1.npz",
          port=int(sys.argv[2]) if len(sys.argv) > 2 else 8476)
