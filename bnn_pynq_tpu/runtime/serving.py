"""Continuous-batching classification server (BASELINE.json north star:
"continuous batching of classification requests across hosts").

Single-host building block: requests enqueue individually; a dispatcher
thread drains the queue into device-sized batches (up to `max_batch`,
waiting at most `max_wait_ms` for stragglers), runs the engine once per
batch, and resolves per-request futures. This is the device-side analogue
of the reference's `numReps` batch streaming (SURVEY.md §2), made dynamic.

Multi-host: each host runs one BatchingServer per card over its own engine
(or one over a tensor-sharded engine, parallel/); a front-end
(runtime/frontend.py) fans requests out over the network.
Latency percentiles are tracked per request for the p50 metric in
BASELINE.md.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

# Latency samples kept for percentile estimation. Bounded: a long-lived
# server must not grow its stats without limit; the newest window is what
# the p50/p99 metrics mean operationally anyway.
STATS_WINDOW = 65536


@dataclass
class ServerStats:
    requests: int = 0
    images: int = 0
    batches: int = 0
    latencies_ms: Deque[float] = field(
        default_factory=lambda: deque(maxlen=STATS_WINDOW))

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return float("nan")
        return float(np.percentile(np.fromiter(self.latencies_ms, float), p))

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "images": self.images,
            "batches": self.batches,
            "mean_batch": self.images / max(1, self.batches),
            "p50_ms": self.percentile(50),
            "p99_ms": self.percentile(99),
        }


class _Request:
    __slots__ = ("x", "n", "future", "t_enqueue")

    def __init__(self, x, n=0):
        self.x = x
        self.n = n                     # 0 = single image (no batch dim)
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()

    @property
    def n_images(self) -> int:
        return self.n if self.n else 1


class BatchingServer:
    """Continuous batching over an InferenceEngine (or any object with
    `classify(x, prepared=True)` / `logits`)."""

    def __init__(self, engine, max_batch: int = 256,
                 max_wait_ms: float = 2.0, return_logits: bool = False,
                 pipeline_depth: int = 2, adaptive_wait: bool = True,
                 upload_pipeline: bool = False):
        """pipeline_depth: number of batches in flight at once. With
        depth >= 2 the dispatcher launches batch t+1 while a collector
        thread blocks on batch t's device->host fetch, overlapping
        launch+compute with the previous fetch. Depth 1 = synchronous
        dispatch. Requires the engine to expose logits_device(); other
        engines fall back to sync dispatch.

        upload_pipeline: run the host→device input transfer in a
        dedicated uploader stage ({upload ∥ launch ∥ fetch}) — the
        analogue of the reference's DMA-burst-while-compute path
        («foldedmv-offload.cpp», SURVEY C8). It also moves the host-side
        pack/pad off the dispatch-latency path. Off by default; the
        default was chosen on the earlier accelerator's remote link
        (README, "Origin") and has not been re-derived on the GPU
        (ROADMAP). Requires the engine's upload/launch_prepared split;
        auto-disabled otherwise.

        adaptive_wait (the latency tier): when the device is IDLE (no
        batch launched and unresolved) the dispatcher sends whatever is
        already queued immediately instead of holding it `max_wait_ms`
        hoping for stragglers — a lone request at low load pays the sync
        floor, not floor + wait + big-bucket padding (the reference's
        `classify_image` had no queueing penalty, «bnn.py» SURVEY C12).
        Under load the device is busy, so collection windows stay open
        and batches still aggregate to max_batch. False = always wait
        (throughput-only behavior)."""
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.return_logits = return_logits
        self.adaptive_wait = adaptive_wait
        self.pipeline_depth = (pipeline_depth
                               if hasattr(engine, "logits_device") else 1)
        # packed word transport for bipolar (MLP) engines: words are 32x
        # smaller than int8 codes. Chosen for the earlier accelerator's
        # slow remote link (README, "Origin"); whether it pays over local
        # PCIe is not measured yet (ROADMAP). The dispatcher packs each
        # dispatched batch with the native library.
        self.packed_transport = bool(
            self.pipeline_depth > 1
            and getattr(getattr(engine, "config", None), "input_kind",
                        None) == "bipolar"
            and hasattr(engine, "words_device"))
        self.stats = ServerStats()
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        # one-slot carry-over: a request _collect could not fit without
        # pushing the batch past max_batch (dispatcher-thread-only state)
        self._carry: Optional[_Request] = None
        # batches launched but not yet resolved — the adaptive_wait
        # "device idle" signal. Written by the dispatcher (+1) and the
        # resolving thread (-1); int updates are GIL-atomic and the
        # signal is advisory (a stale read only changes wait policy).
        self._busy = 0
        # when the last batch was dispatched: the adaptive tier only
        # short-circuits the wait when the server has ALSO been quiet
        # for >= max_wait — at saturation the queue empties for brief
        # instants between closed-loop client resubmissions, and
        # dispatching those instants immediately fragments batches that
        # each pay the fixed launch+fetch round trip
        self._last_dispatch = 0.0
        self._stop = threading.Event()
        self.upload_pipeline = bool(
            upload_pipeline and self.pipeline_depth > 1
            and hasattr(engine, "upload")
            and hasattr(engine, "launch_prepared")
            and hasattr(engine, "_pad_to_bucket"))
        if self.pipeline_depth > 1:
            self._inflight: "queue.Queue" = queue.Queue(
                maxsize=self.pipeline_depth - 1)
            self._collector = threading.Thread(target=self._collect_loop,
                                               daemon=True)
            self._collector.start()
        if self.upload_pipeline:
            # up to 2 transfers queued ahead of the launch stage
            self._upload_q: "queue.Queue" = queue.Queue(maxsize=2)
            self._uploader = threading.Thread(target=self._upload_loop,
                                              daemon=True)
            self._uploader.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API -------------------------------------------------------
    def submit(self, x_prepared: np.ndarray) -> Future:
        """Enqueue ONE prepared input (no batch dim); resolves to the class
        index (or logits). After stop(), resolves immediately with an
        error — a stopped server must fail fast, not strand requests
        (clients behind keep-alive connections would otherwise hang on a
        queue nobody drains; the Frontend failover path depends on the
        fast error to re-dispatch)."""
        req = _Request(np.asarray(x_prepared))
        if self._stop.is_set():
            req.future.set_exception(RuntimeError("server stopped"))
            return req.future
        self._q.put(req)
        return req.future

    def submit_many(self, x_prepared: np.ndarray) -> Future:
        """Enqueue a multi-image request (leading batch dim k >= 1); one
        queue entry, one future resolving to the k class indices (or
        logits). This is the realistic client contract — per-image
        submit() pays Python overhead per image, which caps a single
        client regardless of engine capacity — and counts as k images
        toward the dispatcher's max_batch."""
        x = np.asarray(x_prepared)
        if x.ndim == 0 or len(x) == 0:
            raise ValueError("submit_many needs a leading batch dim")
        if self._stop.is_set():
            f: Future = Future()
            f.set_exception(RuntimeError("server stopped"))
            return f
        if len(x) <= self.max_batch:
            req = _Request(x, n=len(x))
            self._q.put(req)
            return req.future
        # split oversized requests into max_batch-sized chunks so one
        # giant POST can never force an unplanned jit compile of a
        # never-before-seen bucket on the serving hot path; the outer
        # future resolves once every chunk resolves, in order
        chunks = [x[i:i + self.max_batch]
                  for i in range(0, len(x), self.max_batch)]
        inner = []
        for c in chunks:
            req = _Request(c, n=len(c))
            self._q.put(req)
            inner.append(req.future)
        outer: Future = Future()
        remaining = [len(inner)]
        lock = threading.Lock()

        def on_done(fut):
            if outer.done():
                return
            err = fut.exception()
            if err is not None:
                outer.set_exception(err)
                return
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                outer.set_result(np.concatenate(
                    [np.asarray(f.result()) for f in inner]))

        for f in inner:
            f.add_done_callback(on_done)
        return outer

    def classify(self, x_prepared: np.ndarray, timeout: float = 60.0):
        return self.submit(x_prepared).result(timeout)

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def stop(self):
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=10)
        if self.upload_pipeline:
            try:
                self._upload_q.put(None, timeout=5)
            except queue.Full:
                pass
            self._uploader.join(timeout=30)
            # run any not-yet-uploaded accepted batches synchronously so
            # their requests get answers, not "server stopped"
            try:
                while True:
                    item = self._upload_q.get_nowait()
                    if item is None:
                        continue
                    batch, padded, b = item
                    try:
                        xd = self.engine.upload(padded)
                        dev_out = self.engine.launch_prepared(
                            xd, argmax=not self.return_logits,
                            words=self.packed_transport)
                        self._resolve(batch, np.asarray(dev_out)[:b])
                    except Exception as e:
                        self._fail(batch, e)
            except queue.Empty:
                pass
        if self.pipeline_depth > 1:
            # the dispatcher checks _stop between bounded put attempts,
            # so the slot frees within its timeout unless the collector
            # is wedged inside a device fetch — in that case drop the
            # sentinel on the floor rather than deadlocking stop(); the
            # collector is a daemon thread and cannot be interrupted
            # mid-fetch anyway
            try:
                self._inflight.put(None, timeout=5)
            except queue.Full:
                pass
            self._collector.join(timeout=30)
            # the dispatcher's final put can land AFTER the sentinel in
            # FIFO order, so the collector may exit with computed batches
            # still in _inflight — resolve them here (the device work is
            # done; only the fetch remains)
            try:
                while True:
                    item = self._inflight.get_nowait()
                    if item is None:
                        continue
                    batch, dev_out, b = item
                    try:
                        self._resolve(batch, np.asarray(dev_out)[:b])
                    except Exception as e:
                        self._fail(batch, e)
            except queue.Empty:
                pass
        # fail anything still queued so no future is stranded
        if self._carry is not None:
            if not self._carry.future.done():
                self._carry.future.set_exception(
                    RuntimeError("server stopped"))
            self._carry = None
        try:
            while True:
                r = self._q.get_nowait()
                if r is not None and not r.future.done():
                    r.future.set_exception(RuntimeError("server stopped"))
        except queue.Empty:
            pass

    # -- dispatcher -------------------------------------------------------
    def _try_add(self, batch: List[_Request], n_imgs: int, r: _Request):
        """Append r to batch unless it would push past max_batch; an
        overflowing request goes to the one-slot carry-over, consumed
        first by the next _collect — so a dispatched batch NEVER exceeds
        max_batch and can never force an unplanned jit compile of a
        never-warmed bucket mid-serving (the submit_many splitting
        invariant, which interleaved multi-image clients could otherwise
        defeat). Returns the new image count, or None when r was carried
        (collection must stop — the slot is full)."""
        if n_imgs + r.n_images > self.max_batch:
            self._carry = r
            return None
        batch.append(r)
        return n_imgs + r.n_images

    def _downstream_full(self) -> bool:
        """True when every pipeline slot is occupied — dispatching now
        would only block on a stage queue, so the batch may as well keep
        growing (continuous batching: batch size scales to the service
        rate instead of the wall-clock max_wait window)."""
        if self.upload_pipeline and self._upload_q.full():
            return True
        return self.pipeline_depth > 1 and self._inflight.full()

    def _collect(self) -> List[_Request]:
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                return []
            if first is None:
                return []
        batch = [first]
        n_imgs = first.n_images
        deadline = time.perf_counter() + self.max_wait_s
        while n_imgs < self.max_batch:
            # latency tier: device idle + queue drained + genuinely low
            # load (no dispatch within the last max_wait window) ->
            # dispatch NOW rather than holding a lone request
            if self.adaptive_wait and self._busy == 0 and self._q.empty() \
                    and time.perf_counter() - self._last_dispatch \
                    >= self.max_wait_s:
                break
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                if self.adaptive_wait and self._downstream_full():
                    # every downstream slot is busy: dispatching would
                    # just block; extend the window so the batch grows
                    # toward max_batch instead of queueing many small
                    # batches that each pay the round-trip floor
                    deadline = time.perf_counter() + self.max_wait_s
                    continue
                try:
                    while n_imgs < self.max_batch:
                        r = self._q.get_nowait()
                        if r is None:
                            return batch
                        n_imgs = self._try_add(batch, n_imgs, r)
                        if n_imgs is None:
                            return batch
                except queue.Empty:
                    pass
                break
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if r is None:
                break
            n_imgs = self._try_add(batch, n_imgs, r)
            if n_imgs is None:
                break
        return batch

    def _resolve(self, batch, outs):
        now = time.perf_counter()
        off = 0
        for r in batch:
            k = r.n_images
            # a client may have cancelled its future (e.g. result()
            # timeout); set_result on a CANCELLED future raises
            # InvalidStateError and would kill the serving thread
            if not r.future.done():
                r.future.set_result(outs[off:off + k] if r.n else outs[off])
            off += k
            self.stats.latencies_ms.append((now - r.t_enqueue) * 1e3)
        self.stats.requests += len(batch)
        self.stats.images += off
        self.stats.batches += 1
        self._busy -= 1

    def _fail(self, batch, err):
        """Resolve every live future in batch with err (cancel-safe)."""
        for r in batch:
            if not r.future.done():
                r.future.set_exception(err)
        self._busy -= 1

    def _put_bounded(self, q, item) -> bool:
        """Bounded put attempts that cannot deadlock shutdown: re-check
        _stop between attempts; on stop make ONE final bounded attempt
        (stop() drains the stage queues after joining their threads, so
        an accepted item still gets processed)."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            return False

    def _upload_loop(self):
        """Uploader stage: device_put the next padded batch (async call;
        the transfer streams in the background) and launch it, keeping
        transfers back-to-back while the collector blocks on fetches —
        {upload ∥ launch ∥ fetch}."""
        while True:
            item = self._upload_q.get()
            if item is None:
                return
            batch, padded, b = item
            try:
                xd = self.engine.upload(padded)
                dev_out = self.engine.launch_prepared(
                    xd, argmax=not self.return_logits,
                    words=self.packed_transport)
            except Exception as e:
                self._fail(batch, e)
                continue
            if not self._put_bounded(self._inflight, (batch, dev_out, b)):
                self._fail(batch, RuntimeError("server stopped"))

    def _collect_loop(self):
        """Pipelined-mode fetch stage: blocks on the device->host fetch
        of batch t while the dispatcher is already launching t+1."""
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, dev_out, b = item
            try:
                # argmax already ran on device when return_logits=False
                outs = np.asarray(dev_out)[:b]
            except Exception as e:
                self._fail(batch, e)
                continue
            self._resolve(batch, outs)

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            xs = np.concatenate(
                [r.x if r.n else r.x[None] for r in batch])
            self._busy += 1
            self._last_dispatch = time.perf_counter()
            try:
                if self.upload_pipeline:
                    # stage 1 only: host-side pack+pad, then hand to the
                    # uploader (transfer + launch) → collector (fetch)
                    arr = xs
                    if self.packed_transport:
                        from bnn_pynq_tpu import native
                        arr = native.pack_bits(xs.reshape(xs.shape[0], -1))
                    padded, b = self.engine._pad_to_bucket(np.asarray(arr))
                    if not self._put_bounded(self._upload_q,
                                             (batch, padded, b)):
                        self._fail(batch, RuntimeError("server stopped"))
                    continue
                if self.pipeline_depth > 1:
                    if self.packed_transport:
                        from bnn_pynq_tpu import native
                        words = native.pack_bits(
                            xs.reshape(xs.shape[0], -1))
                        dev_out, b = self.engine.words_device(
                            words, argmax=not self.return_logits)
                    else:
                        dev_out, b = self.engine.logits_device(
                            xs, prepared=True,
                            argmax=not self.return_logits)
                    if not self._put_bounded(self._inflight,
                                             (batch, dev_out, b)):
                        self._fail(batch, RuntimeError("server stopped"))
                    continue
                if self.return_logits:
                    outs = self.engine.logits(xs, prepared=True)
                else:
                    outs = self.engine.classify(xs, prepared=True)
            except Exception as e:  # resolve futures with the error
                self._fail(batch, e)
                continue
            self._resolve(batch, outs)
