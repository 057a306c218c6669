"""Inference engine — the host runtime (SURVEY.md C10/C12 rebuild).

Replaces the reference's C++ offload stack (`FoldedMVOffload`,
`binarizeAndPack`, `ExecAccel` «bnn/src/library/host/foldedmv-offload.cpp»)
and the `PynqBNN` loader «bnn/bnn.py»: loads compiled integer parameters
onto the device once, builds one jitted program per batch bucket, and
exposes classify APIs with per-image latency accounting (`usecPerImage`).

Runtimes (the HW/SW duality of SURVEY.md §4.1):
- 'device' : the production path (`forward_xla` on decoded int8 weights),
             compiled for whatever backend JAX has.
- 'ref'    : dense golden twin (`forward`, bit-exact software emulator).

Routes choose how `device` runs convolutions (MLPs are the same on all):
- 's2d'     : space-to-depth phase dots (ops/conv_s2d.py) — the default.
- 'xla'     : im2col + int8 dot.
- 'xlaconv' : bf16 convolution with exact float32 accumulation.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
from bnn_pynq_tpu.models.config import ConvSpec, NetworkConfig
from bnn_pynq_tpu.models.network import decode_params, forward, forward_xla

RUNTIMES = ("device", "ref")
ROUTES = ("s2d", "xla", "xlaconv")
_CONV_MODE = {"s2d": "s2d", "xla": "patches", "xlaconv": "native"}

DEFAULT_BATCH_BUCKETS = (1, 16, 64, 256, 1024)
# Conv-net forward chunk size inside one jitted program (see
# _forward_acc). Chosen by measurement on the earlier accelerator (README,
# "Origin"); not re-derived on the GPU (ROADMAP).
MICROBATCH = 1024


def prepare_host(config: NetworkConfig, x: np.ndarray) -> np.ndarray:
    """uint8 images → engine input (binarize or center to int8); the host
    half of the reference's `binarizeAndPack` (SURVEY.md C10). Shared by
    InferenceEngine and the TP engines."""
    x = np.asarray(x)
    if config.input_kind == "bipolar":
        flat = x.reshape(x.shape[0], -1)
        if x.dtype == np.uint8:
            return np.where(flat >= 128, 1, -1).astype(np.int8)
        return np.where(flat >= 0, 1, -1).astype(np.int8)
    if x.dtype == np.uint8:
        return (x.astype(np.int32) - 128).astype(np.int8)
    return x.astype(np.int8)


def _epilogue(acc, out_scale, out_bias):
    """int32 logits → float logits (the folded final batch-norm)."""
    return acc.astype(jnp.float32) * out_scale[None, :] + out_bias[None, :]


class InferenceEngine:
    """Loads a CompiledNetwork and serves classifications."""

    def __init__(self, compiled: CompiledNetwork, runtime: str = "device",
                 route: str = "s2d",
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS):
        if runtime not in RUNTIMES:
            raise ValueError(f"unknown runtime {runtime!r}; runtimes are "
                             f"{', '.join(RUNTIMES)}")
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; routes are "
                             f"{', '.join(ROUTES)}")
        self.config: NetworkConfig = compiled.config
        self.runtime = runtime
        self.route = route
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.usecPerImage: Optional[float] = None

        # Device-resident parameters (the analogue of the reference's
        # doInit weight-memory load, SURVEY.md §3.2 — here a plain upload).
        self._set_params(compiled)

        @jax.jit
        def _fn(params, out_scale, out_bias, x):
            return _epilogue(self._forward_acc(params, x), out_scale,
                             out_bias)

        self._fn = _fn
        self._fn_words = None      # built lazily by logits_words()
        self._fn_words_cls = None  # built lazily by words_device(argmax)
        self._fn_cls = None        # built lazily by classify()/logits_device

    def _forward_acc(self, params, x):
        """Traceable forward to int32 logits on the engine's runtime and
        route."""
        config = self.config
        if self.runtime == "ref":
            return forward(config, params, x)
        conv_mode = _CONV_MODE[self.route]

        def fwd(xc):
            return forward_xla(config, params, xc, conv_mode=conv_mode)

        # Conv nets run batches above MICROBATCH as lax.map chunks of
        # MICROBATCH images inside one program, so every dot keeps the
        # chunk's shape; MLPs never chunk (big batches amortize).
        b = x.shape[0]
        has_convs = any(isinstance(sp, ConvSpec) for sp in config.layers)
        if has_convs and b > MICROBATCH and b % MICROBATCH == 0:
            acc = jax.lax.map(
                fwd, x.reshape((b // MICROBATCH, MICROBATCH) + x.shape[1:]))
            return acc.reshape((b,) + acc.shape[2:])
        return fwd(x)

    def _set_params(self, compiled: CompiledNetwork):
        params = [{k: jnp.asarray(v) for k, v in layer.items()}
                  for layer in compiled.layers]
        if self.runtime == "device":
            params = decode_params(self.config, params)
        self.params = params
        self.out_scale = jnp.asarray(compiled.out_scale)
        self.out_bias = jnp.asarray(compiled.out_bias)
        self.compiled = compiled

    def load_parameters(self, compiled: CompiledNetwork):
        """Hot-swap parameters without rebuilding the jitted program — the
        analogue of the reference's `load_parameters`/doInit weight-memory
        writes (SURVEY.md §3.2). The new CompiledNetwork must share the
        engine's topology (same config layers/shapes)."""
        if compiled.config.layers != self.config.layers or \
                compiled.config.wbits != self.config.wbits or \
                compiled.config.abits != self.config.abits:
            raise ValueError("parameter topology mismatch; build a new "
                             "engine for a different network")
        self._set_params(compiled)
        return self

    # -- input preparation ------------------------------------------------
    def prepare(self, x: np.ndarray) -> np.ndarray:
        """uint8 images → engine input (binarize or center to int8); the
        `binarizeAndPack` half that happens on the host."""
        return prepare_host(self.config, x)

    def _pad_to_bucket(self, x: np.ndarray):
        """Pad a leading-batch array up to the next bucket size; returns
        (padded, true_batch). One definition for every entry path."""
        b = x.shape[0]
        bucket = self._bucket(b)
        if bucket != b:
            pad = np.zeros((bucket - b,) + x.shape[1:], dtype=x.dtype)
            x = np.concatenate([x, pad], axis=0)
        return x, b

    def _bucket(self, b: int) -> int:
        for s in self.batch_buckets:
            if b <= s:
                return s
        return -(-b // self.batch_buckets[-1]) * self.batch_buckets[-1]

    # -- inference --------------------------------------------------------
    def logits(self, x: np.ndarray, *, prepared: bool = False) -> np.ndarray:
        """Float logits [B, num_classes]; pads the batch to a bucket size
        to bound recompilation."""
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(x)
        t0 = time.perf_counter()
        out = np.asarray(self._fn(self.params, self.out_scale,
                                  self.out_bias, x))
        dt = time.perf_counter() - t0
        self.usecPerImage = dt * 1e6 / b
        return out[:b]

    def logits_words(self, x_uint8: np.ndarray) -> np.ndarray:
        """Packed input transport: the host bit-packs sign bits into
        uint32 words (32× less host→device traffic than int8 codes — the
        reference's `binarizeAndPack` contract, SURVEY.md C10
        «foldedmv-offload»), and the device unpacks to ±1 values in one
        elementwise op fused into the first layer. Bit-exact with
        prepare()+logits() for any bipolar-input network (the pack stores
        exactly the sign bit that `_input_codes` thresholds on)."""
        from bnn_pynq_tpu import native
        if self.config.input_kind != "bipolar":
            raise ValueError("packed word input is for bipolar-input "
                             "networks (MLPs); conv nets take int8 images")
        words = native.binarize_pack(
            x_uint8.reshape(x_uint8.shape[0], -1))
        words, b = self._pad_to_bucket(words)
        t0 = time.perf_counter()
        out = np.asarray(self._words_fn()(self.params, self.out_scale,
                                          self.out_bias,
                                          jnp.asarray(words)))
        self.usecPerImage = (time.perf_counter() - t0) * 1e6 / b
        return out[:b]

    def _words_fn(self):
        if self._fn_words is None:
            from bnn_pynq_tpu.ops import packing
            n_in = int(np.prod(self.config.input_shape))
            base_fn = self._fn

            @jax.jit
            def _fw(params, out_scale, out_bias, w):
                vals = packing.unpack_bits(w, n_in, axis=-1)
                return base_fn(params, out_scale, out_bias, vals)
            self._fn_words = _fw
        return self._fn_words

    def _words_classify_fn(self):
        if self._fn_words_cls is None:
            base = self._words_fn()

            @jax.jit
            def _fwc(params, out_scale, out_bias, w):
                return jnp.argmax(base(params, out_scale, out_bias, w),
                                  axis=-1).astype(jnp.int32)
            self._fn_words_cls = _fwc
        return self._fn_words_cls

    def words_device(self, words: np.ndarray, *, argmax: bool = False):
        """Async launch from host-packed uint32 words (see logits_words)
        WITHOUT the device→host fetch — the packed-transport twin of
        logits_device, used by the serving dispatcher for bipolar nets:
        32× less host→device traffic per batch."""
        if self.config.input_kind != "bipolar":
            raise ValueError("packed word input is for bipolar-input "
                             "networks")
        words, b = self._pad_to_bucket(np.asarray(words))
        fn = self._words_classify_fn() if argmax else self._words_fn()
        return fn(self.params, self.out_scale, self.out_bias,
                  jnp.asarray(words)), b

    # -- upload/launch split (the BatchingServer's uploader stage) ---------
    # Pad host-side, upload asynchronously, then launch on the
    # device-resident array, so one batch's transfer overlaps another's
    # compute and fetch.

    def upload(self, x_padded: np.ndarray):
        """Async host→device transfer of an already-padded batch."""
        return jax.device_put(x_padded)

    def launch_prepared(self, xd, *, argmax: bool = False,
                        words: bool = False):
        """Launch on a device-resident (already padded, already uploaded)
        batch; returns the device output without fetching."""
        if words:
            fn = self._words_classify_fn() if argmax else self._words_fn()
        else:
            fn = self._classify_fn() if argmax else self._fn
        return fn(self.params, self.out_scale, self.out_bias, xd)

    def _classify_fn(self):
        """jitted device-side argmax variant of _fn: the classify/serving
        path reduces on-device and fetches [B] int32 instead of [B, ncls]
        float logits."""
        if self._fn_cls is None:
            base = self._fn

            @jax.jit
            def _fc(params, out_scale, out_bias, x):
                return jnp.argmax(base(params, out_scale, out_bias, x),
                                  axis=-1).astype(jnp.int32)
            self._fn_cls = _fc
        return self._fn_cls

    def logits_device(self, x: np.ndarray, *, prepared: bool = False,
                      argmax: bool = False):
        """Async launch: pads to a bucket and returns (device_out, b)
        WITHOUT the device→host fetch. The serving dispatcher uses this
        to pipeline: launch batch t+1 while batch t's fetch is still in
        flight. argmax=True returns device class indices instead of
        logits (see _classify_fn)."""
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(x)
        fn = self._classify_fn() if argmax else self._fn
        return fn(self.params, self.out_scale, self.out_bias, x), b

    def classify(self, x: np.ndarray, *, prepared: bool = False) -> np.ndarray:
        """Class indices [B] (the reference's inference_multiple) —
        argmax runs ON DEVICE (see _classify_fn)."""
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(x)
        fn = self._classify_fn()
        t0 = time.perf_counter()
        out = np.asarray(fn(self.params, self.out_scale, self.out_bias, x))
        self.usecPerImage = (time.perf_counter() - t0) * 1e6 / b
        return out[:b]

    def classify_one(self, image: np.ndarray) -> int:
        """Single image (the reference's `inference`)."""
        return int(self.classify(image[None])[0])

    def warmup(self, batch: int = 1, *, serving: bool = True):
        """Compile the engine's programs for `batch`'s bucket before live
        traffic. serving=True (default) also warms the programs the
        serving hot path actually dispatches — the device-argmax classify
        program and, for bipolar nets, the packed-words program — so a
        warmed server never pays a first-request jit compile."""
        shape = ((batch, np.prod(self.config.input_shape))
                 if self.config.input_kind == "bipolar"
                 else (batch,) + self.config.input_shape)
        dummy = np.zeros(shape, dtype=np.int8)
        self.logits(dummy, prepared=True)
        if serving:
            out, _ = self.logits_device(dummy, prepared=True, argmax=True)
            outs = [out]
            if self.config.input_kind == "bipolar":
                words = np.zeros(
                    (batch, -(-int(np.prod(self.config.input_shape)) // 32)),
                    dtype=np.uint32)
                for am in (True, False):
                    out, _ = self.words_device(words, argmax=am)
                    outs.append(out)
            jax.block_until_ready(outs)
        return self

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_artifact(cls, path: str, **kw) -> "InferenceEngine":
        from bnn_pynq_tpu.compiler.artifacts import load_artifact
        return cls(load_artifact(path), **kw)

    @classmethod
    def from_training(cls, config, params, batch_stats, **kw):
        from bnn_pynq_tpu.compiler.finnthesizer import compile_network
        return cls(compile_network(config, params, batch_stats), **kw)
