"""Tensor-parallel inference over a ('data','model') mesh.

Replacement for the reference's PE parallelism (SURVEY.md §2: output-
channel PE folding → output-channel sharding of the weight matrices over
the mesh's 'model' axis). Megatron-style column parallelism:

- every decoded int8 weight matrix [K, N] (conv: HWIO [kh, kw, C, N]) and
  threshold table [nthr, N] is sharded on N over 'model' (replicated over
  'data');
- each device computes its local output channels with the same integer
  ops as one device (`ref.int_matmul_ref` + `multithreshold`), then the
  (tiny, 1/2-bit coded) activations are all-gathered over 'model' so the
  next layer sees its full contraction axis;
- the batch is sharded over 'data' (pure data parallelism — the analogue
  of the reference's `numReps` batch streaming);
- a final dense layer fed by a dense layer is row-sharded instead: each
  device multiplies the output-channel shard it already holds by the
  matching weight rows, and one psum of the [B, classes] int32 partials
  finishes it (no all-gather before it). Any other final layer is
  replicated and reads the gathered input.

Built with shard_map so the schedule (one all-gather per layer) is
explicit. parallel/overlap.py replaces the gathers with rings.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
from bnn_pynq_tpu.models.config import NetworkConfig
from bnn_pynq_tpu.models.network import (_input_codes, decode_params,
                                         make_plan)
from bnn_pynq_tpu.parallel.mesh import gather_channels
from bnn_pynq_tpu.ops import ref
from bnn_pynq_tpu.ops.conv import maxpool2d, sliding_window
from bnn_pynq_tpu.ops.thresholds import codes_to_values, multithreshold


def _row_sharded_last(plan) -> bool:
    """True when the final layer is dense and fed by a dense layer, whose
    output-channel shard is exactly a row block of the final weights."""
    compute = [lp for lp in plan if lp.kind != "pool"]
    return len(compute) > 1 and compute[-1].kind == "dense" \
        and compute[-2].kind == "dense"


def param_specs(config: NetworkConfig):
    """PartitionSpec pytree matching the decoded params list."""
    plan = make_plan(config)
    row_last = _row_sharded_last(plan)
    specs = []
    for lp in plan:
        if lp.kind == "pool":
            specs.append({})
            continue
        key = "w_hwio" if lp.kind == "conv" else "w_int8"
        ndim = 4 if key == "w_hwio" else 2
        if lp.last:
            specs.append({key: P("model", None) if row_last
                          else P(*([None] * ndim))})
        else:
            specs.append({key: P(*([None] * (ndim - 1) + ["model"])),
                          "thr": P(None, "model")})
    return specs


def shard_params(params, mesh: Mesh, config: NetworkConfig):
    """device_put the decoded param list with TP shardings."""
    specs = param_specs(config)
    return [
        {k: jax.device_put(v, NamedSharding(mesh, specs[i][k]))
         for k, v in layer.items()}
        for i, layer in enumerate(params)
    ]


def make_tp_forward(config: NetworkConfig, mesh: Mesh):
    """Returns a jitted fn(params, out_scale, out_bias, x) → float logits,
    sharded batch over 'data' and weights over 'model'. `params` is the
    decoded list (`decode_params`) placed by `shard_params`."""
    plan = make_plan(config)
    row_last = _row_sharded_last(plan)

    def local_forward(params, out_scale, out_bias, x):
        if config.input_kind == "bipolar":
            act = _input_codes(config, x.reshape(x.shape[0], -1))
        else:
            act = jnp.asarray(x, dtype=jnp.int8)
        for li, (lp, p) in enumerate(zip(plan, params)):
            thr = None if lp.last else p.get("thr")
            if lp.kind == "pool":
                act = maxpool2d(act, lp.window)
                continue
            # raw int8 image input feeds the first conv; codes elsewhere
            vals = act if lp.kind == "conv_int8" else \
                codes_to_values(act, config.abits)
            if lp.kind == "dense":
                if vals.ndim > 2:
                    vals = vals.reshape(vals.shape[0], -1)
                acc = ref.int_matmul_ref(vals, p["w_int8"])
                if lp.last and row_last:
                    acc = jax.lax.psum(acc, "model")
            else:
                w = p["w_hwio"] if "w_hwio" in p else p["w_int8"]
                patches = sliding_window(vals, lp.kernel, lp.kernel,
                                         lp.stride)
                b, oh, ow, k = patches.shape
                acc = ref.int_matmul_ref(patches.reshape(b * oh * ow, k),
                                         w.reshape(k, -1))
                acc = acc.reshape(b, oh, ow, -1)
            if lp.last:
                act = acc
                break
            act = multithreshold(acc, thr)
            if not (row_last and plan[li + 1].last):
                # gather this layer's output channels from the model axis
                act = gather_channels(act)
        return act.astype(jnp.float32) * out_scale[None, :] \
            + out_bias[None, :]

    fn = jax.shard_map(
        local_forward, mesh=mesh,
        in_specs=(param_specs(config), P(None), P(None), P("data")),
        out_specs=P("data"),
        check_vma=False,
    )
    return jax.jit(fn)


def make_gspmd_engine(compiled: CompiledNetwork, mesh: Mesh):
    """GSPMD tensor+data-parallel inference: forward_xla is pure XLA ops,
    so instead of shard_map this only annotates shardings (decoded
    weights/thresholds on output channels over 'model' when divisible,
    batch over 'data') and lets XLA insert the collectives."""
    from bnn_pynq_tpu.models.network import (decode_params, forward_xla,
                                             make_plan)
    config = compiled.config
    model_size = mesh.shape["model"]
    plan = make_plan(config)
    raw = [{k: jnp.asarray(v) for k, v in layer.items()}
           for layer in compiled.layers]
    decoded = decode_params(config, raw)

    sharded = []
    for lp, p in zip(plan, decoded):
        q = {}
        for name, arr in p.items():
            if lp.last or arr.shape[-1] % model_size != 0:
                spec = P()
            else:
                spec = P(*([None] * (arr.ndim - 1) + ["model"]))
            q[name] = jax.device_put(arr, NamedSharding(mesh, spec))
        sharded.append(q)
    out_scale = jax.device_put(jnp.asarray(compiled.out_scale),
                               NamedSharding(mesh, P()))
    out_bias = jax.device_put(jnp.asarray(compiled.out_bias),
                              NamedSharding(mesh, P()))

    @jax.jit
    def fn(params, scale, bias, x):
        acc = forward_xla(config, params, x)
        return acc.astype(jnp.float32) * scale[None, :] + bias[None, :]

    data_sh = NamedSharding(mesh, P("data"))

    def logits(x_prepared):
        x = jax.device_put(jnp.asarray(x_prepared), data_sh)
        return np.asarray(fn(sharded, out_scale, out_bias, x))

    return logits


class TPInferenceEngine:
    """Multi-device tensor-parallel engine (same API surface as
    runtime.InferenceEngine.logits/classify for prepared inputs; serving
    hooks — bucketed async launch with device argmax and parameter
    hot-swap — so BatchingServer can pipeline over it)."""

    def __init__(self, compiled: CompiledNetwork, mesh: Mesh,
                 batch_buckets=(1, 16, 64, 256, 1024)):
        self.compiled = compiled
        self.config = compiled.config
        self.mesh = mesh
        self._data_d = mesh.shape.get("data", 1)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self._load_params(compiled)
        self._fn = make_tp_forward(compiled.config, mesh)
        self._fn_cls = None
        self._data_sh = NamedSharding(mesh, P("data"))

    def load_parameters(self, compiled: CompiledNetwork):
        """Hot-swap sharded parameters on the live engine (the
        doInit-while-live contract, SURVEY.md §3.2); topology must match."""
        if compiled.config.layers != self.config.layers or \
                compiled.config.wbits != self.config.wbits or \
                compiled.config.abits != self.config.abits:
            raise ValueError("parameter topology mismatch; build a new "
                             "engine for a different network")
        self._load_params(compiled)
        return self

    def _load_params(self, compiled: CompiledNetwork):
        """Decode once, shard-place weights, replicate the scale/bias
        over the mesh (no array of the engine lives on one device)."""
        raw = [{k: jnp.asarray(v) for k, v in layer.items()}
               for layer in compiled.layers]
        self.params = shard_params(decode_params(self.config, raw),
                                   self.mesh, self.config)
        rep = NamedSharding(self.mesh, P())
        self.out_scale = jax.device_put(jnp.asarray(compiled.out_scale), rep)
        self.out_bias = jax.device_put(jnp.asarray(compiled.out_bias), rep)
        self.compiled = compiled

    def prepare(self, x):
        from bnn_pynq_tpu.runtime.engine import prepare_host
        return prepare_host(self.config, x)

    def _bucket(self, b: int) -> int:
        dd = self._data_d
        for s in self.batch_buckets:
            s = -(-s // dd) * dd
            if b <= s:
                return s
        top = -(-self.batch_buckets[-1] // dd) * dd
        return -(-b // top) * top

    def _classify_fn(self):
        if self._fn_cls is None:
            base = self._fn

            @jax.jit
            def _fc(params, s, b, x):
                return jnp.argmax(base(params, s, b, x),
                                  axis=-1).astype(jnp.int32)
            self._fn_cls = _fc
        return self._fn_cls

    def upload(self, x_padded):
        """Async sharded host→device transfer (serving uploader hook)."""
        return jax.device_put(jnp.asarray(x_padded), self._data_sh)

    def launch_prepared(self, xd, *, argmax: bool = False,
                        words: bool = False):
        """Launch on a device-resident sharded batch without fetching."""
        if words:
            raise ValueError("TPInferenceEngine has no packed-words path")
        fn = self._classify_fn() if argmax else self._fn
        return fn(self.params, self.out_scale, self.out_bias, xd)

    def logits_device(self, x, *, prepared: bool = True,
                      argmax: bool = False):
        """Async sharded launch without the device→host fetch (pipelined
        dispatch hook for BatchingServer): returns (device_out, b)."""
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(np.asarray(x))
        xd = jax.device_put(jnp.asarray(x), self._data_sh)
        fn = self._classify_fn() if argmax else self._fn
        return fn(self.params, self.out_scale, self.out_bias, xd), b

    def _pad_to_bucket(self, x: np.ndarray):
        b = x.shape[0]
        bucket = self._bucket(b)
        if bucket != b:
            x = np.concatenate(
                [x, np.zeros((bucket - b,) + x.shape[1:], x.dtype)])
        return x, b

    def logits(self, x_prepared, *, prepared: bool = True):
        x = x_prepared if prepared else self.prepare(x_prepared)
        return np.asarray(self._fn(self.params, self.out_scale,
                                   self.out_bias, x))

    def classify(self, x_prepared, *, prepared: bool = True):
        return self.logits(x_prepared, prepared=prepared).argmax(-1)
