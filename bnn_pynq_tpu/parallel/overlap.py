"""Collective/compute-overlapped tensor parallelism (SURVEY.md §5.8's
first-class "collective-compute overlap" component).

The plain TP engine (parallel/tp.py) all-gathers every layer's output
channels before the next layer — a blocking collective between every
pair of matmuls. This module never gathers: activations stay
output-shard-resident, and each next layer consumes them with a RING —
at step t the device computes with the shard it currently holds against
the matching slice of its local (column-sharded) weights, while
`lax.ppermute` forwards the shard to the neighbor. XLA splits each
permute into `collective-permute-start/done` around the compute (on the
GPU too), so the transfer of shard t+1 overlaps the dot on shard t — the
standard Megatron-style all-gather-overlap pattern, expressed with
shard_map so the schedule is explicit.

Layer shardings (MLP):
- hidden W_j [K_j, N_j]: column-sharded P(None, 'model'), FULL rows
  (each device owns every row of its output-channel slice);
- thresholds: P(None, 'model');
- final W_L [K_L, ncls]: row-sharded P('model', None) — each device
  contributes its held shard's partial product, one psum finishes it;
- batch over 'data'.

Conv networks (CNV — BASELINE config #5's tensor-sharded serving): conv
is LINEAR in the input-channel axis, so the same ring applies — conv
weights are output-channel-sharded P(None,None,None,'model') with FULL
input channels; at ring step t the device convolves the activation
C-shard it holds against `w_hwio[:, :, shard_rows, :]` (a contiguous
slice — no host reorder needed) and accumulates int32 partials. Pools
act channelwise on the sharded activations (zero communication). The
one layout subtlety is the conv→dense flatten: locally flattening a
C-sharded [B,h,w,Cs] map produces rows in (hw, c_within) order, so the
first dense layer's weight ROWS are permuted host-side at load into
(c_block, hw, c_within) order (`reorder_dense_rows_for_csharding`) —
after which it rings exactly like any MLP hidden layer.

All compute runs on decoded int8 level weights (decode once at load);
convs use the bf16-exact convolution (models/network._conv_bf16_exact —
integer-exact, documented there).

`blocking=True` builds the same math with an all-gather after every
layer instead of rings — the control arm for overlap-vs-blocking
comparisons (`arm='auto'`, `chip_smoke.py --four-cards`) and a second
exactness witness.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bnn_pynq_tpu.compiler.finnthesizer import CompiledNetwork
from bnn_pynq_tpu.models.network import (_conv_bf16_exact, _input_codes,
                                         decode_params, make_plan)
from bnn_pynq_tpu.ops.conv import maxpool2d
from bnn_pynq_tpu.parallel.mesh import gather_channels


def _levels(codes, abits):
    return (2 * codes.astype(jnp.int32)
            - (1 if abits == 1 else 3)).astype(jnp.int8)


def _threshold(acc, thr):
    """codes = Σ_t (acc >= thr_t), broadcasting thr rows over leading dims."""
    code = jnp.zeros(acc.shape, jnp.int32)
    for t in range(thr.shape[0]):
        code = code + (acc >= thr[t]).astype(jnp.int32)
    return code


def _ring(perm_axis_size, my, cur, partial_fn):
    """Generic overlap ring: accumulate partial_fn(shard_idx, shard) over
    all d shards while ppermuting the held shard to the right neighbor;
    XLA overlaps the permute of shard t+1 with the compute on shard t."""
    d = perm_axis_size
    acc = None
    for t in range(d):
        idx = (my - t) % d
        part = partial_fn(idx, cur)
        acc = part if acc is None else acc + part
        if t != d - 1:
            cur = jax.lax.ppermute(
                cur, "model", perm=[(i, (i + 1) % d) for i in range(d)])
    return acc


def reorder_dense_rows_for_csharding(w, hw: int, c: int, d: int):
    """Permute dense rows from flatten order (hw, c) to the order a
    C-sharded local flatten produces: (c_block, hw, c_within). Row block
    `idx` of the result is then the contiguous [idx·K/d, (idx+1)·K/d)
    slice the ring's dynamic_slice expects."""
    k, _ = w.shape
    if k != hw * c or c % d != 0:
        raise ValueError(f"rows {k} != hw*c {hw * c} or C {c} % d {d}")
    cs = c // d
    idx = np.arange(k)
    h_, cc = idx // c, idx % c
    new = (cc // cs) * (hw * cs) + h_ * cs + (cc % cs)
    out = np.empty_like(np.asarray(w))
    out[new] = np.asarray(w)[idx]
    return out


def _validate_divisibility(config, plan, d):
    for i, lp in enumerate(plan):
        if lp.kind == "pool":
            continue
        if not lp.last and lp.n % d != 0:
            raise ValueError(
                f"layer {i}: output width {lp.n} not divisible by "
                f"model axis {d}")
        if lp.last and lp.k % d != 0:
            raise ValueError(
                f"final layer contraction {lp.k} not divisible by "
                f"model axis {d}")


def make_overlap_tp_forward(config, mesh: Mesh, *, blocking: bool = False):
    """jitted fn(weights, thrs, out_scale, out_bias, x) → float32 logits.
    weights/thrs are lists (sharded per the module docstring). Supports
    all-dense MLPs and conv networks (conv → pool → dense tail)."""
    plan = make_plan(config)
    abits = config.abits
    d = mesh.shape["model"]
    _validate_divisibility(config, plan, d)

    def local_forward(weights, thrs, out_scale, out_bias, x):
        my = jax.lax.axis_index("model")
        if config.input_kind == "bipolar":
            codes = _input_codes(config, x.reshape(x.shape[0], -1))
            act = _levels(codes, abits)
        else:
            act = jnp.asarray(x, dtype=jnp.int8)   # raw int8 image levels

        replicated_in = True   # layer 0 input is replicated over 'model'
        wi = 0                 # index into weights/thrs lists
        for li, lp in enumerate(plan):
            if lp.kind == "pool":
                act = maxpool2d(act, lp.window)    # channelwise: no comm
                continue
            if lp.kind in ("conv", "conv_int8"):
                w = weights[wi]                    # [kh,kw,C(full),N/d]
                if replicated_in:
                    acc = _conv_bf16_exact(act, w, lp.stride)
                else:
                    cs = w.shape[2] // d

                    def conv_part(idx, cur, w=w, cs=cs, s=lp.stride):
                        rows = jax.lax.dynamic_slice_in_dim(
                            w, idx * cs, cs, axis=2)
                        return _conv_bf16_exact(cur, rows, s)
                    if blocking:
                        acc = _conv_bf16_exact(gather_channels(act), w,
                                               lp.stride)
                    else:
                        acc = _ring(d, my, act, conv_part)
            else:
                if act.ndim > 2:
                    act = act.reshape(act.shape[0], -1)
                w = weights[wi]
                if lp.last:
                    # row-sharded final layer: partial dot + one psum
                    part = jax.lax.dot_general(
                        act, w, dimension_numbers=(((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32)
                    acc = jax.lax.psum(part, "model")
                elif replicated_in:
                    acc = jax.lax.dot_general(
                        act, w, dimension_numbers=(((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.int32)
                else:
                    kshard = w.shape[0] // d

                    def dense_part(idx, cur, w=w, kshard=kshard):
                        rows = jax.lax.dynamic_slice_in_dim(
                            w, idx * kshard, kshard, axis=0)
                        return jax.lax.dot_general(
                            cur, rows,
                            dimension_numbers=(((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
                    if blocking:
                        acc = jax.lax.dot_general(
                            gather_channels(act), w,
                            dimension_numbers=(((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
                    else:
                        acc = _ring(d, my, act, dense_part)
            if lp.last:
                return acc.astype(jnp.float32) * out_scale[None, :] \
                    + out_bias[None, :]
            act = _levels(_threshold(acc, thrs[wi]), abits)
            replicated_in = False
            wi += 1
        raise AssertionError("plan had no final layer")

    w_specs, t_specs = [], []
    for lp in plan:
        if lp.kind == "pool":
            continue
        if lp.last:
            w_specs.append(P("model", None))
        elif lp.kind in ("conv", "conv_int8"):
            w_specs.append(P(None, None, None, "model"))
            t_specs.append(P(None, "model"))
        else:
            w_specs.append(P(None, "model"))
            t_specs.append(P(None, "model"))
    fn = jax.shard_map(
        local_forward, mesh=mesh,
        in_specs=(tuple(w_specs), tuple(t_specs), P(None), P(None),
                  P("data")),
        out_specs=P("data"),
        check_vma=False,
    )
    return jax.jit(fn)


class OverlapTPEngine:
    """Multi-chip engine with overlapped collectives (same logits API as
    runtime.InferenceEngine; supports MLPs and conv networks). Can be
    owned by runtime.serving.BatchingServer: `classify(xs, prepared=True)`
    pads the batch to a data-axis multiple internally.

    arm selection: the ring is not universally the right arm — it
    serializes d small dots (each a dynamic_slice + dot + ppermute) where
    blocking does one gather + one wide dot, so for MLPs the per-step
    compute may be too small to hide the permute latency. `arm='auto'`
    therefore builds both programs and times them on the actual
    (network, mesh, calib batch), keeping the faster; 'ring'/'blocking'
    force an arm. The choice and its
    measurement are recorded on `.arm` / `.arm_reason` and in repr()."""

    def __init__(self, compiled: CompiledNetwork, mesh: Mesh,
                 blocking: bool = False, arm: str = None,
                 calib_batch: int = None, calib_iters: int = 10,
                 batch_buckets=(1, 16, 64, 256, 1024)):
        self.compiled = compiled
        self.config = compiled.config
        self.mesh = mesh
        d = mesh.shape["model"]
        self._data_d = mesh.shape.get("data", 1)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self._load_params(compiled)
        self._data_sh = NamedSharding(mesh, P("data"))
        self._fn_cls = None        # lazy: device-argmax classify program
        self._fn_words = None      # lazy: packed-words program (bipolar)
        self._fn_words_cls = None
        if arm is None:
            arm = "blocking" if blocking else "ring"
        if arm not in ("ring", "blocking", "auto"):
            raise ValueError(f"arm must be ring|blocking|auto, got {arm!r}")
        if arm == "auto":
            self._fn, self.arm, self.arm_reason = self._pick_arm(
                calib_batch, calib_iters)
        else:
            self._fn = make_overlap_tp_forward(self.config, mesh,
                                               blocking=(arm == "blocking"))
            self.arm = arm
            self.arm_reason = "forced by caller"

    def _load_params(self, compiled: CompiledNetwork):
        """Decode + shard-place the compiled parameters (constructor and
        `load_parameters` hot-swap share this; the jitted programs take
        weights as arguments, so a swap recompiles nothing)."""
        mesh, d = self.mesh, self.mesh.shape["model"]
        plan = make_plan(self.config)
        raw = [{k: jnp.asarray(v) for k, v in layer.items()}
               for layer in compiled.layers]
        decoded = decode_params(self.config, raw)
        self.weights = []
        self.thrs = []
        prev_hw_c = None       # (h*w, c) at the conv→dense flatten
        h, w = (self.config.input_shape[0], self.config.input_shape[1]) \
            if self.config.input_kind == "int8" else (1, 1)
        first_dense_after_conv = self.config.input_kind == "int8"
        for lp, p in zip(plan, decoded):
            if lp.kind == "pool":
                h //= lp.window
                w //= lp.window
                continue
            if lp.kind in ("conv", "conv_int8"):
                c_in = lp.k // (lp.kernel * lp.kernel)
                w_hwio = p["w_hwio"] if "w_hwio" in p else \
                    p["w_int8"].reshape(lp.kernel, lp.kernel, c_in, lp.n)
                self.weights.append(jax.device_put(
                    w_hwio,
                    NamedSharding(mesh, P(None, None, None, "model"))))
                h = (h - lp.kernel) // lp.stride + 1
                w = (w - lp.kernel) // lp.stride + 1
                prev_hw_c = (h * w, lp.n)
            else:
                wm = np.asarray(p["w_int8"])
                if first_dense_after_conv and prev_hw_c is not None:
                    wm = reorder_dense_rows_for_csharding(
                        wm, prev_hw_c[0], prev_hw_c[1], d)
                    first_dense_after_conv = False
                spec = P("model", None) if lp.last else P(None, "model")
                self.weights.append(jax.device_put(
                    jnp.asarray(wm), NamedSharding(mesh, spec)))
            if not lp.last:
                self.thrs.append(jax.device_put(
                    p["thr"], NamedSharding(mesh, P(None, "model"))))
        self.out_scale = jax.device_put(
            jnp.asarray(compiled.out_scale), NamedSharding(mesh, P()))
        self.out_bias = jax.device_put(
            jnp.asarray(compiled.out_bias), NamedSharding(mesh, P()))
        self.compiled = compiled

    def load_parameters(self, compiled: CompiledNetwork):
        """Hot-swap parameters on a live multi-chip engine without
        recompiling or dropping traffic — the reference's
        `load_parameters`/doInit-while-live contract (SURVEY.md §3.2)
        extended to the tensor-sharded engine. Topology must match."""
        if compiled.config.layers != self.config.layers or \
                compiled.config.wbits != self.config.wbits or \
                compiled.config.abits != self.config.abits:
            raise ValueError("parameter topology mismatch; build a new "
                             "engine for a different network")
        self._load_params(compiled)
        return self

    def _pick_arm(self, calib_batch, iters):
        """Compile both arms and time them on this (network, mesh) with a
        small calibration batch; keep the faster. Also asserts the two
        arms agree on the calibration inputs (a free exactness witness)."""
        import time
        d = self._data_d
        batch = calib_batch or max(32, 8 * d)
        rng = np.random.default_rng(0)
        if self.config.input_kind == "bipolar":
            x = rng.choice([-1, 1], size=(
                batch, int(np.prod(self.config.input_shape)))).astype(np.int8)
        else:
            x = rng.integers(-128, 128, size=(
                batch,) + self.config.input_shape).astype(np.int8)
        xd = jax.device_put(jnp.asarray(x), self._data_sh)
        w, t = tuple(self.weights), tuple(self.thrs)
        times, fns, outs = {}, {}, {}
        for name, blocking in (("ring", False), ("blocking", True)):
            fn = make_overlap_tp_forward(self.config, self.mesh,
                                         blocking=blocking)
            outs[name] = np.asarray(
                fn(w, t, self.out_scale, self.out_bias, xd))  # compile+warm
            t0 = time.perf_counter()
            res = [fn(w, t, self.out_scale, self.out_bias, xd)
                   for _ in range(iters)]
            jax.block_until_ready(res[-1])
            times[name] = (time.perf_counter() - t0) / iters
            fns[name] = fn
        np.testing.assert_allclose(outs["ring"], outs["blocking"],
                                   rtol=1e-5, atol=1e-5)
        best = min(times, key=times.get)
        reason = (f"measured ring {times['ring'] * 1e3:.2f} ms vs blocking "
                  f"{times['blocking'] * 1e3:.2f} ms at batch {batch} on "
                  f"mesh {dict(self.mesh.shape)}")
        return fns[best], best, reason

    def __repr__(self):
        return (f"OverlapTPEngine({self.config.name!r}, "
                f"mesh={dict(self.mesh.shape)}, arm={self.arm!r}; "
                f"{self.arm_reason})")

    def prepare(self, x):
        from bnn_pynq_tpu.runtime.engine import prepare_host
        return prepare_host(self.config, x)

    def logits(self, x, *, prepared: bool = True):
        if not prepared:
            x = self.prepare(x)
        x = np.asarray(x)
        b = x.shape[0]
        pad = (-b) % self._data_d
        if pad:
            x = np.concatenate(
                [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        xd = jax.device_put(jnp.asarray(x), self._data_sh)
        out = np.asarray(self._fn(tuple(self.weights), tuple(self.thrs),
                                  self.out_scale, self.out_bias, xd))
        return out[:b]

    def classify(self, x, *, prepared: bool = True):
        return self.logits(x, prepared=prepared).argmax(-1)

    # -- serving API (first-class BatchingServer citizenship) -------------
    # Same contract as runtime.InferenceEngine: bucketed async launch with
    # optional on-device argmax (logits_device), packed uint32 word
    # transport for bipolar nets (words_device), and bucket warmup — so a
    # multi-chip engine gets pipelined dispatch, packed transport, and
    # zero-downtime weight swaps exactly like the single-chip engine.

    def _bucket(self, b: int) -> int:
        dd = self._data_d
        for s in self.batch_buckets:
            s = -(-s // dd) * dd          # bucket must shard over 'data'
            if b <= s:
                return s
        top = -(-self.batch_buckets[-1] // dd) * dd
        return -(-b // top) * top

    def _pad_to_bucket(self, x: np.ndarray):
        b = x.shape[0]
        bucket = self._bucket(b)
        if bucket != b:
            x = np.concatenate(
                [x, np.zeros((bucket - b,) + x.shape[1:], x.dtype)])
        return x, b

    def _classify_fn(self):
        if self._fn_cls is None:
            base = self._fn

            @jax.jit
            def _fc(w, t, s, bias, x):
                return jnp.argmax(base(w, t, s, bias, x),
                                  axis=-1).astype(jnp.int32)
            self._fn_cls = _fc
        return self._fn_cls

    def _words_fn(self):
        if self._fn_words is None:
            from bnn_pynq_tpu.ops import packing
            n_in = int(np.prod(self.config.input_shape))
            base = self._fn

            @jax.jit
            def _fw(w, t, s, bias, words):
                vals = packing.unpack_bits(words, n_in, axis=-1)
                return base(w, t, s, bias, vals)
            self._fn_words = _fw
        return self._fn_words

    def _words_classify_fn(self):
        if self._fn_words_cls is None:
            base = self._words_fn()

            @jax.jit
            def _fwc(w, t, s, bias, words):
                return jnp.argmax(base(w, t, s, bias, words),
                                  axis=-1).astype(jnp.int32)
            self._fn_words_cls = _fwc
        return self._fn_words_cls

    def upload(self, x_padded):
        """Async sharded host→device transfer of a padded batch (the
        serving uploader-stage hook; see InferenceEngine.upload)."""
        return jax.device_put(jnp.asarray(x_padded), self._data_sh)

    def launch_prepared(self, xd, *, argmax: bool = False,
                        words: bool = False):
        """Launch on a device-resident sharded batch without fetching."""
        if words:
            fn = self._words_classify_fn() if argmax else self._words_fn()
        else:
            fn = self._classify_fn() if argmax else self._fn
        return fn(tuple(self.weights), tuple(self.thrs),
                  self.out_scale, self.out_bias, xd)

    def logits_device(self, x, *, prepared: bool = True,
                      argmax: bool = False):
        """Async sharded launch: pads to a data-divisible bucket,
        device_puts the batch sharded over 'data', and returns
        (device_out, b) WITHOUT the device→host fetch — the pipelined
        dispatch hook BatchingServer uses to overlap batch t+1's launch
        with batch t's fetch."""
        if not prepared:
            x = self.prepare(x)
        x, b = self._pad_to_bucket(np.asarray(x))
        xd = jax.device_put(jnp.asarray(x), self._data_sh)
        fn = self._classify_fn() if argmax else self._fn
        return fn(tuple(self.weights), tuple(self.thrs),
                  self.out_scale, self.out_bias, xd), b

    def words_device(self, words, *, argmax: bool = False):
        """Packed-transport twin of logits_device for bipolar nets: the
        host ships uint32 sign-bit words (32× less host-link traffic)
        and the device unpacks into the first layer."""
        if self.config.input_kind != "bipolar":
            raise ValueError("packed word input is for bipolar-input "
                             "networks")
        words, b = self._pad_to_bucket(np.asarray(words))
        wd = jax.device_put(jnp.asarray(words), self._data_sh)
        fn = self._words_classify_fn() if argmax else self._words_fn()
        return fn(tuple(self.weights), tuple(self.thrs),
                  self.out_scale, self.out_bias, wd), b

    def warmup(self, batch: int = 1, *, serving: bool = True):
        """Compile the bucket's programs before live traffic (mirror of
        InferenceEngine.warmup)."""
        shape = ((batch, int(np.prod(self.config.input_shape)))
                 if self.config.input_kind == "bipolar"
                 else (batch,) + self.config.input_shape)
        dummy = np.zeros(shape, np.int8)
        outs = [self.logits(dummy, prepared=True)]
        if serving:
            out, _ = self.logits_device(dummy, prepared=True, argmax=True)
            outs.append(out)
            if self.config.input_kind == "bipolar":
                words = np.zeros(
                    (batch, -(-int(np.prod(self.config.input_shape)) // 32)),
                    np.uint32)
                for am in (True, False):
                    out, _ = self.words_device(words, argmax=am)
                    outs.append(out)
            jax.block_until_ready(outs[1:])
        return self
