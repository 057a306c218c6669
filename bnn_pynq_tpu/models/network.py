"""Inference graph builder: config + integer params → jittable forward.

The analogue of the reference's per-network dataflow pipeline (SURVEY.md
C9 `DoCompute`/`BlackBoxJam` «bnn/src/network/<net>/hw/top.cpp»): one
jitted XLA program per network. Where the FPGA streams layer-to-layer over
FIFOs, XLA fuses the threshold epilogues and the inter-layer reshapes
around int8 GEMMs and convolutions.

Two implementations of one graph (the HW/SW runtime duality of SURVEY.md
§4.1):
- `forward_xla`: the production path. Packed weights are decoded once to
  int8 levels (`decode_params`); convs run as space-to-depth phase dots
  (conv_mode='s2d'), im2col dots ('patches') or native convolutions
  ('native'), each with int32 accumulation and integer MultiThreshold
  epilogues.
- `forward`: the dense golden reference (im2col + int8 dot per layer,
  weights unpacked inside the program) — the bit-exact software twin.

First-layer handling mirrors the reference: CNV's first conv consumes
8-bit images (not binary), so it runs as an exact int8 dot with decoded
weights; MLPs consume bipolar (±1) inputs (SURVEY.md C10 `binarizeAndPack`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bnn_pynq_tpu.models.config import (ConvSpec, DenseSpec, NetworkConfig,
                                        PoolSpec)
from bnn_pynq_tpu.ops import packing, ref
from bnn_pynq_tpu.ops.conv import maxpool2d, sliding_window
from bnn_pynq_tpu.ops.thresholds import codes_to_values, multithreshold


@dataclass(frozen=True)
class LayerPlan:
    kind: str                     # 'dense' | 'conv' | 'conv_int8' | 'pool'
    k: int = 0                    # contraction length (dense/conv)
    n: int = 0                    # output features/channels
    kernel: int = 0
    stride: int = 1
    window: int = 0
    last: bool = False            # last compute layer → int32 logits


def make_plan(config: NetworkConfig) -> Tuple[LayerPlan, ...]:
    """Derive the static per-layer execution plan from a config."""
    h, w, c = config.input_shape
    plans = []
    specs = config.layers
    last_compute = max(i for i, s in enumerate(specs)
                      if not isinstance(s, PoolSpec))
    flat = False
    for i, spec in enumerate(specs):
        if isinstance(spec, ConvSpec):
            kind = "conv_int8" if (i == 0 and config.input_kind == "int8") \
                else "conv"
            k = spec.kernel * spec.kernel * c
            plans.append(LayerPlan(kind=kind, k=k, n=spec.out_ch,
                                   kernel=spec.kernel, stride=spec.stride,
                                   last=(i == last_compute)))
            h = (h - spec.kernel) // spec.stride + 1
            w = (w - spec.kernel) // spec.stride + 1
            c = spec.out_ch
        elif isinstance(spec, PoolSpec):
            plans.append(LayerPlan(kind="pool", window=spec.window))
            h //= spec.window
            w //= spec.window
        elif isinstance(spec, DenseSpec):
            if not flat:
                k = h * w * c
                flat = True
            else:
                k = c
            plans.append(LayerPlan(kind="dense", k=k, n=spec.out_features,
                                   last=(i == last_compute)))
            c = spec.out_features
            h = w = 1
        else:
            raise TypeError(f"unknown layer spec {spec!r}")
    return tuple(plans)


def _input_codes(config: NetworkConfig, x):
    """Bipolar input → activation codes in the network's packing scheme."""
    pos = jnp.asarray(x) > 0
    if config.bits == 1:
        return pos.astype(jnp.int8)                        # codes {0,1}
    return jnp.where(pos, jnp.int8(2), jnp.int8(1))        # levels ±1


def init_random_params(config: NetworkConfig, seed: int = 0):
    """Random packed parameters with plausible thresholds — used by tests
    and benchmarks before trained artifacts exist."""
    rng = np.random.default_rng(seed)
    plan = make_plan(config)
    bits = config.bits
    nthr = config.nthr
    params = []
    for lp in plan:
        if lp.kind == "pool":
            params.append({})
            continue
        if lp.kind == "conv_int8":
            wmat = rng.choice([-1, 1], size=(lp.k, lp.n)).astype(np.int8)
            if config.wbits == 2:
                wmat = rng.choice([-3, -1, 1, 3], size=(lp.k, lp.n)).astype(np.int8)
            entry = {"w_int8": jnp.asarray(wmat)}
            scale = lp.k * 128
        else:
            if bits == 1:
                wvals = rng.choice([-1, 1], size=(lp.k, lp.n)).astype(np.int8)
                packed = packing.np_pack_bits(wvals, axis=0)
            else:
                if config.wbits == 1:
                    wcodes = rng.choice([1, 2], size=(lp.k, lp.n)).astype(np.int8)
                else:
                    wcodes = rng.integers(0, 4, size=(lp.k, lp.n)).astype(np.int8)
                packed = packing.np_pack_codes2(wcodes, axis=0)
            entry = {"w_packed": jnp.asarray(packed)}
            scale = lp.k * (1 if bits == 1 else 9)
        if not lp.last:
            thr = np.sort(
                rng.integers(-scale // 4, scale // 4, size=(nthr, lp.n)),
                axis=0).astype(np.int32)
            entry["thr"] = jnp.asarray(thr)
        params.append(entry)
    return params


def forward(config: NetworkConfig, params, x):
    """Golden reference forward. Returns int32 logits [B, num_classes].

    params: the packed artifact layers (uint32 `w_packed`, or `w_int8`
    for CNV's first conv). x: bipolar nets — any array reshapeable to
    [B, 784] (values ±1 or floats, binarized at >0); int8 nets — int8
    [B, H, W, C].
    """
    plan = make_plan(config)
    bits = config.bits
    if config.input_kind == "bipolar":
        x = jnp.asarray(x)
        act = _input_codes(config, x.reshape(x.shape[0], -1))
    else:
        act = jnp.asarray(x, dtype=jnp.int8)

    for lp, p in zip(plan, params):
        thr = None if lp.last else p.get("thr")
        if lp.kind == "pool":
            act = maxpool2d(act, lp.window)
            continue
        if lp.kind == "dense":
            if act.ndim > 2:
                act = act.reshape(act.shape[0], -1)
            acc = ref.int_matmul_ref(codes_to_values(act, config.abits),
                                     _unpack_weights(p["w_packed"], lp.k,
                                                     bits))
        else:
            if lp.kind == "conv_int8":
                vals, w = act, p["w_int8"]   # raw int8 image input
            else:
                vals = codes_to_values(act, config.abits)
                w = _unpack_weights(p["w_packed"], lp.k, bits)
            patches = sliding_window(vals, lp.kernel, lp.kernel, lp.stride)
            b, oh, ow, k = patches.shape
            acc = ref.int_matmul_ref(patches.reshape(b * oh * ow, k), w)
            acc = acc.reshape(b, oh, ow, lp.n)
        act = acc if lp.last else multithreshold(acc, thr)
    return act


def _unpack_weights(w_packed, k: int, bits: int):
    if bits == 1:
        return packing.unpack_bits(w_packed, k, axis=0)
    return packing.codes2_to_levels(packing.unpack_codes2(w_packed, k, axis=0))


def decode_params(config: NetworkConfig, params):
    """Pre-decode packed weights to integer int8 levels once (device-
    resident) for `forward_xla`: weights stay integers, no float dequant
    ever; this trades 8× weight bytes (≤2.9 MB for LFC) for int8 GEMMs
    that need no decode inside the program."""
    plan = make_plan(config)
    out = []
    for lp, p in zip(plan, params):
        if lp.kind == "pool" or "w_int8" in p:
            out.append(dict(p))
            continue
        q = dict(p)
        w_lev = _unpack_weights(p["w_packed"], lp.k, config.bits)
        if lp.kind == "conv":
            c = lp.k // (lp.kernel * lp.kernel)
            q["w_hwio"] = jnp.asarray(w_lev).reshape(
                lp.kernel, lp.kernel, c, lp.n)
        else:
            q["w_int8"] = jnp.asarray(w_lev)
        del q["w_packed"]
        out.append(q)
    return out


def _conv_bf16_exact(vals_int8, w_hwio_int8, stride: int):
    """Exact integer conv as a bf16 convolution with float32 accumulation
    (cuDNN on the GPU).

    All operands are small integers (|activations| ≤ 128 first layer /
    ≤ 3 afterwards, |weights| ≤ 3), each exactly representable in
    bfloat16; every product and partial sum is an integer below 2^24
    (at most 128·3·27 in the first layer, 3·3·2304 after), so the float32
    accumulator holds it exactly and rounding the result to int32 is
    bit-exact with the integer reference — provided the convolution
    algorithm sums products directly (chip_smoke.py checks this on the
    card). This avoids im2col's K² patch materialization entirely."""
    acc = jax.lax.conv_general_dilated(
        vals_int8.astype(jnp.bfloat16),
        jnp.asarray(w_hwio_int8).astype(jnp.bfloat16),
        window_strides=(stride, stride),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    return acc.astype(jnp.int32)


# s2d layout choices. Both were picked by measurement on the earlier
# accelerator (README, "Origin") and have not been re-derived on the GPU
# (ROADMAP). Module-level so a measurement can flip them without
# threading arguments through the engine.
S2D_TUNING = {
    "chain": True,           # feed phase output straight into the next
                             # same-s s2d conv instead of de-phasing
    "form": "concat",        # phase-dot form: 'concat' (2×2 patch concat
                             # + one dot) or 'shifted' (4 sliced GEMMs
                             # summed, no patch materialization —
                             # ops/conv_s2d._phase_dot_shifted)
}


def forward_xla(config: NetworkConfig, decoded, x, *,
                conv_mode: str = "patches"):
    """Decoded-integer forward: int8 GEMMs and convolutions with int32
    accumulation and integer MultiThreshold epilogues fused by XLA.
    Returns int32 logits; bit-exact with `forward`.

    conv_mode: 'patches' — conv as sliding-window + int8 dot (im2col).
    'native' — conv via `_conv_bf16_exact`, still integer-exact but
    without materializing K²-duplicated patches.
    's2d' — space-to-depth reformulation per layer where it pays
    (ops/conv_s2d.py): (2s)²C × s²N dot shapes, pool-as-phase-max, and
    the activation stays in phase layout across consecutive s2d layers.
    """
    from bnn_pynq_tpu.ops.conv_s2d import (BlockedAct, conv_s2d_blocked,
                                           dephase, phase_maxpool,
                                           pick_s2d_block)

    plan = make_plan(config)
    if config.input_kind == "bipolar":
        x = jnp.asarray(x)
        act = _input_codes(config, x.reshape(x.shape[0], -1))
    else:
        act = jnp.asarray(x, dtype=jnp.int8)

    skip_pool = False
    for li, (lp, p) in enumerate(zip(plan, decoded)):
        thr = None if lp.last else p.get("thr")
        # choose the s2d block size for eligible convs up front, so a
        # blocked activation can chain without ever de-phasing
        s2d = 0
        if lp.kind in ("conv", "conv_int8") and conv_mode == "s2d" and \
                lp.stride == 1:
            c = lp.k // (lp.kernel * lp.kernel)
            h_in = act.oh if isinstance(act, BlockedAct) else act.shape[1]
            w_in = act.ow if isinstance(act, BlockedAct) else act.shape[2]
            oh, ow = h_in - lp.kernel + 1, w_in - lp.kernel + 1
            s2d = pick_s2d_block(c, lp.n, oh, ow, lp.kernel, lp.stride)
        if isinstance(act, BlockedAct) and not (
                s2d and act.s == s2d and S2D_TUNING["chain"]):
            act = dephase(act)
        if lp.kind == "pool":
            if skip_pool:
                skip_pool = False
            else:
                act = maxpool2d(act, lp.window)
            continue
        if lp.kind == "conv_int8":
            vals = act  # raw int8 image input, not in code domain
        else:
            if isinstance(act, BlockedAct):
                vals = BlockedAct(codes_to_values(act.codes, config.abits),
                                  act.s, act.oh, act.ow)
            else:
                if act.ndim > 2 and lp.kind == "dense":
                    act = act.reshape(act.shape[0], -1)
                vals = codes_to_values(act, config.abits)
        if lp.kind in ("conv", "conv_int8"):
            if s2d:
                c = lp.k // (lp.kernel * lp.kernel)
                w_hwio = p["w_hwio"] if "w_hwio" in p else \
                    p["w_int8"].reshape(lp.kernel, lp.kernel, c, lp.n)
                ba = conv_s2d_blocked(vals, jnp.asarray(w_hwio), thr,
                                      s=s2d, form=S2D_TUNING["form"])
                if s2d == 2 and thr is not None and \
                        li + 1 < len(plan) and \
                        plan[li + 1].kind == "pool" and \
                        plan[li + 1].window == 2 and \
                        ba.oh % 2 == 0 and ba.ow % 2 == 0:
                    act = phase_maxpool(ba)
                    skip_pool = True
                else:
                    act = ba
                continue
            if conv_mode == "native":
                c = lp.k // (lp.kernel * lp.kernel)
                w_hwio = p["w_hwio"] if "w_hwio" in p else \
                    p["w_int8"].reshape(lp.kernel, lp.kernel, c, lp.n)
                acc = _conv_bf16_exact(vals, w_hwio, lp.stride)
            else:
                w = p["w_hwio"].reshape(lp.k, lp.n) if "w_hwio" in p \
                    else p["w_int8"]
                patches = sliding_window(vals, lp.kernel, lp.kernel,
                                         lp.stride)
                b, oh, ow, k = patches.shape
                acc = ref.int_matmul_ref(patches.reshape(b * oh * ow, k), w)
                acc = acc.reshape(b, oh, ow, lp.n)
        else:
            acc = ref.int_matmul_ref(vals, p["w_int8"])
        act = acc if lp.last else multithreshold(acc, thr)
    if isinstance(act, BlockedAct):   # network ending mid-phase (defensive)
        act = dephase(act)
    return act
