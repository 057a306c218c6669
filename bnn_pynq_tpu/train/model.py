"""Flax training model — float graph that mirrors the integer inference
plan layer-for-layer (SURVEY.md C13: the Theano/Lasagne `binary_net` +
`cnv.py`/`lfc.py`/`sfc.py` builders, rebuilt in flax).

Structure per compute layer: Conv/Dense (quantized weights, no bias)
→ BatchNorm → activation quantizer; pools operate on quantized codes
(monotone ⇒ identical to pooling pre-activations). The final compute layer
is Conv/Dense → BatchNorm with no activation quantizer; its float output
feeds the loss (squared hinge, as in the reference).

The parameter compiler (compiler/finnthesizer.py) consumes this module's
params/batch_stats and must track its exact layer naming:
`quant_{i}` for conv/dense kernels, `bn_{i}` for the following BatchNorm,
indexed by position in config.layers.
"""

from __future__ import annotations

from typing import Any

import flax.linen as nn
import jax.numpy as jnp

from bnn_pynq_tpu.models.config import (BN_EPS, ConvSpec, NetworkConfig,
                                        PoolSpec)
from bnn_pynq_tpu.train.quant import quantize_activations, quantize_weights

# Lasagne BatchNormLayer defaults (reference training stack): eps=1e-4
# (models/config.BN_EPS), alpha=0.1 ⇒ flax momentum=0.9.
BN_MOMENTUM = 0.9


class QuantDense(nn.Module):
    features: int
    wbits: int

    @nn.compact
    def __call__(self, x):
        w = self.param("kernel", nn.initializers.glorot_uniform(),
                       (x.shape[-1], self.features), jnp.float32)
        wq = quantize_weights(w, self.wbits)
        return jnp.dot(x, wq)


class QuantConv(nn.Module):
    features: int
    kernel: int
    stride: int
    wbits: int

    @nn.compact
    def __call__(self, x):
        w = self.param("kernel", nn.initializers.glorot_uniform(),
                       (self.kernel, self.kernel, x.shape[-1], self.features),
                       jnp.float32)
        wq = quantize_weights(w, self.wbits)
        from jax import lax
        return lax.conv_general_dilated(
            x, wq, window_strides=(self.stride, self.stride),
            padding="VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))


class QuantNet(nn.Module):
    """Float-forward quantized network for a NetworkConfig.

    `stochastic=True` + train=True uses stochastic activation
    binarization (the reference's stochastic mode; needs an rng named
    'quant' in apply(..., rngs={'quant': key})). Evaluation and the
    parameter compiler always use the deterministic quantizer."""
    config: Any  # NetworkConfig (kept Any for flax dataclass hashing)
    stochastic: bool = False

    @nn.compact
    def __call__(self, x, train: bool = False):
        cfg: NetworkConfig = self.config
        specs = cfg.layers
        last_compute = max(i for i, s in enumerate(specs)
                           if not isinstance(s, PoolSpec))
        if cfg.input_kind == "bipolar":
            x = x.reshape(x.shape[0], -1)
        for i, spec in enumerate(specs):
            if isinstance(spec, PoolSpec):
                x = nn.max_pool(x, (spec.window, spec.window),
                                strides=(spec.window, spec.window))
                continue
            if isinstance(spec, ConvSpec):
                x = QuantConv(spec.out_ch, spec.kernel, spec.stride,
                              cfg.wbits, name=f"quant_{i}")(x)
            else:
                if x.ndim > 2:
                    x = x.reshape(x.shape[0], -1)
                x = QuantDense(spec.out_features, cfg.wbits,
                               name=f"quant_{i}")(x)
            x = nn.BatchNorm(use_running_average=not train,
                             momentum=BN_MOMENTUM, epsilon=BN_EPS,
                             name=f"bn_{i}")(x)
            if i != last_compute:
                if self.stochastic and train and cfg.abits == 1:
                    from bnn_pynq_tpu.train.quant import binarize_stochastic
                    x = binarize_stochastic(x, self.make_rng("quant"))
                else:
                    x = quantize_activations(x, cfg.abits)
        return x
