"""Convolution helpers: sliding-window (im2col) and maxpool.

Rebuild of the reference's streaming conv stack (SURVEY.md C2
`ConvolutionInputGenerator` «bnn/src/library/hls/slidingwindow.h», C3
`ConvLayer_Batch` «bnn/src/library/hls/convlayer.h», C6
`StreamingMaxPool_Batch` «bnn/src/library/hls/maxpool.h»).

Where the FPGA streams K×K×C patches out of a ring buffer into the MVTU,
this version materializes patches with kh*kw static strided slices (XLA
fuses these into the consumer) and feeds an int8 dot. Patch order along K
is (ki, kj, c): patch element index = (ki*kw + kj)*C + c, matching a plain
reshape of HWIO weights — the parameter compiler relies on this.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sliding_window(x, kh: int, kw: int, stride: int = 1):
    """im2col: x [B, H, W, C] → patches [B, OH, OW, kh*kw*C], order (ki,kj,c).

    VALID padding only (the reference CNV uses only VALID 3×3 convs,
    SURVEY.md C9).
    """
    b, h, w, c = x.shape
    oh = (h - kh) // stride + 1
    ow = (w - kw) // stride + 1
    parts = []
    for ki in range(kh):
        for kj in range(kw):
            part = jax.lax.slice(
                x,
                (0, ki, kj, 0),
                (b, ki + (oh - 1) * stride + 1, kj + (ow - 1) * stride + 1, c),
                (1, stride, stride, 1),
            )
            parts.append(part)
    return jnp.concatenate(parts, axis=-1)


def conv_weight_matrix(w_hwio):
    """HWIO conv weights [kh, kw, C, O] → matmul matrix [kh*kw*C, O] in the
    same (ki, kj, c) order that `sliding_window` emits."""
    kh, kw, c, o = w_hwio.shape
    return jnp.asarray(w_hwio).reshape(kh * kw * c, o)


def maxpool2d(codes, window: int = 2):
    """Max-pool on activation codes. Quantization is monotone, so pooling
    codes equals pooling pre-activations; for 1-bit codes this is exactly
    the reference's binary OR maxpool (SURVEY.md C6)."""
    codes = jnp.asarray(codes)
    return jax.lax.reduce_window(
        codes,
        init_value=jnp.asarray(jnp.iinfo(codes.dtype).min, codes.dtype),
        computation=jax.lax.max,
        window_dimensions=(1, window, window, 1),
        window_strides=(1, window, window, 1),
        padding="VALID",
    )


def maxpool2d_packed_or(packed, window: int = 2):
    """Binary maxpool directly on packed words: bitwise OR over the window.
    packed: uint32 [B, H, W, Cw]."""
    packed = jnp.asarray(packed, dtype=jnp.uint32)
    return jax.lax.reduce_window(
        packed,
        init_value=jnp.uint32(0),
        computation=jax.lax.bitwise_or,
        window_dimensions=(1, window, window, 1),
        window_strides=(1, window, window, 1),
        padding="VALID",
    )
