"""Golden reference implementations (the bit-exact "software twin").

Plays the role of the reference's rawhls CPU runtime (SURVEY.md §4.1
«bnn/src/library/host/rawhls-offload.cpp», built by make-sw.sh): a simple,
obviously-correct implementation of every compute op, used to validate the
production path (models/network.forward_xla) bit-exactly and to run
engines with runtime='ref'.

All arithmetic is integer-exact: int8 operands with int32 accumulation via
``preferred_element_type`` (exact on any backend).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def int_matmul_ref(a, w):
    """Exact integer matmul: a [M,K] int8/int32 · w [K,N] int8 → int32 [M,N]."""
    return jax.lax.dot_general(
        jnp.asarray(a, dtype=jnp.int8),
        jnp.asarray(w, dtype=jnp.int8),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def conv2d_int_ref(x_vals, w_vals, stride: int = 1):
    """Exact integer VALID conv: x [B,H,W,C] int8 · w [kh,kw,C,O] int8 → int32.

    Golden model of SWU+MVTU conv (SURVEY.md C2+C3): XLA's conv on int8
    operands with int32 accumulation is exact.
    """
    x = jnp.asarray(x_vals, dtype=jnp.int8)
    w = jnp.asarray(w_vals, dtype=jnp.int8)
    return jax.lax.conv_general_dilated(
        x, w,
        window_strides=(stride, stride),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    )


def maxpool2d_codes_ref(codes, window: int = 2):
    """Max-pool on activation codes (monotone quantization ⇒ equals
    pooling before quantization). Binary case: max == OR (SURVEY.md C6)."""
    codes = jnp.asarray(codes)
    return jax.lax.reduce_window(
        codes,
        init_value=jnp.asarray(jnp.iinfo(codes.dtype).min, dtype=codes.dtype),
        computation=jax.lax.max,
        window_dimensions=(1, window, window, 1),
        window_strides=(1, window, window, 1),
        padding="VALID",
    )
