"""Bit packing / unpacking for binarized and 2-bit quantized tensors.

Equivalent of the reference's weight/activation packing (SURVEY.md C5
`BinaryWeights`/`FixedPointWeights` «finn-hlslib/weights.hpp» and C10
`binarizeAndPack` «bnn/src/library/host/foldedmv-offload.cpp»). Instead of
the FPGA's [PE][WMEM] BRAM word layout, values are packed 32-per-uint32
along the contraction (K) axis: the artifact storage format and the
host→device input transport for bipolar networks.

Conventions (see package docstring):
- 1-bit: value v ∈ {-1,+1}, bit b = (v > 0); word bit j holds element 32w+j.
- 2-bit: code c ∈ {0..3} (integer level 2c-3); 16 codes per word,
  code j at bits [2j, 2j+2).
- Padding: K is padded up to a multiple of the word capacity with zero bits
  (i.e. value -1 for 1-bit, code 0 for 2-bit). Consumers must correct for
  pad contributions (a packed dot subtracts the static pad count).

All functions are pure jnp and jit-safe; numpy arrays work too (jnp
accepts them), and a `np_` variant is provided for host-side packing used
by the offline parameter compiler.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

WORD_BITS = 32


def packed_len(n: int, bits: int = 1) -> int:
    """Number of uint32 words needed to hold `n` values of width `bits`."""
    per_word = WORD_BITS // bits
    return -(-n // per_word)


def pad_amount(n: int, bits: int = 1) -> int:
    """How many pad elements are appended when packing `n` values."""
    per_word = WORD_BITS // bits
    return packed_len(n, bits) * per_word - n


def _move_to_last(x, axis):
    axis = axis % x.ndim
    return jnp.moveaxis(x, axis, -1), axis


def pack_bits(x, axis: int = -1):
    """Pack ±1 (or {0,1} bit) values into uint32 words along `axis`.

    `x`: integer or float array; the packed bit is ``x > 0``.
    Returns uint32 array with `axis` shrunk to ``packed_len(n, 1)``.
    """
    x = jnp.asarray(x)
    moved, axis = _move_to_last(x, axis)
    n = moved.shape[-1]
    pad = pad_amount(n, 1)
    bits = (moved > 0).astype(jnp.uint32)
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    words = bits.reshape(bits.shape[:-1] + (-1, WORD_BITS))
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    packed = jnp.sum(words << shifts, axis=-1, dtype=jnp.uint32)
    return jnp.moveaxis(packed, -1, axis)


def unpack_bits(packed, n: int, axis: int = -1):
    """Inverse of `pack_bits`: uint32 words → int8 values in {-1,+1}.

    `n` is the true (unpadded) element count along `axis`.
    """
    packed = jnp.asarray(packed, dtype=jnp.uint32)
    moved, axis = _move_to_last(packed, axis)
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    bits = (moved[..., None] >> shifts) & jnp.uint32(1)
    flat = bits.reshape(bits.shape[:-2] + (-1,))[..., :n]
    vals = (2 * flat.astype(jnp.int8) - 1).astype(jnp.int8)
    return jnp.moveaxis(vals, -1, axis)


def pack_codes2(codes, axis: int = -1):
    """Pack 2-bit codes {0..3} into uint32 words (16 per word) along `axis`."""
    codes = jnp.asarray(codes)
    moved, axis = _move_to_last(codes, axis)
    n = moved.shape[-1]
    per_word = WORD_BITS // 2
    pad = pad_amount(n, 2)
    c = moved.astype(jnp.uint32) & jnp.uint32(3)
    if pad:
        c = jnp.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, pad)])
    words = c.reshape(c.shape[:-1] + (-1, per_word))
    shifts = (2 * jnp.arange(per_word, dtype=jnp.uint32)).astype(jnp.uint32)
    packed = jnp.sum(words << shifts, axis=-1, dtype=jnp.uint32)
    return jnp.moveaxis(packed, -1, axis)


def unpack_codes2(packed, n: int, axis: int = -1):
    """Inverse of `pack_codes2`: → int8 codes in {0..3}."""
    packed = jnp.asarray(packed, dtype=jnp.uint32)
    moved, axis = _move_to_last(packed, axis)
    per_word = WORD_BITS // 2
    shifts = (2 * jnp.arange(per_word, dtype=jnp.uint32)).astype(jnp.uint32)
    codes = (moved[..., None] >> shifts) & jnp.uint32(3)
    flat = codes.reshape(codes.shape[:-2] + (-1,))[..., :n]
    return jnp.moveaxis(flat.astype(jnp.int8), -1, axis)


def codes2_to_levels(codes):
    """2-bit codes {0..3} → odd integer levels {-3,-1,+1,+3} (int8)."""
    return (2 * jnp.asarray(codes, dtype=jnp.int8) - 3).astype(jnp.int8)


def levels_to_codes2(levels):
    """Odd integer levels {-3,-1,+1,+3} → codes {0..3} (int8)."""
    return ((jnp.asarray(levels, dtype=jnp.int8) + 3) // 2).astype(jnp.int8)


# ---------------------------------------------------------------------------
# Host-side numpy packers (used by the offline parameter compiler; these are
# the analogue of finnthesizer's hex-file writers, SURVEY.md C14).
# ---------------------------------------------------------------------------

def np_pack_bits(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = np.asarray(x)
    moved = np.moveaxis(x, axis % x.ndim, -1)
    n = moved.shape[-1]
    pad = pad_amount(n, 1)
    bits = (moved > 0).astype(np.uint32)
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    words = bits.reshape(bits.shape[:-1] + (-1, WORD_BITS))
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    packed = (words << shifts).sum(axis=-1).astype(np.uint32)
    return np.moveaxis(packed, -1, axis % x.ndim)


def np_pack_codes2(codes: np.ndarray, axis: int = -1) -> np.ndarray:
    codes = np.asarray(codes)
    moved = np.moveaxis(codes, axis % codes.ndim, -1)
    n = moved.shape[-1]
    per_word = WORD_BITS // 2
    pad = pad_amount(n, 2)
    c = (moved.astype(np.uint32)) & np.uint32(3)
    if pad:
        c = np.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, pad)])
    words = c.reshape(c.shape[:-1] + (-1, per_word))
    shifts = (2 * np.arange(per_word, dtype=np.uint32)).astype(np.uint32)
    packed = (words << shifts).sum(axis=-1).astype(np.uint32)
    return np.moveaxis(packed, -1, axis % codes.ndim)
