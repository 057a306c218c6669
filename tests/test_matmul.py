"""The decoded quantized layer (the production MVTU, SURVEY.md C1+C4) vs a
numpy oracle on the packed words.

The production path decodes packed weights once to int8 levels
(`decode_params`), runs an int8 dot with int32 accumulation
(`int_matmul_ref`) and thresholds the result (`multithreshold`). The
oracle never decodes: for 1-bit operands the ±1 dot is
K − 2·popcount(a XOR w) on the packed words themselves (pad bits are zero
in both operands, so they never differ).
"""

import numpy as np
import pytest

from bnn_pynq_tpu.models.config import DenseSpec, NetworkConfig
from bnn_pynq_tpu.models.network import decode_params
from bnn_pynq_tpu.ops import packing, ref
from bnn_pynq_tpu.ops.thresholds import (THR_NEVER, codes_to_values,
                                         multithreshold)


def _decoded_layer(a_codes, w_packed, k, wbits, abits, thr=None):
    """One dense layer through decode_params + int_matmul_ref (+
    multithreshold when thr is given)."""
    n = w_packed.shape[1]
    cfg = NetworkConfig("one-dense", wbits=wbits, abits=abits,
                        input_kind="bipolar", input_shape=(1, 1, k),
                        layers=(DenseSpec(n),), num_classes=n)
    (layer,) = decode_params(cfg, [{"w_packed": w_packed}])
    acc = ref.int_matmul_ref(codes_to_values(a_codes, abits),
                             layer["w_int8"])
    return np.asarray(acc if thr is None else multithreshold(acc, thr))


def _popcount_oracle(a_words, w_words, k):
    """K − 2·popcount(a XOR w) for every (row, column) of packed words."""
    x = a_words[:, :, None] ^ w_words[None, :, :]          # [M, Kw, N]
    bits = np.unpackbits(x[..., None].view(np.uint8), axis=-1)
    return k - 2 * bits.sum(axis=(1, 3), dtype=np.int64)


def _w1a1(rng, m, k, n):
    a = rng.choice([-1, 1], size=(m, k)).astype(np.int8)
    w = rng.choice([-1, 1], size=(k, n)).astype(np.int8)
    return a, w


@pytest.mark.parametrize("m,k,n", [
    (128, 256, 128), (128, 100, 128), (256, 784, 256),   # MLP shapes
    (1, 27, 64), (7, 576, 64), (33, 1152, 256),          # CNV conv K
    (5, 2304, 256), (64, 1024, 10), (3, 31, 3),          # tail, odd K
])
def test_w1a1_acc_exact(rng, m, k, n):
    a, w = _w1a1(rng, m, k, n)
    a_words = packing.np_pack_bits(a, axis=-1)
    w_words = packing.np_pack_bits(w, axis=0)
    want = _popcount_oracle(a_words, w_words, k)
    codes = (a > 0).astype(np.int8)
    got = _decoded_layer(codes, w_words, k, 1, 1)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the oracle itself agrees with the plain ±1 dot
    np.testing.assert_array_equal(want, a.astype(np.int64) @ w)


@pytest.mark.parametrize("k", [64, 200, 1024])
def test_w1a1_threshold_fused(rng, k):
    m, n = 96, 128
    a, w = _w1a1(rng, m, k, n)
    thr = np.sort(rng.integers(-k, k, size=(1, n)), axis=0).astype(np.int32)
    a_words = packing.np_pack_bits(a, axis=-1)
    w_words = packing.np_pack_bits(w, axis=0)
    want = (_popcount_oracle(a_words, w_words, k) >= thr[0]).astype(np.int8)
    got = _decoded_layer((a > 0).astype(np.int8), w_words, k, 1, 1, thr)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def _codes2(rng, m, k, n, w_binary):
    a = rng.integers(0, 4, size=(m, k)).astype(np.int8)
    w = (rng.choice([1, 2], size=(k, n)) if w_binary
         else rng.integers(0, 4, size=(k, n))).astype(np.int8)
    return a, w


@pytest.mark.parametrize("w_binary", [True, False])
def test_2bit_acc_exact(rng, w_binary):
    # W1A2 (binary weights stored as 2-bit codes) and W2A2
    m, k, n = 128, 150, 128
    a, w = _codes2(rng, m, k, n, w_binary)
    want = (2 * a.astype(np.int64) - 3) @ (2 * w.astype(np.int64) - 3)
    got = _decoded_layer(a, packing.np_pack_codes2(w, axis=0), k,
                         1 if w_binary else 2, 2)
    np.testing.assert_array_equal(got, want)


def test_2bit_threshold_fused(rng):
    m, k, n = 128, 90, 128
    a, w = _codes2(rng, m, k, n, w_binary=False)
    acc = (2 * a.astype(np.int64) - 3) @ (2 * w.astype(np.int64) - 3)
    thr = np.sort(rng.integers(-3 * k, 3 * k, size=(3, n)),
                  axis=0).astype(np.int32)
    want = sum((acc >= thr[t]).astype(np.int8) for t in range(3))
    got = _decoded_layer(a, packing.np_pack_codes2(w, axis=0), k, 2, 2, thr)
    np.testing.assert_array_equal(got, want)


def test_arbitrary_m(rng):
    m, k, n = 37, 64, 128
    a, w = _w1a1(rng, m, k, n)
    w_words = packing.np_pack_bits(w, axis=0)
    got = _decoded_layer((a > 0).astype(np.int8), w_words, k, 1, 1)
    assert got.shape == (m, n)
    np.testing.assert_array_equal(
        got, _popcount_oracle(packing.np_pack_bits(a, axis=-1), w_words, k))


def test_padded_n_columns_with_sentinel_thresholds(rng):
    # artifact padding: N=10 classes padded to 128 columns whose
    # THR_NEVER sentinel must never fire
    m, k, n_true, n_pad = 128, 64, 10, 128
    a, w = _w1a1(rng, m, k, n_true)
    w_full = np.ones((k, n_pad), dtype=np.int8)
    w_full[:, :n_true] = w
    thr = np.full((1, n_pad), THR_NEVER, dtype=np.int32)
    thr[0, :n_true] = 0
    got = _decoded_layer((a > 0).astype(np.int8),
                         packing.np_pack_bits(w_full, axis=0), k, 1, 1, thr)
    assert (got[:, n_true:] == 0).all()
    np.testing.assert_array_equal(
        got[:, :n_true], (a.astype(np.int64) @ w >= 0).astype(np.int8))
