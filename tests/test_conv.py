"""Conv path vs golden reference (SURVEY.md C2/C3/C6 equivalents)."""

import numpy as np
import jax.numpy as jnp
import pytest

from bnn_pynq_tpu.models.network import _conv_bf16_exact
from bnn_pynq_tpu.ops import packing, ref
from bnn_pynq_tpu.ops.conv import (conv_weight_matrix, maxpool2d,
                                   maxpool2d_packed_or, sliding_window)
from bnn_pynq_tpu.ops.thresholds import multithreshold


def test_sliding_window_matches_conv(rng):
    # sliding_window ∘ matmul == conv_general_dilated for any int weights.
    x = rng.integers(-5, 5, size=(2, 8, 8, 3)).astype(np.int8)
    w = rng.integers(-2, 2, size=(3, 3, 3, 7)).astype(np.int8)
    golden = np.asarray(ref.conv2d_int_ref(x, w))
    patches = sliding_window(jnp.asarray(x), 3, 3, 1)
    b, oh, ow, k = patches.shape
    wmat = conv_weight_matrix(w)
    acc = np.asarray(ref.int_matmul_ref(
        np.asarray(patches).reshape(b * oh * ow, k), np.asarray(wmat)))
    np.testing.assert_array_equal(acc.reshape(b, oh, ow, 7), golden)


def test_sliding_window_stride2(rng):
    x = rng.integers(-5, 5, size=(1, 9, 9, 2)).astype(np.int8)
    w = rng.integers(-2, 2, size=(3, 3, 2, 4)).astype(np.int8)
    golden = np.asarray(ref.conv2d_int_ref(x, w, stride=2))
    patches = sliding_window(jnp.asarray(x), 3, 3, 2)
    b, oh, ow, k = patches.shape
    acc = np.asarray(ref.int_matmul_ref(
        np.asarray(patches).reshape(-1, k), np.asarray(conv_weight_matrix(w))))
    np.testing.assert_array_equal(acc.reshape(b, oh, ow, 4), golden)


@pytest.mark.parametrize("levels,wlevels,shape,stride", [
    # CNV conv1: raw int8 images × ±1 or 2-bit weights, K=27
    ((-128, 127), (-1, 1), (2, 12, 12, 3, 64), 1),
    ((-128, 127), (-3, -1, 1, 3), (2, 12, 12, 3, 64), 1),
    # later convs: 2-bit activations × 2-bit weights at CNV's widest K
    ((-3, -1, 1, 3), (-3, -1, 1, 3), (1, 5, 5, 256, 32), 1),
    ((-1, 1), (-1, 1), (1, 9, 9, 64, 16), 2),
])
def test_conv_bf16_exact(rng, levels, wlevels, shape, stride):
    """The xlaconv route's bf16 convolution with float32 accumulation is
    integer-exact at the extremes of every layer's value range."""
    b, h, w_, cin, cout = shape
    if len(levels) == 2:
        x = rng.integers(levels[0], levels[1] + 1,
                         size=(b, h, w_, cin)).astype(np.int8)
        x.flat[:3] = [levels[0], levels[1], levels[0]]
    else:
        x = rng.choice(levels, size=(b, h, w_, cin)).astype(np.int8)
    wv = rng.choice(wlevels, size=(3, 3, cin, cout)).astype(np.int8)
    golden = np.asarray(ref.conv2d_int_ref(x, wv, stride=stride))
    got = np.asarray(_conv_bf16_exact(jnp.asarray(x), jnp.asarray(wv),
                                      stride))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, golden)


def test_maxpool_codes_equals_or_on_packed(rng):
    codes = rng.integers(0, 2, size=(2, 8, 8, 64)).astype(np.int8)
    pooled = np.asarray(maxpool2d(jnp.asarray(codes), 2))
    packed = packing.pack_bits((2 * codes - 1), axis=-1)
    or_pooled = np.asarray(maxpool2d_packed_or(packed, 2))
    repacked = np.asarray(packing.pack_bits((2 * pooled - 1), axis=-1))
    np.testing.assert_array_equal(or_pooled, repacked)


def test_maxpool_monotone_commutes(rng):
    # pooling codes == pooling accumulators then thresholding (monotone).
    acc = rng.integers(-100, 100, size=(1, 4, 4, 8)).astype(np.int32)
    thr = np.sort(rng.integers(-50, 50, size=(3, 8)), axis=0).astype(np.int32)
    a = np.asarray(multithreshold(
        np.asarray(ref.maxpool2d_codes_ref(acc.astype(np.int32))), thr))
    b = np.asarray(maxpool2d(multithreshold(acc, thr), 2))
    np.testing.assert_array_equal(a, b)
