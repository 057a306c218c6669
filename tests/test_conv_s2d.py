"""Bit-exactness of the space-to-depth conv route (ops/conv_s2d.py)
against the im2col route — the golden-twin methodology of SURVEY.md §4.1
applied to the round-3 performance reformulation."""

import numpy as np
import pytest

import jax.numpy as jnp

from bnn_pynq_tpu.models import get_config
from bnn_pynq_tpu.models.network import (decode_params, forward_xla,
                                         init_random_params)
from bnn_pynq_tpu.ops.conv import maxpool2d, sliding_window
from bnn_pynq_tpu.ops.conv_s2d import (blocked_weights, conv_s2d,
                                       conv_s2d_blocked, dephase,
                                       phase_maxpool, pick_s2d_block,
                                       reblock)
from bnn_pynq_tpu.ops.thresholds import multithreshold


def _ref_conv(vals, w_hwio, thr):
    k = w_hwio.shape[0]
    p = sliding_window(jnp.asarray(vals), k, k, 1)
    b, oh, ow, kk = p.shape
    acc = p.reshape(b * oh * ow, kk).astype(np.int32) @ \
        jnp.asarray(w_hwio).reshape(kk, -1).astype(jnp.int32)
    acc = acc.reshape(b, oh, ow, -1)
    return acc if thr is None else multithreshold(acc, thr)


@pytest.mark.parametrize("s,h,c,n", [(2, 30, 64, 64), (2, 14, 64, 128),
                                     (4, 32, 3, 64), (2, 12, 128, 128),
                                     (2, 32, 3, 64)])
def test_conv_s2d_exact(s, h, c, n):
    rng = np.random.default_rng(0)
    vals = rng.choice([-1, 1], size=(3, h, h, c)).astype(np.int8)
    w = rng.choice([-1, 1], size=(3, 3, c, n)).astype(np.int8)
    thr = np.sort(rng.integers(-50, 50, size=(1, n)), 0).astype(np.int32)
    got = conv_s2d(jnp.asarray(vals), jnp.asarray(w), jnp.asarray(thr), s=s)
    want = _ref_conv(vals, w, jnp.asarray(thr))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_conv_s2d_acc_no_thr():
    rng = np.random.default_rng(1)
    vals = rng.integers(-3, 4, size=(2, 14, 14, 32)).astype(np.int8)
    w = rng.integers(-3, 4, size=(3, 3, 32, 64)).astype(np.int8)
    got = conv_s2d(jnp.asarray(vals), jnp.asarray(w), None, s=2)
    want = _ref_conv(vals, w, None)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_conv_s2d_fused_pool():
    rng = np.random.default_rng(2)
    vals = rng.choice([-1, 1], size=(3, 30, 30, 64)).astype(np.int8)
    w = rng.choice([-1, 1], size=(3, 3, 64, 64)).astype(np.int8)
    thr = np.sort(rng.integers(-50, 50, size=(3, 64)), 0).astype(np.int32)
    got = conv_s2d(jnp.asarray(vals), jnp.asarray(w), jnp.asarray(thr),
                   s=2, fuse_pool=2)
    want = maxpool2d(_ref_conv(vals, w, jnp.asarray(thr)), 2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_blocked_chain_exact():
    """conv→conv chained in phase layout (no de-phase between) matches
    two reference convs — the zero-relayout path CNV takes."""
    rng = np.random.default_rng(3)
    vals = rng.choice([-1, 1], size=(2, 18, 18, 32)).astype(np.int8)
    w1 = rng.choice([-1, 1], size=(3, 3, 32, 64)).astype(np.int8)
    w2 = rng.choice([-1, 1], size=(3, 3, 64, 64)).astype(np.int8)
    t1 = np.sort(rng.integers(-50, 50, size=(1, 64)), 0).astype(np.int32)
    t2 = np.sort(rng.integers(-50, 50, size=(1, 64)), 0).astype(np.int32)

    ba1 = conv_s2d_blocked(jnp.asarray(vals), jnp.asarray(w1),
                           jnp.asarray(t1), s=2)
    lev1 = (2 * ba1.codes.astype(jnp.int32) - 1).astype(jnp.int8)
    ba2 = conv_s2d_blocked(ba1._replace(codes=lev1), jnp.asarray(w2),
                           jnp.asarray(t2), s=2)
    got = dephase(ba2)

    c1 = _ref_conv(vals, w1, jnp.asarray(t1))
    lev = np.asarray(2 * c1.astype(jnp.int32) - 1).astype(np.int8)
    want = _ref_conv(lev, w2, jnp.asarray(t2))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_phase_maxpool_matches_maxpool2d():
    rng = np.random.default_rng(4)
    vals = rng.choice([-1, 1], size=(2, 18, 18, 32)).astype(np.int8)
    w = rng.choice([-1, 1], size=(3, 3, 32, 64)).astype(np.int8)
    t = np.sort(rng.integers(-50, 50, size=(3, 64)), 0).astype(np.int32)
    ba = conv_s2d_blocked(jnp.asarray(vals), jnp.asarray(w),
                          jnp.asarray(t), s=2)
    got = phase_maxpool(ba)
    want = maxpool2d(_ref_conv(vals, w, jnp.asarray(t)), 2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_phase_weights_cover_kernel():
    # every original weight appears exactly s*s times (once per phase)
    rng = np.random.default_rng(5)
    w = rng.integers(-3, 4, size=(3, 3, 8, 4)).astype(np.int8)
    for s in (2, 4):
        wp = np.asarray(blocked_weights(jnp.asarray(w), s))
        assert wp.shape == (4 * s * s * 8, s * s * 4)
        assert np.abs(wp).sum() == s * s * np.abs(w).sum()


def test_reblock_4to2_exact():
    # reblock(s=4 → s=2) ≡ dephase then to_blocked at s=2
    from bnn_pynq_tpu.ops.conv_s2d import BlockedAct, to_blocked
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 2, size=(2, 8, 8, 16 * 5)).astype(np.int8)
    ba = BlockedAct(jnp.asarray(codes), 4, 30, 30)
    got = reblock(ba, 2)
    assert got.s == 2 and got.codes.shape == (2, 16, 16, 4 * 5)
    sp = dephase(BlockedAct(jnp.asarray(codes), 4, 32, 32))  # full grid
    want = to_blocked(sp, 2, 16, 16)
    np.testing.assert_array_equal(np.asarray(got.codes), np.asarray(want))


def test_pick_s2d_block_policy():
    assert pick_s2d_block(3, 64, 30, 30, 3, 1) == 4      # conv1
    assert pick_s2d_block(64, 64, 28, 28, 3, 1) == 2     # conv2
    assert pick_s2d_block(128, 128, 10, 10, 3, 1) == 2   # conv4
    assert pick_s2d_block(128, 256, 3, 3, 3, 1) == 0     # conv5: im2col
    assert pick_s2d_block(64, 64, 28, 28, 3, 2) == 0     # strided: im2col
    assert pick_s2d_block(3, 64, 30, 30, 5, 1) == 0      # K>3: im2col


@pytest.mark.parametrize("net", ["cnv-w1a1", "cnv-w1a2", "cnv-w2a2"])
def test_forward_s2d_route_matches_patches(net):
    cfg = get_config(net)
    params = init_random_params(cfg, seed=0)
    decoded = decode_params(cfg, params)
    rng = np.random.default_rng(0)
    x = rng.integers(-128, 128, size=(4,) + cfg.input_shape).astype(np.int8)
    want = forward_xla(cfg, decoded, x, conv_mode="patches")
    got = forward_xla(cfg, decoded, x, conv_mode="s2d")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
