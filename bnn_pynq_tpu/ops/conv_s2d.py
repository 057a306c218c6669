"""Space-to-depth conv reformulation of CNV's narrow convs.

CNV's native im2col dot shapes are narrow: conv1 contracts K=27 into
N=64, conv2 K=576 into N=64. The reference hardware had the dual problem
(folding small matrices onto PE×SIMD arrays, SURVEY.md C1/C9); its fix
was per-layer folding configs, this one is per-layer reshaping.

Trick: view the image in s×s blocks. A K×K stride-1 VALID conv becomes
a 2×2-superblock conv producing s² output phases per block — one dot
with contraction (2s)²C and width s²N instead of K²C × N:

    conv1 (s=4):  K 27   → 192,  N 64 → 1024
    conv2 (s=2):  K 576  → 1024, N 64 → 256
    conv3/4 (s=2): K 576/1152 → 1024/2048, N 128 → 512

Three structural wins beyond the dot shape:
- **phase chaining**: a s-layer's phase output [B, nb, nb, s²N] IS the
  next s-layer's blocked input (`blocked_weights` consumes it via a
  plain 2×2 window) — consecutive s2d convs chain with no relayout at
  all, and a s=4 layer can feed a s=2 layer through ONE transpose
  (`reblock`) instead of a dephase + to_blocked pair;
- a following 2×2 maxpool collapses to a max over the s=2 phase dims
  (pool windows coincide exactly with blocks): the reference's binary
  OR-maxpool (SURVEY.md C6) becomes a 4-way max and re-spatializes the
  activation for free;
- patch duplication drops from K²=9× to (2s/s)²=4×.

MAC overcompute is (2s)²/K² (1.78× at s=2, K=3). Everything is
integer-exact: the phase weight matrix is the original kernel
zero-padded into phase-aligned slots, so accumulators see the same
products plus zeros. Bit-exactness vs the im2col route is tested in
tests/test_conv_s2d.py.

Garbage-phase discipline: spatial extents are padded up to whole blocks
with zeros and the last block may contain phase rows ≥ OH; a chained
conv's valid outputs only ever read valid inputs (output spatial r needs
inputs ≤ r+K-1 < OH_prev), so block garbage propagates only into block
garbage and is sliced exactly once, at de-phase/pool time.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from bnn_pynq_tpu.ops.conv import sliding_window
from bnn_pynq_tpu.ops.thresholds import multithreshold


class BlockedAct(NamedTuple):
    """Phase-layout activation: codes [B, nb_h, nb_w, s²·C] covering the
    logical spatial grid [oh, ow] (block (i,j) slot (pi,pj) = spatial
    (s·i+pi, s·j+pj)); entries beyond oh/ow are garbage phases."""
    codes: jax.Array
    s: int
    oh: int
    ow: int


def blocked_weights(w_hwio, s: int):
    """Phase weight matrix [K,K,C,N] → [4s²C, s²N]: rows ordered
    (bi, bj, si, sj, c) over a 2×2 window of blocks whose lanes are
    (si, sj, c) slots; columns are (pi, pj, n) output phases. Output
    phase (pi,pj) tap (ka,kb) reads block bi, slot si with
    bi,si = divmod(pi+ka, s) (and likewise for columns)."""
    k, k2, c, n = w_hwio.shape
    assert k == k2 and k <= s + 1, (k, s)
    wp = jnp.zeros((2, 2, s, s, c, s, s, n), dtype=w_hwio.dtype)
    for pi in range(s):
        for pj in range(s):
            for ka in range(k):
                for kb in range(k):
                    bi, si = divmod(pi + ka, s)
                    bj, sj = divmod(pj + kb, s)
                    wp = wp.at[bi, bj, si, sj, :, pi, pj, :].set(
                        w_hwio[ka, kb])
    return wp.reshape(4 * s * s * c, s * s * n)


def _phase_dot(patches, wmat, thr, s: int, n: int):
    b, gh, gw, kw = patches.shape
    acc = jax.lax.dot_general(
        patches.reshape(b * gh * gw, kw), wmat,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    acc = acc.reshape(b, gh, gw, s * s * n)
    if thr is None:
        return acc
    return multithreshold(acc, jnp.tile(thr, (1, s * s)))


def _phase_dot_shifted(vals, wmat, thr, s: int, n: int):
    """The phase dot as a sum of FOUR shifted GEMMs instead of one
    concat+dot: each 2×2-window block position (bi,bj) contributes
    vals[:, bi:bi+gh, bj:bj+gw, :] @ wmat_rows(bi,bj) — the slices are
    views XLA can fuse into the dot operand read, so the 4× patch
    duplication is never materialized. Bit-exact with _phase_dot: same
    products, summed in a different order of int32 adds (exact)."""
    b, nbh, nbw, sc = vals.shape
    gh, gw = nbh - 1, nbw - 1
    w4 = wmat.reshape(2, 2, sc, s * s * n)
    acc = None
    for bi in range(2):
        for bj in range(2):
            x = vals[:, bi:bi + gh, bj:bj + gw, :].reshape(
                b * gh * gw, sc)
            part = jax.lax.dot_general(
                x, w4[bi, bj], dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)
            acc = part if acc is None else acc + part
    acc = acc.reshape(b, gh, gw, s * s * n)
    if thr is None:
        return acc
    return multithreshold(acc, jnp.tile(thr, (1, s * s)))


def to_blocked(x, s: int, nbh: int, nbw: int):
    """Spatial [B, H, W, C] → blocked [B, nbh, nbw, s²C], zero-padding up
    to whole blocks (padding feeds only garbage phases — see module
    docstring). One int8 reshape-transpose; XLA fuses it into the
    following patch concat."""
    b, h, w, c = x.shape
    hp, wp_ = nbh * s, nbw * s
    if hp != h or wp_ != w:
        x = jnp.pad(x, ((0, 0), (0, hp - h), (0, wp_ - w), (0, 0)))
    return x.reshape(b, nbh, s, nbw, s, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, nbh, nbw, s * s * c)


def reblock(ba: BlockedAct, s_to: int):
    """Re-block a phase activation to a smaller block size (s_from must
    be a multiple of s_to) — a single transpose, replacing the
    dephase + to_blocked pair when chaining mixed block sizes
    (e.g. CNV's s=4 conv1 feeding the s=2 conv2)."""
    s = ba.s
    if s_to == s:
        return ba
    assert s % s_to == 0, (s, s_to)
    r = s // s_to
    b, nbh, nbw, sn = ba.codes.shape
    n = sn // (s * s)
    x = ba.codes.reshape(b, nbh, nbw, r, s_to, r, s_to, n)
    x = x.transpose(0, 1, 3, 2, 5, 4, 6, 7)            # [b,nbh,r,nbw,r,...]
    x = x.reshape(b, nbh * r, nbw * r, s_to * s_to * n)
    return BlockedAct(x, s_to, ba.oh, ba.ow)


def conv_s2d_blocked(act, w_hwio, thr, *, s: int, form: str = "concat"):
    """One K×K stride-1 VALID conv in phase space.

    act: int8 LEVELS — spatial [B, H, W, C], or a BlockedAct whose
      `codes` field already holds levels (caller decodes codes→levels).
    form: 'concat' (2×2 patch concat + one dot) or 'shifted' (sum of 4
      sliced GEMMs, no patch materialization — see _phase_dot_shifted).
    Returns BlockedAct (codes when thr given, int32 acc when thr=None).
    """
    k, _, _, n = w_hwio.shape
    if isinstance(act, BlockedAct):
        assert act.s == s
        vals, (h, w) = act.codes, (act.oh, act.ow)
        oh, ow = h - k + 1, w - k + 1
        need_h, need_w = -(-oh // s) + 1, -(-ow // s) + 1
        b, nbh, nbw, _ = vals.shape
        if nbh < need_h or nbw < need_w:   # zero blocks: garbage-safe
            vals = jnp.pad(vals, ((0, 0), (0, max(0, need_h - nbh)),
                                  (0, max(0, need_w - nbw)), (0, 0)))
    else:
        b, h, w, c = act.shape
        oh, ow = h - k + 1, w - k + 1
        nbh, nbw = -(-oh // s) + 1, -(-ow // s) + 1
        vals = to_blocked(act, s, nbh, nbw)
    wmat = blocked_weights(w_hwio, s)
    if form == "shifted":
        out = _phase_dot_shifted(vals, wmat, thr, s, n)
    else:
        patches = sliding_window(vals, 2, 2, 1)
        out = _phase_dot(patches, wmat, thr, s, n)
    return BlockedAct(out, s, oh, ow)


def phase_maxpool(ba: BlockedAct):
    """2×2 maxpool of a s=2 BlockedAct as a phase-max (pool windows
    coincide exactly with blocks) — returns SPATIAL codes
    [B, oh/2, ow/2, N]. Codes are monotone in accumulators, so code-max
    ≡ value-max (binary case: the reference's OR maxpool, SURVEY C6)."""
    assert ba.s == 2 and ba.oh % 2 == 0 and ba.ow % 2 == 0, \
        (ba.s, ba.oh, ba.ow)
    b, nbh, nbw, sn = ba.codes.shape
    n = sn // 4
    # statically unrolled maximum over the four slot groups (the
    # reshape-to-[..., 4, n] + max(axis=3) form measured 4.2× slower on
    # the earlier accelerator; not re-measured on the GPU)
    out = ba.codes[..., 0:n]
    for i in range(1, 4):
        out = jnp.maximum(out, ba.codes[..., i * n:(i + 1) * n])
    return out[:, :ba.oh // 2, :ba.ow // 2]


def dephase(ba: BlockedAct):
    """Blocked → spatial [B, oh, ow, N] (one int8 transpose — only
    needed when a s2d layer feeds a non-s2d consumer)."""
    b, nbh, nbw, sn = ba.codes.shape
    s = ba.s
    n = sn // (s * s)
    x = ba.codes.reshape(b, nbh, nbw, s, s, n).transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nbh * s, nbw * s, n)[:, :ba.oh, :ba.ow]


def conv_s2d(vals, w_hwio, thr, *, s: int, fuse_pool: int = 0):
    """Single-layer convenience wrapper: spatial in → spatial out.
    fuse_pool=2 applies the following 2×2 maxpool as a phase-max
    (requires s=2, thresholds, even output extents)."""
    ba = conv_s2d_blocked(vals, w_hwio, thr, s=s)
    if fuse_pool:
        if fuse_pool != 2 or s != 2 or thr is None or \
                ba.oh % 2 or ba.ow % 2:
            raise ValueError("fuse_pool=2 needs s=2, thresholds, and even "
                             f"output extents, got s={s} oh={ba.oh} "
                             f"ow={ba.ow}")
        return phase_maxpool(ba)
    return dephase(ba)


def pick_s2d_block(c_in: int, n_out: int, oh: int, ow: int,
                   kernel: int, stride: int):
    """Per-layer policy: return the s2d block size, or 0 for im2col.

    s2d pays when the native dot shape is narrow (early convs) and stops
    paying once N ≥ 256 or the grid is too small to amortize. The
    thresholds below were chosen by measurement on the earlier accelerator
    (README, "Origin") and have not been re-derived on the GPU (ROADMAP).
    """
    if stride != 1 or kernel > 3 or min(oh, ow) < 8 or n_out > 128:
        return 0
    return 4 if c_in < 32 else 2
