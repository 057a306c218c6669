"""MultiThreshold activation — integer threshold compare.

Equivalent of the reference's `ThresholdsActivation`
(SURVEY.md C4 «bnn/src/library/hls/activations.hpp»): per-output-channel
integer thresholds implement batch-norm + sign/quantize with zero float
math at inference.

Semantics: given an integer accumulator `acc` (the TRUE ±1/odd-level dot
product, after pad correction) and per-channel ascending thresholds
`thr[nthr, N]`, the output code is

    code[..., n] = sum_t (acc[..., n] >= thr[t, n])            in {0..nthr}

- 1-bit activation: nthr=1, code ∈ {0,1}, value = 2*code - 1 ∈ {-1,+1}.
- 2-bit activation: nthr=3, code ∈ {0..3}, level = 2*code - 3.

Channels whose batch-norm slope was negative are handled upstream by the
parameter compiler (weight-row flip), so thresholds here are always applied
with `>=` — matching the single comparison direction of the reference MVTU
epilogue. Sentinels THR_NEVER/THR_ALWAYS encode degenerate (slope≈0)
channels.
"""

from __future__ import annotations

import jax.numpy as jnp

# Sentinel thresholds for degenerate channels (gamma == 0 in BN folding):
# acc is always < THR_NEVER and always >= THR_ALWAYS for any realistic
# accumulator magnitude (|acc| <= 3 * K_max << 2^30).
THR_NEVER = (1 << 30)
THR_ALWAYS = -(1 << 30)


def multithreshold(acc, thr):
    """Apply per-channel thresholds.

    acc: int32 [..., N] true integer accumulator.
    thr: int32 [nthr, N] ascending thresholds per channel.
    returns int8 codes [..., N] in {0..nthr}.
    """
    acc = jnp.asarray(acc)
    thr = jnp.asarray(thr)
    # Statically unrolled over the (≤3) thresholds as plain [..., N]
    # compares, which XLA fuses into the GEMM epilogue. (The broadcast
    # form over a [..., nthr, N] intermediate measured 3.3× slower on the
    # earlier accelerator; not re-measured on the GPU.)
    code = (acc >= thr[0]).astype(jnp.int8)
    for i in range(1, thr.shape[0]):
        code = code + (acc >= thr[i]).astype(jnp.int8)
    return code


def codes_to_values(codes, abits: int):
    """Map codes to the integer activation levels used by the next layer.

    abits=1: {0,1} → {-1,+1};  abits=2: {0..3} → {-3,-1,1,3}.
    """
    codes = jnp.asarray(codes, dtype=jnp.int8)
    if abits == 1:
        return (2 * codes - 1).astype(jnp.int8)
    if abits == 2:
        return (2 * codes - 3).astype(jnp.int8)
    raise ValueError(f"unsupported abits={abits}")
