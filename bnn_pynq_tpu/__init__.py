"""bnn_pynq_tpu — a binarized/quantized neural-network inference engine.

A from-scratch rebuild of the capabilities of cbrl/BNN-PYNQ (the FINN-style
binarized-NN deployment stack, see SURVEY.md), running on JAX/XLA (an
NVIDIA GPU in production; the package name records where it was first
built, see README):

- W1A1 / W1A2 / W2A2 fully-connected and convolutional networks executed
  as int8 GEMMs/convolutions with int32 accumulation and MultiThreshold
  activations fused into the epilogue by XLA.
- An offline parameter compiler ("finnthesizer" analogue,
  SURVEY.md C14) that folds batch-norm into integer thresholds and packs
  weights into uint32 words (32 binary values per word).
- A JAX/optax training stack with straight-through-estimator binarization
  (SURVEY.md C13; needs the optional `flax` extra).
- A bit-exact pure-jnp golden model used as the software twin for testing
  (the analogue of the reference's rawhls CPU runtime, SURVEY.md §4.1).
- Multi-device scaling via jax.sharding meshes: tensor-sharded weights
  + data-parallel batch (SURVEY.md §2 parallelism table).

Integer conventions (defined here once, used everywhere):

- 1-bit values: v ∈ {-1,+1} <-> bit b ∈ {0,1} with v = 2b - 1.
- 2-bit values: code c ∈ {0,1,2,3} <-> integer level q = 2c - 3 ∈
  {-3,-1,+1,+3}, representing float value q/3 ∈ {-1,-1/3,+1/3,+1}.
  All inference arithmetic stays in integers; the 1/3 scale is absorbed
  into the folded thresholds.
- Packing: 32 one-bit values or 16 two-bit codes per uint32 word,
  little-endian within the word (element j of a word sits at bits
  [j*bits, (j+1)*bits)).
- Binary dot product of K packed pairs: dot = K - 2*popcount(a XOR w).
  K is always padded to a multiple of the word capacity; pad bits are 0 in
  both operands so each pad position contributes +1 to the padded dot.
"""

__version__ = "0.1.0"

from bnn_pynq_tpu.ops import packing  # noqa: F401
