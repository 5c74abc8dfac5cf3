"""stark_tpu_torch — the tpu-stark STARK prover on PyTorch and CUDA.

A port of the JAX package ``stark_tpu`` (which stays as the reference) to
PyTorch on an NVIDIA H100, module for module under the same names.  Given
the same AIR, config and witness it emits byte-identical proofs: the same
roots, transcript, challenges, query indices and wire bytes (reference
src/hash.rs, src/fiat_shamir.rs, src/stream.rs, src/fri.rs).

This slice is the single-device Fibonacci path, ``StarkProver.prove`` ->
``StarkVerifier.verify``.  The TPU's Pallas kernels on that path are
hand-written CUDA here (csrc/: the four-step NTT K1-K3 and the FRI fold
K4), built with nvcc at first use; on a CPU tensor every kernel wrapper
runs its plain torch version instead.  Importing the package imports
neither jax nor stark_tpu.
"""

from stark_tpu_torch.field import FiniteField, FieldElement, P
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.merkle import MerkleTree
from stark_tpu_torch.transcript import FiatShamir
from stark_tpu_torch.stream import ProofObject, ProofStream
from stark_tpu_torch.fri import Fri
from stark_tpu_torch.stark import StarkConfig, StarkProver, StarkVerifier

__all__ = [
    "P",
    "FiniteField",
    "FieldElement",
    "Hash",
    "MerkleTree",
    "FiatShamir",
    "ProofObject",
    "ProofStream",
    "Fri",
    "StarkConfig",
    "StarkProver",
    "StarkVerifier",
]
