"""stark_tpu_torch — the tpu-stark STARK prover on PyTorch and CUDA.

A port of the JAX package ``stark_tpu`` (which stays as the reference) to
PyTorch on an NVIDIA H100, module for module under the same names.  Given
the same AIR, config and witness it emits byte-identical proofs: the same
roots, transcript, challenges, query indices and wire bytes (reference
src/hash.rs, src/fiat_shamir.rs, src/stream.rs, src/fri.rs).

Ported so far: the single-device ``StarkProver.prove`` (from host rows,
or from columns made on the card: ``prove(trace_cols=...)``) and the
batched prover ``BatchStarkProver.prove_batch`` / ``prove_many`` (B proofs
at once, each byte-identical to its single prove) ->
``StarkVerifier.verify`` / ``verify_batch`` path for FibonacciAir and the
example AIRs, each proof of its own statement (``public``: the public
inputs that set the boundary values; ``prove_stream`` pipelines a stream
of them, as for the segment AIR ``FibonacciSegmentAir``), with the API
around it (``Polynomial``, ``Trace``, the
parity structs ``FriProof`` / ``QueryData``) and the command line
``python -m stark_tpu_torch demo|prove|verify|inspect``, and the sharded
prover over ``torch.distributed`` (``stark_tpu_torch.parallel``:
``DistributedStarkProver``, ``BatchStarkProver(mesh=)``; one process per
device, the same bytes at every rank count).  The TPU's Pallas
kernels on that path, and the jnp functions that need a kernel of their
own here, are hand-written CUDA (csrc/: the four-step NTT K1-K3, the FRI
folds K4 and K4-dyn, the hash and Merkle kernels K5-K8 and K8's forest
entry, the Fiat-Shamir sponge K9, the composition codeword K11 generated
per AIR, the device witnesses K12, the query phase's gather K13, the
LDE's zero pad and coset scale K14), built with nvcc at first use; on a
CPU tensor every kernel wrapper runs its plain torch version instead.
Importing the package imports neither jax nor stark_tpu.
"""

from stark_tpu_torch.field import FiniteField, FieldElement, P
from stark_tpu_torch.poly import Polynomial
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.merkle import MerkleTree
from stark_tpu_torch.transcript import FiatShamir
from stark_tpu_torch.stream import ProofObject, ProofStream
from stark_tpu_torch.fri import Fri, FriProof, QueryData
from stark_tpu_torch.models.trace import Trace
from stark_tpu_torch.stark import StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.batch import BatchStarkProver

__all__ = [
    "P",
    "FiniteField",
    "FieldElement",
    "Polynomial",
    "Hash",
    "MerkleTree",
    "FiatShamir",
    "ProofObject",
    "ProofStream",
    "Fri",
    "FriProof",
    "QueryData",
    "Trace",
    "StarkConfig",
    "StarkProver",
    "StarkVerifier",
    "BatchStarkProver",
]
