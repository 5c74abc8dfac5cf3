"""Fiat-Shamir transcript.  Bit-exact contract: reference src/fiat_shamir.rs.

* ``absorb`` appends bytes — the ONLY state mutation (fiat_shamir.rs:15-17).
* ``challenge`` is PURE: it hashes the entire transcript and returns the
  first 8 digest bytes as a little-endian u64, wrapped UNREDUCED in a field
  element (fiat_shamir.rs:19-25 + ff.rs:113-118).  Repeated calls between
  absorbs return the same value — the reference protocol relies on this
  (prover skips the last-round challenge, verifier doesn't; both stay in
  sync, fri.rs:133-138 vs fri.rs:325-334).

The transcript is tiny (Merkle roots and challenge bytes), so it is hashed
on the host by the native engine.
"""

from __future__ import annotations

from stark_tpu_torch.field import FieldElement, FiniteField
from stark_tpu_torch.hashfn import hash_bytes


class FiatShamir:
    def __init__(self):
        self.transcript = bytearray()

    def absorb(self, data: bytes) -> None:
        self.transcript.extend(data)

    def challenge(self, field: FiniteField) -> FieldElement:
        digest = hash_bytes(bytes(self.transcript))
        val = int.from_bytes(digest[:8], "little")
        return field.new_element(val)  # deliberately unreduced (ff.rs:113-118)
