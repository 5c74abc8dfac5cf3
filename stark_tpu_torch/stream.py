"""Serializable proof stream.  Byte-exact contract: reference src/stream.rs.

Wire format (stream.rs:35-64): per object a tag byte then payload —
  0: MerkleRoot   — 32 raw bytes
  1: FieldElement — u64 LE
  2: FieldElements — u64 LE count, then values as u64 LE
  3: MerklePath   — u64 LE count, then 32-byte hashes
Deserialization is tolerant: truncated items are skipped, unknown tags end
parsing (stream.rs:66-168).  Pop is FIFO (stream.rs:27-33).  The prover's
bulk emission pushes pre-serialized segments (:meth:`ProofStream.push_raw`,
built by :func:`wire_field_elements` / :func:`wire_merkle_paths`), which
serialize verbatim.
"""

from __future__ import annotations

import struct
from collections import deque
from dataclasses import dataclass

import numpy as np

from stark_tpu_torch.field import FieldElement, FiniteField
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class MerkleRoot:
    hash: Hash


@dataclass(frozen=True)
class FieldElementObj:
    element: FieldElement


class FieldElements:
    """A FieldElements proof object (wire tag 2).

    Two representations with identical observable behavior:

    * **eager** — constructed with a tuple of ``FieldElement`` (or raw
      ints, as the prover's bulk emit paths do);
    * **wire-backed** — constructed by :meth:`ProofStream.deserialize`
      with a ``(buffer, offset, count, field)`` view into the proof
      bytes.  ``elements`` materializes lazily; the fast accessors below
      read the wire directly, so verification never pays per-element
      Python object construction for values it only consumes as ints.
    """

    __slots__ = ("_elements", "_wire")

    def __init__(self, elements=None, *, _wire=None):
        assert (elements is None) != (_wire is None)
        self._elements = tuple(elements) if elements is not None else None
        self._wire = _wire  # (buffer, offset, count, field)

    @property
    def elements(self) -> tuple:
        if self._elements is None:
            buf, off, count, field = self._wire
            vals = struct.unpack_from(f"<{count}Q", buf, off)
            self._elements = tuple(field.new_element(v) for v in vals)
        return self._elements

    def __len__(self) -> int:
        return self._wire[2] if self._elements is None else len(self._elements)

    def values_ints(self) -> list:
        """Raw u64 wire values as Python ints (no FieldElement churn)."""
        if self._elements is None:
            buf, off, count, _ = self._wire
            return list(struct.unpack_from(f"<{count}Q", buf, off))
        return [
            fe.value if isinstance(fe, FieldElement) else int(fe)
            for fe in self._elements
        ]

    def values_u64(self):
        """Raw u64 wire values as a numpy array (zero-copy when wire-backed)."""
        if self._elements is None:
            buf, off, count, _ = self._wire
            return np.frombuffer(buf, dtype="<u8", count=count, offset=off)
        return np.array(self.values_ints(), dtype=np.uint64)

    def __eq__(self, other):
        return isinstance(other, FieldElements) and self.elements == other.elements

    def __hash__(self):
        return hash(self.elements)

    def __repr__(self):
        return f"FieldElements({self.elements!r})"


class MerklePath:
    """A MerklePath proof object (wire tag 3) — eager tuple-of-Hash or a
    lazy wire-backed view (see :class:`FieldElements`); ``raw_bytes``
    feeds the native batched path verifier without building one Hash
    object per sibling digest."""

    __slots__ = ("_path", "_wire")

    def __init__(self, path=None, *, _wire=None):
        assert (path is None) != (_wire is None)
        self._path = tuple(path) if path is not None else None
        self._wire = _wire  # (buffer, offset, count)

    @property
    def path(self) -> tuple:
        if self._path is None:
            buf, off, count = self._wire
            self._path = tuple(
                Hash(bytes(buf[off + 32 * j : off + 32 * (j + 1)]))
                for j in range(count)
            )
        return self._path

    def __len__(self) -> int:
        return self._wire[2] if self._path is None else len(self._path)

    def raw_bytes(self) -> bytes:
        """The concatenated 32-byte sibling digests (wire payload)."""
        if self._path is None:
            buf, off, count = self._wire
            return bytes(buf[off : off + 32 * count])
        return b"".join(h.data for h in self._path)

    def __eq__(self, other):
        return isinstance(other, MerklePath) and self.path == other.path

    def __hash__(self):
        return hash(self.path)

    def __repr__(self):
        return f"MerklePath({self.path!r})"


class ProofObject:
    """Namespace mirroring the reference's ProofObject enum variants."""

    MerkleRoot = MerkleRoot
    FieldElement = FieldElementObj
    FieldElements = FieldElements
    MerklePath = MerklePath


def wire_field_elements(rows) -> np.ndarray:
    """Wire bytes of k FieldElements objects (tag 2) at once: ``rows`` is
    a (k, m) array of values (any integer dtype, field values < 2^32);
    row q of the (k, 9 + 8m) u8 result is object q (stream.rs:45-52)."""
    rows = np.asarray(rows)
    k, m = rows.shape
    out = np.empty((k, 9 + 8 * m), dtype=np.uint8)
    out[:, 0] = 2
    out[:, 1:9] = np.frombuffer(m.to_bytes(8, "little"), dtype=np.uint8)
    out[:, 9:] = rows.astype("<u8").view(np.uint8).reshape(k, 8 * m)
    return out


def wire_merkle_paths(sib) -> np.ndarray:
    """Wire bytes of k MerklePath objects (tag 3) at once: ``sib`` is a
    (k, L, 32) u8 array of sibling digests, bottom-up; row q of the
    (k, 9 + 32L) u8 result is path q (stream.rs:53-63)."""
    sib = np.asarray(sib, dtype=np.uint8)
    k, L = sib.shape[:2]
    out = np.empty((k, 9 + 32 * L), dtype=np.uint8)
    out[:, 0] = 3
    out[:, 1:9] = np.frombuffer(L.to_bytes(8, "little"), dtype=np.uint8)
    out[:, 9:] = sib.reshape(k, 32 * L)
    return out


def raw_field_elements(values) -> bytes:
    """Wire bytes of ONE FieldElements object from a 1-D sequence of ints."""
    return wire_field_elements(np.asarray(values, dtype=np.uint64)[None]).tobytes()


def raw_merkle_path(path) -> bytes:
    """Wire bytes of ONE MerklePath object from its (L, 32) u8 sibling
    digests.  (stark_tpu's ``raw_merkle_path(sib, q)`` takes query q of a
    level-major (L, k, 32) array; the port's gathers are query-major.)"""
    return wire_merkle_paths(np.asarray(path, dtype=np.uint8)[None]).tobytes()


class _Raw(bytes):
    """Pre-serialized wire segment (one or more whole objects) pushed by
    the prover's bulk emit paths: one bytes object per query phase round
    instead of one Hash per tree level.  Serialization output is
    byte-identical; prover-side streams are never popped, so the object
    view is unused."""


class ProofStream:
    def __init__(self, objects=None):
        self.objects = deque(objects or [])

    def push(self, obj) -> None:
        self.objects.append(obj)

    def push_raw(self, data: bytes) -> None:
        """Append an already-serialized segment (whole objects in wire
        format; the caller is trusted, tests pin byte-equality with the
        object path)."""
        self.objects.append(_Raw(data))

    def pop(self):
        return self.objects.popleft() if self.objects else None

    def __len__(self) -> int:
        return len(self.objects)

    def serialize(self) -> bytes:
        with span("stream.serialize"):
            out = bytearray()
            for obj in self.objects:
                if isinstance(obj, _Raw):
                    out.extend(obj)
                elif isinstance(obj, MerkleRoot):
                    out.append(0)
                    out.extend(obj.hash.data)
                elif isinstance(obj, FieldElementObj):
                    out.append(1)
                    out.extend(int(obj.element.value).to_bytes(8, "little"))
                elif isinstance(obj, FieldElements):
                    out.append(2)
                    out.extend(len(obj).to_bytes(8, "little"))
                    if obj._elements is None:  # wire-backed: copy payload verbatim
                        buf, off, count, _ = obj._wire
                        out.extend(buf[off : off + 8 * count])
                    else:
                        for fe in obj._elements:
                            value = (
                                fe.value if isinstance(fe, FieldElement) else int(fe)
                            )
                            out.extend(int(value).to_bytes(8, "little"))
                elif isinstance(obj, MerklePath):
                    out.append(3)
                    out.extend(len(obj).to_bytes(8, "little"))
                    out.extend(obj.raw_bytes())
                else:
                    raise TypeError(f"unknown proof object {type(obj)}")
            return bytes(out)

    @staticmethod
    def deserialize(data: bytes, field: FiniteField) -> "ProofStream":
        objects = []
        i = 0
        n = len(data)
        while i < n:
            tag = data[i]
            i += 1
            if tag == 0:
                if i + 32 <= n:
                    objects.append(MerkleRoot(Hash(data[i : i + 32])))
                    i += 32
            elif tag == 1:
                if i + 8 <= n:
                    val = int.from_bytes(data[i : i + 8], "little")
                    objects.append(FieldElementObj(field.new_element(val)))
                    i += 8
            elif tag == 2:
                if i + 8 <= n:
                    count = int.from_bytes(data[i : i + 8], "little")
                    i += 8
                    # Clamp to the bytes present: identical parse result to
                    # the reference's bounds-checked loop, without letting a
                    # hostile 2^64 count spin the parser (DoS).  The object
                    # is a lazy view over the wire — deserialization is pure
                    # offset arithmetic, O(1) per object.
                    count = min(count, (n - i) // 8)
                    objects.append(
                        FieldElements(_wire=(data, i, count, field))
                    )
                    i += 8 * count
            elif tag == 3:
                if i + 8 <= n:
                    count = int.from_bytes(data[i : i + 8], "little")
                    i += 8
                    count = min(count, (n - i) // 32)
                    objects.append(MerklePath(_wire=(data, i, count)))
                    i += 32 * count
            else:
                break
        return ProofStream(objects)
