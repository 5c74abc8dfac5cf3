"""Serializable proof stream.  Byte-exact contract: reference src/stream.rs.

Wire format (stream.rs:35-64): per object a tag byte then payload —
  0: MerkleRoot   — 32 raw bytes
  1: FieldElement — u64 LE
  2: FieldElements — u64 LE count, then values as u64 LE
  3: MerklePath   — u64 LE count, then 32-byte hashes
Deserialization is tolerant: truncated items are skipped, unknown tags end
parsing (stream.rs:66-168).  Pop is FIFO (stream.rs:27-33).

The prover writes a proof's bytes in place: a :class:`ProofLayout` places
every object of B proofs of one shape once, tags and counts included, and
the prover copies only the payloads into the views it cuts; a stream made
over such a buffer (:meth:`ProofStream.written`) serializes it with one
copy.  The paths that push objects push the query phase's objects as raw
segments written the same way (:meth:`ProofLayout.push`).
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


#: The objects a :class:`ProofLayout` places: a Merkle root, a FieldElements
#: of m values ``(VALUES, m)``, a MerklePath of L digests ``(PATH, L)``.
ROOT, VALUES, PATH = 0, 2, 3

#: Proofs serialized, by how their bytes were written: ``layout``, in place
#: through a ProofLayout (:meth:`ProofStream.written`); ``objects``, pushed
#: object by object.  Counted whether traced or not.
SERIALIZED = {"layout": 0, "objects": 0}


def _object_bytes(obj: tuple) -> tuple[int, int, int]:
    """(header bytes, payload bytes, payload item bytes) of a layout object."""
    kind, width = obj[0], (obj[1] if len(obj) > 1 else 1)
    if kind == ROOT:
        return 1, 32, 1
    if kind == VALUES:
        return 9, 8 * width, 8
    if kind == PATH:
        return 9, 32 * width, 1
    raise ValueError(f"unknown layout object {obj}")


class ProofLayout:
    """Where every object of B proofs of one shape lies in their wire bytes:
    groups of ``count`` records, each record the same objects, added in
    proof order.  The shape fixes every tag, count and offset, so
    :meth:`buffer` writes them once into a (B, :attr:`nbytes`) u8 buffer and
    a prove copies only payloads, into the strided views :meth:`views` cuts
    (the prover's single-fetch proofs: one buffer a slot, reused).  Field
    values are below 2^32: a value view is the low half of each u64, whose
    high half the buffer holds zero."""

    def __init__(self, b: int):
        self.b = b
        self.nbytes = 0
        #: name -> (first byte, records, record bytes, objects)
        self.groups: dict[str, tuple[int, int, int, tuple]] = {}

    def add(self, name: str, count: int, *objects: tuple) -> None:
        """``count`` records of ``objects``, each ``(ROOT,)``, ``(VALUES, m)``
        or ``(PATH, L)``, after every group added before."""
        if name in self.groups:
            raise ValueError(f"the layout already has a group {name!r}")
        record = sum(sum(_object_bytes(o)[:2]) for o in objects)
        self.groups[name] = (self.nbytes, count, record, tuple(objects))
        self.nbytes += count * record

    def _places(self):
        """(name, object, its header's first byte, record bytes, count)."""
        for name, (at, count, record, objects) in self.groups.items():
            for obj in objects:
                yield name, obj, at, record, count
                at += sum(_object_bytes(obj)[:2])

    def buffer(self) -> np.ndarray:
        """A (B, nbytes) u8 buffer holding every header, its payloads zero."""
        buf = np.zeros((self.b, self.nbytes), dtype=np.uint8)
        for _, obj, at, record, count in self._places():
            head = _object_bytes(obj)[0]
            heads = self._view(buf, at, count, record, head, 1, np.uint8)
            heads[:, :, 0] = obj[0]
            if head > 1:
                heads[:, :, 1:] = np.frombuffer(obj[1].to_bytes(8, "little"), dtype=np.uint8)
        return buf

    def views(self, buf: np.ndarray) -> dict[str, tuple[np.ndarray, ...]]:
        """Each group's payload views of ``buf`` (a :meth:`buffer`), one an
        object: (B, count, 32) u8 for a root, (B, count, m) u32 for m values,
        (B, count, 32 L) u8 for a path of L digests."""
        if buf.shape != (self.b, self.nbytes) or buf.dtype != np.uint8 \
                or not buf.flags.c_contiguous:
            raise ValueError(f"a layout buffer is ({self.b}, {self.nbytes}) u8, got "
                             f"{buf.shape} {buf.dtype}")
        out: dict[str, tuple] = {}
        for name, obj, at, record, count in self._places():
            head, size, step = _object_bytes(obj)
            view = (self._view(buf, at + head, count, record, size // step, step, "<u4")
                    if obj[0] == VALUES else
                    self._view(buf, at + head, count, record, size, 1, np.uint8))
            out[name] = out.get(name, ()) + (view,)
        return out

    def _view(self, buf, at: int, count: int, record: int, width: int, step: int, dtype):
        return np.ndarray((self.b, count, width), dtype=dtype, buffer=buf, offset=at,
                          strides=(self.nbytes, record, step))

    def push(self, proof_streams: list, fill) -> None:
        """``fill(views)`` into a new buffer, then each proof's bytes pushed
        to its stream as one raw segment (the paths that push objects)."""
        buf = self.buffer()
        fill(self.views(buf))
        for stream, row in zip(proof_streams, buf):
            stream.push_raw(row)


class _Raw(bytes):
    """Pre-serialized wire segment (one or more whole objects) pushed by
    the prover's paths that push objects (:meth:`ProofLayout.push`).
    Serialization output is byte-identical; prover-side streams are never
    popped, so the object view is unused."""


class ProofStream:
    def __init__(self, objects=None):
        self.objects = deque(objects or [])
        self._written = None

    @classmethod
    def written(cls, wire) -> "ProofStream":
        """The stream of one proof whose bytes are already written, whole,
        in ``wire`` (a row of a :class:`ProofLayout`'s buffer): nothing is
        pushed to it, and :meth:`serialize` copies ``wire`` once."""
        stream = cls()
        stream._written = wire
        return stream

    def push(self, obj) -> None:
        self.objects.append(obj)

    def push_raw(self, data) -> None:
        """Append an already-serialized segment, copied (bytes or any
        buffer of whole objects in wire format; the caller is trusted, tests
        pin byte-equality with the object path)."""
        self.objects.append(_Raw(data))

    def pop(self):
        return self.objects.popleft() if self.objects else None

    def __len__(self) -> int:
        return len(self.objects)

    def serialize(self) -> bytes:
        with span("stream.serialize"):
            if self._written is not None:
                SERIALIZED["layout"] += 1
                return bytes(self._written)
            SERIALIZED["objects"] += 1
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
