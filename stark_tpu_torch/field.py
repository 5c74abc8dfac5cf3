"""Host-side scalar field API mirroring the reference's public surface.

The reference models field elements as ``FieldElement { value: u64, field }``
with per-op u128 widening (src/ff.rs).  In this package scalars are
control-plane only — bulk data lives in device tensors
(:mod:`stark_tpu_torch.ops.fieldops`) — but the scalar API reproduces the
reference's semantics *exactly*, including its quirks:

* ``new_element`` does NOT reduce mod p (ff.rs:113-118); arithmetic reduces
  per-op, and equality compares the RAW value (ff.rs:50-58).  Fiat-Shamir
  challenges therefore stay unreduced u64 until they enter modular ops
  (the bit-exactness trap of fiat_shamir.rs:19-25 + fri.rs:272).
* ``exp(x, 0) == 1`` including x = 0 (ff.rs:200-213).
* ``sample`` folds bytes with shift-xor mod p (ff.rs:225-232).
"""

from __future__ import annotations

from dataclasses import dataclass

from stark_tpu_torch.ops.fieldops import GENERATOR, P, TWO_ADICITY
from stark_tpu_torch.utils.xgcd import xgcd

_U128_MASK = (1 << 128) - 1
_U64_MASK = (1 << 64) - 1


@dataclass(frozen=True)
class FiniteField:
    """Prime field F_p.  Contract: reference src/ff.rs:108-233."""

    p: int = P

    def new_element(self, value: int) -> "FieldElement":
        # Deliberately unreduced, matching ff.rs:113-118.
        return FieldElement(int(value), self)

    def modulus(self) -> int:
        return self.p

    def one(self) -> "FieldElement":
        return FieldElement(1, self)

    def zero(self) -> "FieldElement":
        return FieldElement(0, self)

    def mul(self, l: "FieldElement", r: "FieldElement") -> "FieldElement":
        return FieldElement((l.value * r.value) % self.p, self)

    def add(self, l: "FieldElement", r: "FieldElement") -> "FieldElement":
        return FieldElement((l.value + r.value) % self.p, self)

    def sub(self, l: "FieldElement", r: "FieldElement") -> "FieldElement":
        # (p + l - r) computed in u128 (ff.rs:154-160): for adversarial
        # unreduced r > p + l the reference (release mode) WRAPS mod 2^128
        # before reducing — same semantics as fri._sub_ref.
        return FieldElement(
            ((self.p + l.value - r.value) & _U128_MASK) % self.p, self
        )

    def neg(self, op: "FieldElement") -> "FieldElement":
        # (p - value) % p on u64 (ff.rs:162-167): wraps mod 2^64 for
        # unreduced value > p.
        return FieldElement(((self.p - op.value) & _U64_MASK) % self.p, self)

    def inv(self, op: "FieldElement") -> "FieldElement":
        g, x, _ = xgcd(op.value, self.p)
        if g != 1:
            raise AssertionError("no inverse")
        return FieldElement(x % self.p, self)

    def div(self, l: "FieldElement", r: "FieldElement") -> "FieldElement":
        if r.value == 0:
            raise AssertionError("no division by zero")
        rinv = self.inv(r)
        return FieldElement((l.value * rinv.value) % self.p, self)

    def g(self) -> "FieldElement":
        assert self.p == P
        return FieldElement(GENERATOR, self)

    def exp(self, base: "FieldElement", e: int) -> "FieldElement":
        # LSB-first square-and-multiply; exp(x, 0) = 1 incl. x = 0
        # (ff.rs:200-213).
        res = 1
        b = base.value
        e = int(e)
        while e > 0:
            if e & 1:
                res = (res * b) % self.p
            b = (b * b) % self.p
            e >>= 1
        return FieldElement(res, self)

    def prim_nth_root(self, n: int) -> "FieldElement":
        assert self.p == P
        assert n & (n - 1) == 0, "n must be a power of two"
        assert n <= (1 << TWO_ADICITY), "n > 2^23 not supported by this modulus"
        return self.exp(self.g(), (self.p - 1) // n)

    def sample(self, salt: bytes) -> "FieldElement":
        # Contract: ff.rs:225-232 — per byte: shift-left-8 mod p, xor, mod p.
        acc = 0
        for b in salt:
            acc = (acc << 8) % self.p
            acc = (acc ^ b) % self.p
        return FieldElement(acc, self)


@dataclass(frozen=True)
class FieldElement:
    """A (possibly unreduced) field element.  Contract: src/ff.rs:24-106."""

    value: int
    field: FiniteField

    def __add__(self, rhs: "FieldElement") -> "FieldElement":
        return self.field.add(self, rhs)

    def __sub__(self, rhs: "FieldElement") -> "FieldElement":
        return self.field.sub(self, rhs)

    def __mul__(self, rhs: "FieldElement") -> "FieldElement":
        return self.field.mul(self, rhs)

    def __truediv__(self, rhs: "FieldElement") -> "FieldElement":
        return self.field.div(self, rhs)

    def __neg__(self) -> "FieldElement":
        return self.field.neg(self)

    def __xor__(self, e: int) -> "FieldElement":
        # Reference overloads BitXor as exponentiation (ff.rs:94-100).
        return self.field.exp(self, e)

    def pow(self, e: int) -> "FieldElement":
        return self.field.exp(self, e)

    # Equality compares RAW values + modulus, like ff.rs:50-58 (derived
    # automatically by the frozen dataclass).

    def __lt__(self, other: "FieldElement") -> bool:
        return self.value < other.value

    def reduced(self) -> int:
        """The canonical representative in [0, p)."""
        return self.value % self.field.p
