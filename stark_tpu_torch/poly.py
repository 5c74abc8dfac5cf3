"""Dense univariate polynomials over F_p (counterpart of stark_tpu/poly.py).

API contract: reference src/univariate/ (mod.rs, add.rs, sub.rs, mul.rs,
div.rs, eval.rs, exp.rs, interpolate.rs).  The reference's algorithms are
O(n^2) schoolbook multiply, O(n*m) long division and O(n^3) Lagrange
interpolation; this implementation produces the *same* (reduced) results
while re-algorithmizing:

* ``mul``   — schoolbook below 64 coefficients (with mul.rs's skip of zero
              lhs coefficients), above it a convolution through the NTT
              kernels K1-K3 (ops/ntt.py) on the polynomial's ``device``:
              ``cuda`` by default, resolved only when that path is taken,
              so a product above the crossover raises without a card
              unless the polynomial was made with ``device="cpu"`` (the
              kernels' plain versions).  The product's coefficients are
              reduced mod p (mul.rs:6-29).
* ``eval_domain`` / ``interpolate_domain`` on *smooth coset* domains — the
  protocol layers call :mod:`stark_tpu_torch.ops.ntt` directly; the
  generic-domain methods here use an O(n^2) barycentric-style scheme that
  returns the same unique interpolant as interpolate.rs:6-44.

Coefficients are exact Python ints, kept as given (unreduced) until an
operation reduces its result to [0, p), as the reference's per-op u128
arithmetic does.  Scalar polynomials are control-plane objects: bulk
evaluation data lives in int32 device tensors in the protocol layers.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.field import FieldElement, FiniteField
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops import ntt as NTT

_NTT_MUL_CROSSOVER = 64  # below this, schoolbook is faster than dispatch


def _coerce(values) -> list[int]:
    out = []
    for v in values:
        out.append(v.value if isinstance(v, FieldElement) else int(v))
    return out


class Polynomial:
    """coeffs[i] is the coefficient of x^i (ascending), values raw ints.
    ``device``: where a product above the crossover runs its NTTs (see the
    module's docstring); every polynomial made from this one keeps it."""

    def __init__(self, coeffs, field: FiniteField | None = None, device="cuda"):
        self.field = field or FiniteField()
        self.coeffs = _coerce(coeffs)
        self.device = device

    def _new(self, coeffs) -> "Polynomial":
        return Polynomial(coeffs, self.field, self.device)

    # -- constructors (mod.rs:133-143) ---------------------------------------

    @staticmethod
    def zero_poly(field: FiniteField | None = None, device="cuda") -> "Polynomial":
        return Polynomial([], field, device)

    @staticmethod
    def constant_poly(field: FiniteField | None, value: int,
                      device="cuda") -> "Polynomial":
        return Polynomial([value], field, device)

    @staticmethod
    def linear_poly(field: FiniteField | None, a: int, b: int,
                    device="cuda") -> "Polynomial":
        return Polynomial([a, b], field, device)

    # -- structure (mod.rs:54-131) -------------------------------------------

    def deg(self) -> int:
        """-1 for the zero polynomial; index of last nonzero (mod p) coeff."""
        maxidx = -1
        p = self.field.p
        for i, c in enumerate(self.coeffs):
            if c % p != 0:
                maxidx = i
        return maxidx

    def is_zero(self) -> bool:
        return self.deg() == -1

    def leading_coeff(self) -> int:
        d = self.deg()
        if d == -1:
            raise AssertionError("Zero polynomial has no leading coefficient")
        return self.coeffs[d] % self.field.p

    def __eq__(self, other) -> bool:
        # Trailing-zero normalization, values compared mod p (mod.rs:13-44
        # compares reduced results since arithmetic reduces per-op).
        if not isinstance(other, Polynomial):
            return NotImplemented
        d = self.deg()
        if d != other.deg():
            return False
        p = self.field.p
        return all(
            self.coeffs[i] % p == other.coeffs[i] % p for i in range(d + 1)
        )

    def __repr__(self) -> str:
        return f"Polynomial({self.coeffs})"

    # -- arithmetic -----------------------------------------------------------

    def __neg__(self) -> "Polynomial":
        p = self.field.p
        return self._new([(p - c) % p for c in self.coeffs])

    def __add__(self, rhs: "Polynomial") -> "Polynomial":
        # add.rs:6-32 — pad to max length, elementwise mod p.
        p = self.field.p
        n = max(len(self.coeffs), len(rhs.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = rhs.coeffs + [0] * (n - len(rhs.coeffs))
        return self._new([(x + y) % p for x, y in zip(a, b)])

    def __sub__(self, rhs: "Polynomial") -> "Polynomial":
        # sub.rs:8-34
        p = self.field.p
        n = max(len(self.coeffs), len(rhs.coeffs))
        a = self.coeffs + [0] * (n - len(self.coeffs))
        b = rhs.coeffs + [0] * (n - len(rhs.coeffs))
        return self._new([(x - y) % p for x, y in zip(a, b)])

    def __mul__(self, rhs: "Polynomial") -> "Polynomial":
        """Product, length l+r-1 (mul.rs:6-29).  NTT above the crossover:
        both operands transformed as one batch of two rows (K1-K3 once
        each), the pointwise product, one inverse transform (K1-K3 again)
        on ``self.device``."""
        if not self.coeffs or not rhs.coeffs:
            return self._new([])
        p = self.field.p
        la, lb = len(self.coeffs), len(rhs.coeffs)
        out_len = la + lb - 1
        if min(la, lb) < _NTT_MUL_CROSSOVER:
            out = [0] * out_len
            for i, a in enumerate(self.coeffs):
                if a % p == 0:
                    continue  # mul.rs:17-19 skips zero lhs coeffs
                for j, b in enumerate(rhs.coeffs):
                    out[i + j] = (out[i + j] + a * b) % p
            return self._new(out)
        # NTT convolution: pad to next pow2 >= out_len.
        device = cuda.device_or_raise(self.device, "Polynomial multiply")
        n = 1 << (out_len - 1).bit_length()
        rows = np.zeros((2, n), dtype=np.int64)
        rows[0, :la] = [c % p for c in self.coeffs]
        rows[1, :lb] = [c % p for c in rhs.coeffs]
        fa, fb = NTT.ntt(torch.from_numpy(rows).to(torch.int32).to(device))
        prod = NTT.intt(F.mulmod(fa, fb).to(torch.int32))[:out_len]
        return self._new(prod.cpu().tolist())

    def __divmod__(self, rhs: "Polynomial") -> tuple["Polynomial", "Polynomial"]:
        """Long division (div.rs:6-41)."""
        if rhs.is_zero():
            raise AssertionError("division by zero polynomial")
        p = self.field.p
        dd = rhs.deg()
        lead_inv = pow(rhs.leading_coeff(), p - 2, p)
        rem = [c % p for c in self.coeffs]
        dn = self.deg()
        if dn < dd:
            return self._new([]), self._new(rem)
        quot = [0] * (dn - dd + 1)
        for k in range(dn - dd, -1, -1):
            coef = (rem[dd + k] * lead_inv) % p
            quot[k] = coef
            if coef:
                for j in range(dd + 1):
                    rem[k + j] = (rem[k + j] - coef * (rhs.coeffs[j] % p)) % p
        return self._new(quot), self._new(rem[:dd])

    def __truediv__(self, rhs: "Polynomial") -> "Polynomial":
        return divmod(self, rhs)[0]

    def intdiv(self, rhs: "Polynomial") -> "Polynomial":
        """Exact division, asserting zero remainder (div.rs:43-47)."""
        q, r = divmod(self, rhs)
        assert r.is_zero(), "intdiv: nonzero remainder"
        return q

    def __mod__(self, rhs: "Polynomial") -> "Polynomial":
        return divmod(self, rhs)[1]

    def __xor__(self, e: int) -> "Polynomial":
        return self.exp(e)

    def exp(self, e: int) -> "Polynomial":
        """Square-and-multiply on polynomials (exp.rs:6-33)."""
        if e == 0:
            return self._new([1])
        acc = self._new([1])
        base = self
        while e > 0:
            if e & 1:
                acc = acc * base
            base = base * base
            e >>= 1
        return acc

    # -- evaluation / interpolation -------------------------------------------

    def eval(self, x) -> int:
        """Ascending-power accumulation (eval.rs:6-14)."""
        xv = x.value if isinstance(x, FieldElement) else int(x)
        p = self.field.p
        xi, val = 1, 0
        for c in self.coeffs:
            val = (val + c * xi) % p
            xi = (xi * xv) % p
        return val

    def eval_domain(self, domain) -> list[int]:
        """Naive per-point map (eval.rs:16-21).  For power-of-two coset
        domains, prefer :func:`stark_tpu_torch.ops.ntt.coset_eval`."""
        return [self.eval(x) for x in domain]

    @staticmethod
    def interpolate_domain(domain, values, field: FiniteField | None = None,
                           device="cuda") -> "Polynomial":
        """Unique interpolant through (domain[i], values[i]).

        Same result as the reference's O(n^3) Lagrange (interpolate.rs:6-44),
        computed in O(n^2): build the zerofier Z, divide out each linear
        factor synthetically, and scale by y_i / Z_i(x_i).
        """
        field = field or FiniteField()
        p = field.p
        xs = _coerce(domain)
        ys = _coerce(values)
        assert len(xs) == len(ys) and len(xs) > 0
        n = len(xs)
        # zerofier coefficients: prod (x - x_i), length n+1
        z = [0] * (n + 1)
        z[0] = 1
        deg = 0
        for xi in xs:
            deg += 1
            for j in range(deg, 0, -1):
                z[j] = (z[j - 1] - z[j] * xi) % p
            z[0] = (-z[0] * xi) % p
        acc = [0] * n
        for i in range(n):
            xi = xs[i]
            # synthetic division of z by (x - xi): quotient q, length n
            q = [0] * n
            carry = z[n]
            for j in range(n - 1, -1, -1):
                q[j] = carry
                carry = (z[j] + carry * xi) % p
            # denominator = q(xi) = prod_{j != i} (xi - xj)
            denom = 0
            xpow = 1
            for j in range(n):
                denom = (denom + q[j] * xpow) % p
                xpow = (xpow * xi) % p
            assert denom % p != 0, "no inverse"  # duplicate x values
            scale = (ys[i] * pow(denom, p - 2, p)) % p
            if scale:
                for j in range(n):
                    acc[j] = (acc[j] + scale * q[j]) % p
        return Polynomial(acc, field, device)

    @staticmethod
    def zerofier(domain, field: FiniteField | None = None, device="cuda") -> "Polynomial":
        """prod (x - d) over the domain (mod.rs:77-96)."""
        field = field or FiniteField()
        p = field.p
        xs = _coerce(domain)
        z = [1]
        for xi in xs:
            z = [0] + z
            for j in range(len(z) - 1):
                z[j] = (z[j] - z[j + 1] * xi) % p
        return Polynomial(z, field, device)

    def scale(self, factor) -> "Polynomial":
        """f(c*X): coefficient i multiplied by c^i (mod.rs:99-113)."""
        fv = factor.value if isinstance(factor, FieldElement) else int(factor)
        p = self.field.p
        out, fpow = [], 1
        for c in self.coeffs:
            out.append((c * fpow) % p)
            fpow = (fpow * fv) % p
        return self._new(out)

    @staticmethod
    def test_colinearity(points, field: FiniteField | None = None) -> bool:
        """Interpolate and check degree <= 1 (mod.rs:145-152)."""
        assert len(points) >= 2, "At least 2 points to test colinearity"
        field = field or FiniteField()
        xs = [pt[0] for pt in points]
        ys = [pt[1] for pt in points]
        return Polynomial.interpolate_domain(xs, ys, field).deg() <= 1
