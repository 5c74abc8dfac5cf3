"""Extended Euclid.  Contract: reference src/utils.rs:3-13."""

from __future__ import annotations


def xgcd(x: int, y: int) -> tuple[int, int, int]:
    """Return (gcd, a, b) with a*x + b*y == gcd (iterative, exact ints)."""
    a0, a1 = 1, 0
    b0, b1 = 0, 1
    while y != 0:
        q = x // y
        x, y = y, x - q * y
        a0, a1 = a1, a0 - q * a1
        b0, b1 = b1, b0 - q * b1
    return x, a0, b0
