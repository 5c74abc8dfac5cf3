"""Execution traces (counterpart of stark_tpu/models/trace.py).  API
contract: reference src/trace.rs:4-50.

``Trace.fibonacci`` reproduces the reference generator (trace.rs:36-49)
exactly — including its value semantics: the reference stores i128 and
``to_field_elements`` casts ``i128 as u64`` (truncating mod 2^64,
trace.rs:29-34) into UNREDUCED field elements.  Python ints never overflow,
so the cast is applied explicitly.

For actual STARK proving use :func:`stark_tpu_torch.models.fibonacci.
fibonacci_trace_mod_p`, which generates the sequence in F_p so the AIR
transition constraint holds over the field for any length.
"""

from __future__ import annotations

from stark_tpu_torch.field import FieldElement, FiniteField

_U64_MASK = (1 << 64) - 1


class Trace:
    def __init__(self, trace: list[list[int]]):
        self.trace = [list(row) for row in trace]
        self.num_columns = len(trace[0])

    def get_row(self, i: int):
        """Row i or None out of bounds — EXACT reference semantics:
        ``self.trace.get(i)`` returns Option (trace.rs:17-19).  Negative i
        is inexpressible in the reference (usize), so it is out-of-bounds
        here too rather than Python tail indexing."""
        return self.trace[i] if 0 <= i < len(self.trace) else None

    def get_col(self, j: int) -> list[int]:
        return [row[j] for row in self.trace]

    def get(self, i: int, j: int):
        """Cell (i, j) or None out of bounds (Option-chained ``get``,
        trace.rs:25-27)."""
        if 0 <= i < len(self.trace) and 0 <= j < len(self.trace[i]):
            return self.trace[i][j]
        return None

    def __len__(self) -> int:
        return len(self.trace)

    def to_field_elements(self, field: FiniteField) -> list[list[FieldElement]]:
        # i128 -> u64 truncation, then unreduced new_element (trace.rs:29-34).
        return [
            [field.new_element(cell & _U64_MASK) for cell in row]
            for row in self.trace
        ]

    @staticmethod
    def fibonacci(length: int) -> "Trace":
        """Single-column a,b <- b,a+b from (1,1) (trace.rs:36-49)."""
        rows = []
        a, b = 1, 1
        for _ in range(length):
            rows.append([a])
            a, b = b, a + b
        return Trace(rows)
