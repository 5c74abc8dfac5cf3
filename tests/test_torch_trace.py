"""The port's ``Trace`` (stark_tpu_torch/models/trace.py) against stark_tpu's,
with the reference's quirks: ``to_field_elements`` casts i128 to u64 into
unreduced field elements, and ``get_row`` / ``get`` give None out of bounds
and for negative indices.  Tolerance zero."""

import numpy as np
import pytest

from stark_tpu_torch import FiniteField, Trace

# Fibonacci lengths around the u64 wrap: F(93) is the last value below 2^64.
LENGTHS = [1, 2, 10, 64, 92, 93, 94, 95, 130]


def _pair(rows):
    from stark_tpu.models.trace import Trace as JTrace

    return Trace(rows), JTrace(rows)


def _cells(trace, field):
    return [[fe.value for fe in row] for row in trace.to_field_elements(field)]


@pytest.mark.parametrize("length", LENGTHS)
def test_fibonacci_matches_stark_tpu(length):
    from stark_tpu.field import FiniteField as JField
    from stark_tpu.models.trace import Trace as JTrace

    ours, theirs = Trace.fibonacci(length), JTrace.fibonacci(length)
    assert ours.trace == theirs.trace
    assert len(ours) == len(theirs) == length
    assert ours.num_columns == theirs.num_columns == 1
    assert ours.get_col(0) == theirs.get_col(0)
    got = _cells(ours, FiniteField())
    assert got == _cells(theirs, JField())
    # The cast keeps values unreduced (below 2^64, not below p).
    if length > 45:
        assert max(v for row in got for v in row) >= FiniteField().modulus()


def _seeded_rows(seed):
    """Rows of two columns with values of every size an i128 holds,
    negative ones included."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(12):
        bits = int(rng.integers(1, 128))
        v = int(rng.integers(0, 1 << 62)) << max(bits - 62, 0)
        rows.append([v if rng.integers(2) else -v, (1 << 64) + int(rng.integers(0, 99))])
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_to_field_elements_casts_like_stark_tpu(seed):
    from stark_tpu.field import FiniteField as JField

    ours, theirs = _pair(_seeded_rows(seed))
    assert _cells(ours, FiniteField()) == _cells(theirs, JField())
    assert all(v < 1 << 64 for row in _cells(ours, FiniteField()) for v in row)


@pytest.mark.parametrize("seed", range(2))
def test_reads_match_stark_tpu_in_and_out_of_bounds(seed):
    ours, theirs = _pair(_seeded_rows(seed))
    for i in range(-3, len(ours) + 3):
        assert ours.get_row(i) == theirs.get_row(i)
        for j in range(-2, 4):
            assert ours.get(i, j) == theirs.get(i, j)
    assert ours.get_row(-1) is None and ours.get(0, -1) is None
    assert ours.get_row(len(ours)) is None and ours.get(0, 2) is None
    for j in range(2):
        assert ours.get_col(j) == theirs.get_col(j)


def test_rows_are_copied():
    rows = [[1, 2], [3, 4]]
    trace = Trace(rows)
    rows[0][0] = 99
    assert trace.get(0, 0) == 1
