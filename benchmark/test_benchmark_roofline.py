"""The rooflines' bytes at each cell's shapes, pinned, and a share that
never reads 0 where there is nothing to read."""

from __future__ import annotations

import pytest

from benchmark import harness as H
from benchmark import roofline
from benchmark.metrics import roofline_share
from benchmark.reference import prover as R


def shape(name):
    cell = H.load_cell(name)
    st = R.Statement(cell.reference_air, cell.trace_length, cell.config["blowup"],
                     cell.config["num_colinearity_tests"])
    return H.shape(cell, R.Domain(st).fri_rounds(st.num_colinearity_tests))


#: Bytes a proof at each cell's shape, worked out by hand from each file's
#: docstring: T=2^21 (N=2^23, c=1, 64 tests: 15 FRI rounds, down to 256
#: values).
PINNED = {
    "fib21.latency": {"lde": 41943040, "compose": 67108864, "witness": 8388608},
}


def test_rounds_and_shapes():
    s = shape("fib21.latency")
    assert (s["T"], s["N"], s["c"], s["rounds"], s["tests"], s["frame"]) == (
        1 << 21, 1 << 23, 1, 15, 64, 3)


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_pinned_bytes(cell):
    s, mods = shape(cell), roofline.kernels()
    for name, want in PINNED[cell].items():
        assert mods[name].work(s)["bytes"] == want


def test_merkle_and_fold_bytes():
    s, mods = shape("fib21.latency"), roofline.kernels()
    N = 1 << 23
    tree = lambda w, c=1: 4 * c * w + 32 * (2 * w - 1)  # noqa: E731
    assert mods["merkle"].work(s)["bytes"] == tree(N) + sum(tree(N >> r) for r in range(15))
    assert mods["fold"].work(s)["bytes"] == sum(6 * (N >> r) for r in range(14))
    # about 1.9 GB: 0.57 ms at 3.35 TB/s
    assert 0.5e-3 < roofline.least_seconds(mods["merkle"], s) < 0.6e-3


def test_every_file_names_kernels_and_work():
    for name, mod in roofline.kernels().items():
        assert mod.KERNELS and all(k.startswith("stark_") for k in mod.KERNELS), name
        assert mod.work(shape("fib21.latency"))["bytes"] > 0


def test_share_reads_nothing_without_matching_kernels():
    rec = H.Record(traced_proofs=10, traces=[{"busy_s": 1.0, "window_s": 2.0,
                                                "kernels": {"ncclDevKernel_AllGather": 1.0},
                                                "gaps": {}}])
    assert roofline_share.read(rec, {}, {"shape": shape("fib21.latency")}) is None


def test_share_below_100_when_each_kernel_takes_its_least_time_or_more():
    s, mods = shape("fib21.latency"), roofline.kernels()
    kernels = {mods[n].KERNELS[0] + "_kernel": roofline.least_seconds(mods[n], s) * 10 * 1.0001
               for n in mods}
    rec = H.Record(traced_proofs=10, traces=[{"busy_s": 1.0, "window_s": 2.0,
                                                "kernels": kernels, "gaps": {}}])
    share = roofline_share.read(rec, {}, {"shape": s})
    assert 99.0 < share < 100.0
