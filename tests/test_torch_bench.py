"""The port's benchmark (stark_tpu_torch/bench.py, ``python -m
stark_tpu_torch bench``), the counterpart of the repo-root bench.py, run on
the CPU at tiny sizes (every kernel's plain version): one JSON line with
bench.py's metric, unit and every extras key; each key the median of its
runs, its count in ``timing_reps`` and its quantiles; a rejected proof
ending the run with a non-zero exit; the quantiles on a fake clock; and
the module importing neither jax nor stark_tpu.  Its numbers on the card
come from ``python -m stark_tpu_torch bench`` there."""

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest

from stark_tpu_torch import StarkVerifier
from stark_tpu_torch import bench

# Tiny sizes: every configuration runs, in a few seconds on the CPU.
TINY = dict(ntt=1 << 10, fold=1 << 10, leaf=1 << 10, row=1 << 8, prove_T=64, batch=2,
            batch_wide=3, pipe_batches=2, pipe_wide_batches=2, verify_batch=3, capstone_T=128,
            max_T=256, mds_T=64, mds_pipe_T=64, mds_batch=2, mds_pipe_batches=2, queries=4,
            runs=3, kernel_reps=2)
# bench.py's extras keys (bench.py:200-611), in its order; a quick run has
# the set-up and NTT ones.
SETUP_KEYS = ("backend", "device", "host_numpy_ntt_ms")
NTT_KEYS = ("ntt_ms", "ntt_lazy_ms", "ntt_best")
FULL_KEYS = ("fold_2e22_ms", "leaf_hash_Mlanes_per_s", "row_hash_c8_Mlanes_per_s",
             "prove_phases_ms", "prove_T2e14_s", "verify_T2e14_s", "proof_bytes_T2e14",
             "batch8_proofs_per_s", "pipeline_proofs_per_s", "pipeline_b32_proofs_per_s",
             "verify_batch8_proofs_per_s", "capstone_prove_T2e20_s",
             "capstone_verify_T2e20_s", "capstone_phases_ms", "capstone_proof_bytes",
             "max_prove_T2e21_s", "max_proof_bytes", "mds_e2e_T2e16_s", "mds_proof_bytes",
             "mds_pipeline_proofs_per_s")
RECORD_KEYS = ("timing_reps", "quantiles")
TIMED = ("ntt_ms", "ntt_lazy_ms", "fold_2e22_ms", "leaf_hash_Mlanes_per_s",
         "row_hash_c8_Mlanes_per_s", "prove_T2e14_s", "verify_T2e14_s", "batch8_proofs_per_s",
         "pipeline_proofs_per_s", "pipeline_b32_proofs_per_s", "verify_batch8_proofs_per_s",
         "capstone_prove_T2e20_s", "capstone_verify_T2e20_s", "max_prove_T2e21_s",
         "mds_e2e_T2e16_s", "mds_pipeline_proofs_per_s")


def _run_main(argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = bench.main(argv)
    return code, out.getvalue()


@pytest.fixture(scope="module")
def line():
    """The last line of ``bench --device cpu`` at TINY sizes, parsed."""
    saved = bench.SIZES
    bench.SIZES = {**saved, **TINY}
    try:
        code, out = _run_main(["--device", "cpu"])
    finally:
        bench.SIZES = saved
    assert code == 0
    return json.loads(out.strip().splitlines()[-1])


def test_the_line_has_bench_py_schema(line):
    assert line["metric"] == "NTT points/s/chip at 2^22" and line["unit"] == "points/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    keys = SETUP_KEYS + NTT_KEYS + FULL_KEYS + RECORD_KEYS
    assert set(line["extras"]) == set(keys)
    assert line["extras"]["backend"] == "cpu"
    assert line["extras"]["ntt_best"] in ("strict", "lazy")


def test_the_headline_is_the_best_transform(line):
    ex = line["extras"]
    best = min(ex["ntt_ms"], ex["ntt_lazy_ms"])
    assert line["value"] == pytest.approx(TINY["ntt"] / (best / 1e3), rel=1e-12)
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / (bench.N_NTT / (bench.HOST_NTT_BASELINE_MS / 1e3)), rel=1e-12)


@pytest.mark.parametrize("key", TIMED)
def test_each_key_is_the_median_of_its_runs(line, key):
    ex = line["extras"]
    q = ex["quantiles"][key]
    assert ex["timing_reps"][key] == TINY["runs"]
    assert ex[key] == q["median"] > 0
    assert q["min"] <= q["q1"] <= q["median"] <= q["q3"] <= q["max"]


def test_proof_sizes_and_phases(line):
    ex = line["extras"]
    for key in ("proof_bytes_T2e14", "capstone_proof_bytes", "max_proof_bytes",
                "mds_proof_bytes"):
        assert isinstance(ex[key], int) and ex[key] > 0
    assert ex["capstone_proof_bytes"] < ex["max_proof_bytes"]
    for key in ("prove_phases_ms", "capstone_phases_ms"):
        assert {"lde", "compose", "fri_commit", "fri_query"} <= set(ex[key])


def test_quick_times_the_headline_alone(monkeypatch):
    monkeypatch.setattr(bench, "SIZES", {**bench.SIZES, **TINY})
    code, out = _run_main(["--quick", "--device", "cpu"])
    got = json.loads(out.strip().splitlines()[-1])
    assert code == 0 and len(out.strip().splitlines()) == 1
    assert set(got["extras"]) == set(SETUP_KEYS + NTT_KEYS + RECORD_KEYS)


def test_a_rejected_proof_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(bench, "SIZES", {**bench.SIZES, **TINY})
    monkeypatch.setattr(StarkVerifier, "verify_batch", lambda self, proofs: [False] * len(proofs))
    code, out = _run_main(["--device", "cpu"])
    assert code == 1 and out == ""
    assert "rejected" in capsys.readouterr().err


class FakeClock:
    """A clock whose readings are ``times``, in order."""

    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


def test_quantiles_on_a_fake_clock():
    # Five calls after the warm-up, lasting 3, 1, 4, 1 and 5 s by the clock.
    starts = [0.0, 10.0, 20.0, 30.0, 40.0]
    lasting = [3.0, 1.0, 4.0, 1.0, 5.0]
    clock = FakeClock(t for s, d in zip(starts, lasting) for t in (s, s + d))
    calls = []
    got = bench.walls(lambda: calls.append(1), 5, clock=clock)
    assert got == lasting and len(calls) == 6
    assert bench.quantiles(got) == {"min": 1.0, "q1": 1.0, "median": 3.0, "q3": 4.0,
                                    "max": 5.0}
    assert bench.quantiles([2.0, 4.0]) == {"min": 2.0, "q1": 2.5, "median": 3.0, "q3": 3.5,
                                           "max": 4.0}
    assert bench.quantiles(np.arange(9.0))["q3"] == 6.0


def test_importing_bench_loads_neither_jax_nor_stark_tpu():
    code = ("import sys, stark_tpu_torch.bench, stark_tpu_torch.__main__; "
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'stark_tpu')])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
