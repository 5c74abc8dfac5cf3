"""The port's command line (``python -m stark_tpu_torch``, in-process through
``stark_tpu_torch.__main__.main``) against stark_tpu's: tests/test_cli.py's
cases run on the port with ``--device cpu``; the proof file of each model
at T=64 byte-equal to the one ``stark_tpu.__main__.main`` writes (fib and
fib2 here, square and cube in tests/test_torch_cli_models.py, mds in
tests/test_torch_cli_mds.py: each stark_tpu prove compiles its own XLA
graphs on the CPU, ~20-35 s); the host witness giving the device witness's
bytes; and ``prove`` and ``bench`` without a card and without ``--device
cpu`` exiting non-zero."""

import hashlib

import pytest
import torch

from stark_tpu_torch.__main__ import main
from torch_port_support import cuda_device  # noqa: F401

ARGS = ["--trace-length", "64", "--queries", "4"]
CPU = ["--device", "cpu"]


def test_demo_reference_parity(capsys):
    # main.rs:8-14: P = 998244353, 8th primitive root via g=3
    # (ff.rs:215-223: g^((p-1)/8)), empty polynomial.
    assert main(["demo"]) == 0
    out = capsys.readouterr().out
    assert "p = 998244353" in out
    root = pow(3, (998244353 - 1) // 8, 998244353)
    assert f"8th primitive root of unity: {root}" in out
    assert "empty polynomial" in out


def test_prove_verify_inspect_roundtrip(tmp_path, capsys):
    proof_file = str(tmp_path / "proof.bin")
    args = ["--trace-length", "64", "--blowup", "4", "--queries", "4"]
    assert main(["prove", *args, *CPU, "--out", proof_file]) == 0
    assert main(["verify", proof_file, *args]) == 0
    assert "ACCEPT" in capsys.readouterr().out

    assert main(["inspect", proof_file]) == 0
    out = capsys.readouterr().out
    assert "MerkleRoot" in out and "MerklePath" in out

    # Tampered bytes must REJECT (exit code 1).
    data = bytearray(open(proof_file, "rb").read())
    data[len(data) // 2] ^= 1
    bad = str(tmp_path / "bad.bin")
    open(bad, "wb").write(bytes(data))
    assert main(["verify", bad, *args]) == 1
    assert "REJECT" in capsys.readouterr().out


def test_unknown_command_rejected():
    with pytest.raises(SystemExit):
        main(["frobnicate"])
    with pytest.raises(SystemExit):
        main(["bench", "--trace-length", "64"])  # bench shows --quick and --device alone


def test_cli_model_selection(tmp_path, capsys):
    """--model reaches every registry entry; cube needs blowup 8 (loud
    exit 2 below it)."""
    proof_file = str(tmp_path / "p.bin")
    base = [*ARGS, "--out", proof_file, *CPU]
    assert main(["prove", "--model", "fib2", *base]) == 0
    assert main(["verify", proof_file, "--model", "fib2", *ARGS]) == 0
    # wrong model for the proof: must reject, not accept
    assert main(["verify", proof_file, "--model", "square", *ARGS]) == 1
    # cube below its minimum blowup: loud usage error
    assert main(["prove", "--model", "cube", *base, "--blowup", "4"]) == 2
    capsys.readouterr()


def test_prove_without_a_card_exits_nonzero(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "p.bin"
    assert main(["prove", *ARGS, "--out", str(out)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_bench_without_a_card_exits_nonzero(capsys):
    # ``bench`` runs on the card unless --device cpu asks otherwise: no
    # quiet fall-back, no JSON line.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert main(["bench", "--quick", "--device", "cuda"]) == 2
    got = capsys.readouterr()
    assert "no CUDA device" in got.err and got.out == ""


def _model_args(model):
    return ["--model", model, *ARGS, "--blowup", "8" if model == "cube" else "4"]


def prove_file(entry, tmp_path, model, *extra) -> bytes:
    """The bytes of the proof file ``entry`` (a CLI's ``main``) writes."""
    out = tmp_path / f"{entry.__module__}-{model}-{len(extra)}.bin"
    assert entry(["prove", *_model_args(model), *extra, "--out", str(out)]) == 0
    return out.read_bytes()


def proof_file_equals_stark_tpu(tmp_path, model) -> bytes:
    """The port's proof file of ``model`` at T=64 against stark_tpu's, byte
    for byte; both verify with either package's CLI."""
    from stark_tpu.__main__ import main as jmain

    ours = prove_file(main, tmp_path, model, *CPU)
    theirs = prove_file(jmain, tmp_path, model)
    assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(theirs).hexdigest()
    path = tmp_path / "ours.bin"
    path.write_bytes(ours)
    for entry in (main, jmain):
        assert entry(["verify", str(path), *_model_args(model)]) == 0
    return ours


@pytest.mark.parametrize("model", ["fib", "fib2"])
def test_proof_file_equals_stark_tpu(tmp_path, model, capsys):
    proof_file_equals_stark_tpu(tmp_path, model)
    capsys.readouterr()


@pytest.mark.parametrize("model", ["fib", "mds"])
def test_host_witness_gives_the_same_bytes(tmp_path, model, capsys):
    # fib and mds prove from a witness made on the device by default.
    device_witness = prove_file(main, tmp_path, model, *CPU)
    assert prove_file(main, tmp_path, model, *CPU, "--host-witness") == device_witness
    capsys.readouterr()


def test_host_witness_equals_stark_tpu_host_witness(tmp_path, capsys):
    from stark_tpu.__main__ import main as jmain

    assert prove_file(main, tmp_path, "fib", *CPU, "--host-witness") == \
        prove_file(jmain, tmp_path, "fib", "--host-witness")
    capsys.readouterr()


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["fib", "mds"])
def test_card_proof_file_equals_cpu(cuda_device, tmp_path, model, capsys):
    assert prove_file(main, tmp_path, model) == prove_file(main, tmp_path, model, *CPU)
    capsys.readouterr()
