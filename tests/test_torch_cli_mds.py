"""The port's command line against stark_tpu's for MdsSquareAir: the proof
file at T=64 (from the device witness, as both CLIs prove it by default)
byte-equal to the one ``stark_tpu.__main__.main`` writes, and accepted by
both CLIs' verify (see tests/test_torch_cli.py)."""

from test_torch_cli import proof_file_equals_stark_tpu


def test_proof_file_equals_stark_tpu(tmp_path, capsys):
    proof_file_equals_stark_tpu(tmp_path, "mds")
    capsys.readouterr()
