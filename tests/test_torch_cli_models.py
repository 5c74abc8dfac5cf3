"""The port's command line against stark_tpu's for square and cube: each
model's proof file at T=64 byte-equal to the one ``stark_tpu.__main__.main``
writes, and accepted by both CLIs' verify (tests/test_torch_cli.py holds
fib, fib2 and the other cases, tests/test_torch_cli_mds.py mds: the files
split the stark_tpu proves' XLA compiles on the CPU, ~20-35 s each)."""

import pytest

from test_torch_cli import proof_file_equals_stark_tpu


@pytest.mark.parametrize("model", ["square", "cube"])
def test_proof_file_equals_stark_tpu(tmp_path, model, capsys):
    proof_file_equals_stark_tpu(tmp_path, model)
    capsys.readouterr()
