"""The plain reference: a STARK prover in plain torch (prover.py) and the
statements it proves (airs/).  Nothing here imports the measured program."""
