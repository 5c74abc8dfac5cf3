"""Set-up: from the process's start to its first timed proof (the imports,
the card's context, the kernels' builds on a first run, the prover's tables,
the witness made in set-up, the warm-up proves and their graph captures)."""


def read(rec, metric, context):
    return rec.setup_s
