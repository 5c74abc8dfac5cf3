"""The host emission's transcript replay: the program's spans
``stark.prefix_replay`` (the trace roots and the constraint challenges),
``fri.chain_replay`` (the rounds' roots and alphas, the last codeword) and
``fri.sample_replay`` (the query indices drawn again), each checked
against the card's values; a proof's mean over the traced window."""

from benchmark.metrics._spans import ms_per_proof


def read(rec, metric, context):
    return ms_per_proof(rec, ("stark.prefix_replay", "fri.chain_replay", "fri.sample_replay"))
