"""The witness layer's batch input: the program's span ``batch.stack``
(BatchStarkProver's copies of the B witnesses into the (B, c, T) input),
a proof's mean over the traced window; None where no batch ran."""

from benchmark.metrics._spans import ms_per_proof


def read(rec, metric, context):
    return ms_per_proof(rec, ("batch.stack",))
