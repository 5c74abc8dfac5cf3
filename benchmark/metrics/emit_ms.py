"""The host's emission: PhaseTimer's ``fri_fetch`` + ``fri_emit`` of each
proof of the traced run (the read's wait, the transcripts' replay, the
proof's bytes), the timer synchronizing at each phase's end; their mean."""


def read(rec, metric, context):
    got = rec.spans.get("emit_s")
    return sum(got) / len(got) * 1e3 if got else None
