"""pipeline.host_emit_share.dec: share (%) of the decode calls' wall in
`batch_decode`'s emit of the PCM: the overlap fragments' heads and the join
of the runs' output."""

from portbench import record

STAGES = ("dec:emit",)


def read(rec):
    if not any(name in STAGES for name, _, _ in rec.spans):
        return None          # a program without the span
    return record.stage_share(rec, ("decode",), STAGES)
