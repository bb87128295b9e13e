"""pipeline.host_stage_share.enc: share (%) of the encode calls' wall in
the host staging of the lossy encode's upload frames: the native pass that
casts them from the track into the upload's buffer (`enc:stage`), or the
float64 gather and the cast of the route before it (`enc:gather`,
`enc:host-conv`)."""

from portbench import record

STAGES = ("enc:gather", "enc:host-conv", "enc:stage")


def read(rec):
    return record.stage_share(rec, ("encode",), STAGES)
