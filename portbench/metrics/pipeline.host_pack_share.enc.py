"""pipeline.host_pack_share.enc: share (%) of the encode calls' wall in the
pipeline's host packing and framing stages."""

from portbench import record

STAGES = ("enc:pack", "enc:host-pack", "enc:frame")


def read(rec):
    return record.stage_share(rec, ("encode",), STAGES)
