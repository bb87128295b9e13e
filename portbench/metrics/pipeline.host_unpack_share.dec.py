"""pipeline.host_unpack_share.dec: share (%) of the decode calls' wall in the
pipeline's host parsing, unpacking and conversion stages."""

from portbench import record

STAGES = ("dec:parse", "dec:unpack", "dec:host-conv")


def read(rec):
    return record.stage_share(rec, ("decode",), STAGES)
