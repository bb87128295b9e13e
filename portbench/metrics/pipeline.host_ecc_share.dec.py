"""pipeline.host_ecc_share.dec: share (%) of the decode calls' wall in the
pipeline's `dec:ecc` stage: the CRC check, parity strip and Reed-Solomon
repair of armored frames."""

from portbench import record

STAGES = ("dec:ecc",)


def read(rec):
    if not any(name in STAGES for name, _, _ in rec.spans):
        return None          # no armored frame decoded
    return record.stage_share(rec, ("decode",), STAGES)
