"""kernels.enc_roofline: the card's least time for the encode calls' work
(portbench/work.py) over the device time of those calls, in %."""

from portbench import record


def read(rec):
    return record.roofline(rec, ("encode",))
