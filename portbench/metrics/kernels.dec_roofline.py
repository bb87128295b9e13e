"""kernels.dec_roofline: the card's least time for the decode calls' work
(portbench/work.py) over the device time of those calls, in %."""

from portbench import record


def read(rec):
    return record.roofline(rec, ("decode",))
