"""kernels.stream_roofline: the card's least time for the work of the push
engines' passes (portbench/work.py) over their device time, in %."""

from portbench import record


def read(rec):
    return record.roofline(rec, ("stream_encode", "stream_decode"))
