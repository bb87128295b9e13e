"""device.idle_share.dec: share (%) of the decode calls' wall with no kernel or
copy on the card, the mean over the cards."""

from portbench import record


def read(rec):
    return record.idle_share(rec, ("decode",))
