"""device.idle_share.enc: share (%) of the encode calls' wall with no kernel or
copy on the card, the mean over the cards."""

from portbench import record


def read(rec):
    return record.idle_share(rec, ("encode",))
