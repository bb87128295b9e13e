"""device.idle_share.stream: share (%) of the push engines' passes with no
kernel or copy on the card."""

from portbench import record


def read(rec):
    return record.idle_share(rec, ("stream_encode", "stream_decode"))
