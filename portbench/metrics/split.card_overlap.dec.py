"""split.card_overlap.dec: the cards' summed busy time over the union of their
busy intervals in the decode calls; 1.0 means no two cards ever ran at once."""

from portbench import record


def read(rec):
    return record.card_overlap(rec, ("decode",))
