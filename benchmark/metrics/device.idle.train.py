"""The share (%) of the traced training stretch, from its first device
operation to its last, in which no operation ran on the device."""

from benchmark import readers


def read(record):
    return readers.idle(record)
