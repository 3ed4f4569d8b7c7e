"""Seconds from the process's start to the window's: imports, the kernels'
build where it is not cached, weights and traffic on the device, the
warm-up of the cell's shapes (host clock)."""


def read(record):
    return record.setup_s
