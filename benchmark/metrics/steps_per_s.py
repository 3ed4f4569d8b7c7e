"""Optimizer steps completed in the window (it closes with a synchronize)
over the window's seconds (host clock)."""


def read(record):
    if 'steps' not in record.work or record.window_s <= 0:
        return None

    return record.work['steps'] / record.window_s
