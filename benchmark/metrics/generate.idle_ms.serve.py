"""Device idle ms a batch in the gaps that open while the latest-started
``amt.`` span open at the gap's start, on any host thread, is
``amt.generate``: the decode loop's launches and its stop test."""

from benchmark import program_spans


def read(record):
    return program_spans.idle_ms(record, 'amt.generate')
