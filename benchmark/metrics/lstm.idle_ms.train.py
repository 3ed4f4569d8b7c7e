"""Device idle ms a step in the gaps that open while the latest-started
``amt.`` span open at the gap's start, on any host thread, is ``amt.lstm``
or ``amt.lstm.backward``."""

from benchmark import program_spans


def read(record):
    return program_spans.idle_ms(record, 'amt.lstm', 'amt.lstm.backward')
