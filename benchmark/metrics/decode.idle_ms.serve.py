"""Device idle ms a batch in the gaps that open while the host decodes
notes: the latest-started ``amt.`` span open at the gap's start is
``amt.serving.decode_host`` or lies inside it."""

from benchmark import program_spans


def read(record):
    return program_spans.idle_ms(record, 'amt.serving.decode_host')
