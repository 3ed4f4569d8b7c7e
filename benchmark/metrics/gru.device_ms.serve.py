"""Device ms a batch of the operations launched inside the port's
``amt.gru`` spans: the GRU layers' input projections and their recurrences
(kernel G)."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.gru')
