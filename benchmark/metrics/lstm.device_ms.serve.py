"""Device ms a batch of the operations launched inside the port's
``amt.lstm`` spans: the LSTM layers' input projections and their
recurrences (kernel B)."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.lstm')
