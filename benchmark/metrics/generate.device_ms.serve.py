"""Device ms a batch of the operations launched inside the port's
``amt.generate`` spans: a greedy decode's cross-attention key and value
projections and every step's decoder layers, logits, argmax and stop
test."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.generate')
