"""Device ms a batch of the operations launched inside the port's
``amt.transformer`` spans: hFT-Transformer's three stacks (the frequency
encoder, the frequency decoder, the time encoder), their projections,
attention, feed-forwards and LayerNorms."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.transformer')
