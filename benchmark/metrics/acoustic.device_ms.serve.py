"""Device ms a batch of the operations launched inside the port's
``amt.acoustic`` spans: the acoustic conv stacks (O&F2's three, with
their dense projections) or TabCNN's conv stack and max-pool, without the
language models, the heads and the glue between them."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.acoustic')
