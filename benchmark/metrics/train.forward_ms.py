"""Device ms a step of the operations launched inside the port's
``amt.train.forward`` span: the train step's forward and losses."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.train.forward')
