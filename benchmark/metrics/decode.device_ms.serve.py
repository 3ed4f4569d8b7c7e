"""Device ms a batch of the operations launched inside the port's
``amt.decode`` span: the device decode after the model's forward (sigmoid
and threshold, or the argmax and local one-hot, then
``notes_on_device``)."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.decode')
