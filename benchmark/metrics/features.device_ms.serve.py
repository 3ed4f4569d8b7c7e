"""Device ms a batch of the operations launched inside the port's
``amt.features`` span (the feature module's ``process``: kernel A, the
mel projection and the dB scaling, or kernel D and the dB scaling)."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.features')
