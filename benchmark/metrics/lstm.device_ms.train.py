"""Device ms a step of the operations launched inside the port's
``amt.lstm`` spans (the LSTM layers' projections and kernel E) and
``amt.lstm.backward`` spans (kernel F, dW_h and d(xw), on autograd's
thread)."""

from benchmark import program_spans


def read(record):
    return program_spans.device_ms(record, 'amt.lstm', 'amt.lstm.backward')
