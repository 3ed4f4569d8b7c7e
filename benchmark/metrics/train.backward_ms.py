"""Device ms a step of the kernels launched under autograd's
``evaluate_function`` ranges (the backward pass)."""

from benchmark import readers


def read(record):
    return readers.kernel_ms(
        record,
        lambda name: name.startswith('autograd::engine::evaluate_function'))
