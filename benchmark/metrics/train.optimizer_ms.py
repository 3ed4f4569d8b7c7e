"""Device ms a step of the kernels launched under the ``Optimizer.step#``
range that ``torch.optim`` records."""

from benchmark import readers


def read(record):
    return readers.kernel_ms(record,
                             lambda name: name.startswith('Optimizer.step#'))
