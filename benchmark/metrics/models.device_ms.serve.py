"""Device ms a batch of the kernels launched inside the model's forward
(``bench.model``, from hooks on the model object), without those of its
language models' layers (``bench.lm``)."""

from benchmark import readers


def read(record):
    return readers.kernel_ms(record, lambda name: name == 'bench.model',
                             exclude=lambda name: name == 'bench.lm')
