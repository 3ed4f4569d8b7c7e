"""The feature stage's share of its roofline: the least time of the
stage's work (``costs/<family>.py`` ``features_cost``: kernel A's FFT and
the mel projection, or the FFT CQT, in float32) over the device time of
the kernels launched inside ``bench.features`` (the benchmark's range
around the feature module's ``process``), a batch."""

from benchmark import readers


def read(record):
    seconds = readers.per_item(record, record.trace and
                               record.trace.kernel_seconds(
                                   lambda name: name == 'bench.features'))
    cost = record.costs.features_cost(record.config, record.shape['batch'],
                                      record.shape['num_samples'])

    return readers.roofline(record, [cost], 'float32', seconds)
