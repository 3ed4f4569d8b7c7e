"""The serving GRUs' share of their roofline: the least time of the
forward's launches of kernel G (``costs/<family>.py`` ``gru_launches``, in
the served dtype, at the card's peaks) over the device time of the
``gru_scan`` kernels launched inside the port's ``amt.gru`` spans, a
batch."""

from benchmark import readers


def read(record):
    if record.trace is None or not hasattr(record.costs, 'gru_launches'):
        return None
    kernels = [us for name, us in record.trace.kernels_under(
        lambda name: name == 'amt.gru') if 'gru_scan' in name]
    if not kernels:
        return None
    config = record.config
    size = 2 if config['serve_dtype'] == 'bfloat16' else 4
    costs = record.costs.gru_launches(config, record.shape['batch'],
                                      record.shape['frames'], size)

    return readers.roofline(record, costs,
                            readers.PRECISION[config['serve_dtype']],
                            readers.per_item(record, sum(kernels) * 1e-6))
