"""The greedy decode's share of its roofline: the least time of a
forward's work under ``amt.generate`` (``costs/<family>.py``
``generate_cost``: the cross-attention keys and values, then each step's
operations at the card's peak in the served dtype or its bytes at its
bandwidth, whichever is longer) over the device time of every operation
launched inside the port's ``amt.generate`` spans, a batch."""

from benchmark import readers


def read(record):
    if record.trace is None or not hasattr(record.costs, 'generate_cost'):
        return None
    seconds = readers.per_item(record, record.trace.kernel_seconds(
        lambda name: name == 'amt.generate'))
    config = record.config
    size = 2 if config['serve_dtype'] == 'bfloat16' else 4
    costs = record.costs.generate_cost(config, record.shape['batch'],
                                       record.shape['frames'], size)

    return readers.roofline(record, costs,
                            readers.PRECISION[config['serve_dtype']], seconds)
