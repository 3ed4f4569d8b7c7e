"""Model FLOPs utilization of serving (%): the analytic forward FLOPs
(``costs/<family>.py``) of every clip served in the traced run's window,
over the window's seconds, over the card's peak in the served dtype."""

from benchmark import readers


def read(record):
    if 'clips' not in record.work:
        return None
    flops = record.costs.forward_flops(record.config, record.work['clips'],
                                       record.shape['frames'])

    return readers.mfu(record, flops, record.config['serve_dtype'])
