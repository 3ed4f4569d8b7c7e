"""Model FLOPs utilization of training (%): the analytic step FLOPs
(``costs/<family>.py``, three forwards) of every step of the traced run's
window, over the window's seconds, over the card's peak in the trained
dtype."""

from benchmark import readers


def read(record):
    if 'steps' not in record.work:
        return None
    flops = record.work['steps'] * record.costs.step_flops(
        record.config, record.shape['batch'], record.shape['frames'])

    return readers.mfu(record, flops, record.config['train_dtype'])
