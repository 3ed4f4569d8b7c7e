"""The training recurrences' share of their roofline: the least time of
a step's forward-with-residuals and BPTT launches (kernels E and F,
``costs/kernels.py`` ``scan_cost`` and ``bptt_cost`` in the trained
dtype) over the device time of the step's LSTM kernels."""

from benchmark import readers


def read(record):
    config = record.config
    size = 2 if config['train_dtype'] == 'bfloat16' else 4
    costs = record.costs.recurrences(config, record.shape['batch'],
                                     record.shape['frames'], size, train=True)

    return readers.roofline(record, costs,
                            readers.PRECISION[config['train_dtype']],
                            readers.lstm_seconds(record))
