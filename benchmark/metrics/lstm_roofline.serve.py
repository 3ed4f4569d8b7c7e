"""The serving recurrences' share of their roofline: the least time of
the forward's LSTM launches (kernel B, ``costs/kernels.py`` ``scan_cost``
in the served dtype) over the device time of the LSTM kernels launched
inside ``bench.lm``, a batch."""

from benchmark import readers


def read(record):
    config = record.config
    size = 2 if config['serve_dtype'] == 'bfloat16' else 4
    costs = record.costs.recurrences(config, record.shape['batch'],
                                     record.shape['frames'], size,
                                     train=False)

    return readers.roofline(record, costs,
                            readers.PRECISION[config['serve_dtype']],
                            readers.lstm_seconds(record, under='bench.lm'))
