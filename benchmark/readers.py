"""Arithmetic the metric readers (``metrics/<name>.py``) share.

A reader takes a :class:`harness.Record` and returns its metric's value,
or None where the record holds nothing to read (no trace, no such kernel
or range, a card the peak table does not know): the metric is then left
out of the line, never given as 0.
"""

from .costs.kernels import least_seconds

PRECISION = {'bfloat16': 'bf16', 'float32': 'float32'}


def per_item(record, seconds):
    """Seconds over the traced stretch -> seconds a batch or step."""

    if record.trace is None or seconds is None or not record.trace.items:
        return None

    return seconds / record.trace.items


def roofline(record, costs, precision, seconds):
    """100 x the least time of ``costs`` ((flops, bytes) pairs) over
    ``seconds``, the device time they took, at the card's peak for
    ``precision``."""

    if record.peaks is None or not seconds or not costs:
        return None
    rates, bandwidth = record.peaks
    least = sum(least_seconds(flops, num_bytes, rates[precision], bandwidth)
                for flops, num_bytes in costs)

    return 100.0 * least / seconds


def lstm_seconds(record, under=None):
    """Device seconds a batch or step of the LSTM kernels (B, E, F) of
    the traced stretch, under host ranges named ``under`` if given."""

    if record.trace is None:
        return None

    def lstm(name):
        return 'lstm_scan' in name or 'lstm_bptt' in name

    if under is None:
        kernels = record.trace.device_kernels(lstm)
    else:
        kernels = [(name, us) for name, us in record.trace.kernels_under(
            lambda name: name == under) if lstm(name)]
    if not kernels:
        return None

    return per_item(record, sum(us for _, us in kernels) * 1e-6)


def kernel_ms(record, match, exclude=lambda name: False):
    """Device ms a batch or step of the kernels launched under host
    ranges that ``match`` accepts."""

    if record.trace is None:
        return None
    seconds = per_item(record, record.trace.kernel_seconds(match, exclude))

    return None if seconds is None else 1e3 * seconds


def idle(record):
    """100 x the share of the traced window in which no device operation
    ran."""

    if record.trace is None:
        return None
    measured = record.trace.busy()
    if measured is None or measured[1] <= 0:
        return None
    busy, window, _ = measured

    return 100.0 * (1.0 - busy / window)


def mfu(record, flops, dtype):
    """100 x the model FLOPs of all the window's work over all its time,
    over the card's peak in the configuration's dtype."""

    if record.peaks is None or record.trace is None or not flops:
        return None
    rates, _ = record.peaks

    return 100.0 * flops / record.window_s / rates[PRECISION[dtype]]
