"""Analytic model FLOPs of TabCNN from its configuration.

Counted from the widths alone: three 3x3 VALID convolutions, the dense
layer and the softmax-group head, two operations a multiply-add. Serving
runs the whole-sequence forward (one conv stack over the clip's padded
image); training runs the recipe's windowed forward (one stack a frame's
window) and counts three forwards a step. Elementwise work, the pool, the
features and the decode are not counted.
"""


def _widths(config):
    c = config['model_complexity']
    return 32 * c, 64 * c, 128 * c


def _dense(config):
    nf1, nf2, emb = _widths(config)
    bins, width = config['n_bins'], config['frame_width']
    features = nf2 * ((bins - 6) // 2) * ((width - 6) // 2)
    classes = config['num_strings'] * (config['num_frets'] + 2)

    return 2 * features * emb + 2 * emb * classes


def forward_flops(config, batch, frames):
    """FLOPs of one whole-sequence forward over ``batch`` clips of
    ``frames`` frames."""

    nf1, nf2, _ = _widths(config)
    bins, width = config['n_bins'], config['frame_width']
    cols = frames + width - 1
    convs = 2 * 9 * (nf1 * (bins - 2) * (cols - 2) +
                     nf1 * nf2 * (bins - 4) * (cols - 4) +
                     nf2 * nf2 * (bins - 6) * (cols - 6))

    return float(batch * (convs + frames * _dense(config)))


def step_flops(config, batch, frames):
    """FLOPs of one training step of the windowed forward: three."""

    nf1, nf2, _ = _widths(config)
    bins, width = config['n_bins'], config['frame_width']
    window = 2 * 9 * (nf1 * (bins - 2) * (width - 2) +
                      nf1 * nf2 * (bins - 4) * (width - 4) +
                      nf2 * nf2 * (bins - 6) * (width - 6))

    return 3.0 * batch * frames * (window + _dense(config))


def wavelet_lengths(config):
    """Each CQT bin's wavelet length: Q sr / f, floored, made odd."""

    import numpy as np

    freqs = 440.0 * 2.0 ** ((config['fmin_midi'] - 69) / 12.0) * 2.0 ** (
        np.arange(config['n_bins']) / config['bins_per_octave'])
    alpha = 2.0 ** (1.0 / config['bins_per_octave']) - 1
    lengths = np.floor(config['sample_rate'] / (alpha * freqs)).astype(int)

    return lengths + 1 - lengths % 2


def features_cost(config, batch, num_samples):
    """(flops, bytes) of the CQT stage of one batch."""

    from .kernels import cqt_stage_cost

    return cqt_stage_cost(batch, num_samples, config['hop_length'],
                          wavelet_lengths(config))


def recurrences(config, batch, frames, size, train):
    """TabCNN runs no recurrence."""

    return []
