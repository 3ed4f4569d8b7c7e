"""Analytic model FLOPs of the High-resolution Piano Transcription note
model, and the least work of kernel G's launches, from its configuration.

Counted from the widths alone: the 3x3 convolutions, ``fc5``, the GRUs'
input and recurrent products and the Linear heads, two operations a
multiply-add. Elementwise work, the features and the decode are not
counted. :func:`gru_scan_cost` is a frozen copy of ``ops/gru_kernel.py``'s
(a test holds them equal).
"""


def _conv_flops(config):
    """A frame of one stack's convolutions: each block's two 3x3 convs at
    its input width (the pool halves it after the block)."""

    width = config['n_mels']
    channels = 1
    flops = 0
    for out in config['conv_channels']:
        flops += 2 * 9 * (channels * out + out * out) * width
        channels = out
        width //= 2

    return flops, channels * width


def _bigru_flops(config, dim_in, layers):
    hidden = config['gru_units']
    flops = 0
    for layer in range(layers):
        width = dim_in if layer == 0 else 2 * hidden
        flops += 2 * (2 * width * 3 * hidden + 2 * hidden * 3 * hidden)

    return flops


def forward_flops(config, batch, frames):
    """FLOPs of one forward over ``batch`` clips of ``frames`` frames."""

    keys, hidden, fc5 = (config['num_keys'], config['gru_units'],
                         config['fc5_dim'])
    convs, flat = _conv_flops(config)
    stack = (convs + 2 * flat * fc5 +
             _bigru_flops(config, fc5, config['gru_layers']) +
             2 * 2 * hidden * keys)
    conditioning = (_bigru_flops(config, 2 * keys, 1) +
                    _bigru_flops(config, 3 * keys, 1) +
                    2 * 2 * 2 * hidden * keys)

    return float(batch * frames * (len(config['heads']) * stack +
                                   conditioning))


def features_cost(config, batch, num_samples):
    """(flops, bytes) of the mel stage of one batch."""

    from .kernels import mel_stage_cost

    return mel_stage_cost(batch, num_samples, config['n_fft'],
                          config['hop_length'], config['n_mels'])


def gru_scan_cost(batch, frames, hidden, size, groups=1):
    """One launch of kernel G over ``groups`` sequences at ``size`` bytes a
    value: the recurrent product, 2 H 3H operations a row and step; xw and
    W_h read and h written once, the float32 b_hn read."""

    rows = batch * frames
    flops = 2.0 * rows * hidden * 3 * hidden
    num_bytes = size * (rows * 3 * hidden + hidden * 3 * hidden +
                        rows * hidden) + 4 * hidden

    return groups * flops, float(groups * num_bytes)


def gru_launches(config, batch, frames, size):
    """(flops, bytes) of each launch of kernel G in one forward: the four
    stacks' first layers (8 directions), their second layers, the onset
    conditioning and the frame conditioning (2 each)."""

    hidden = config['gru_units']
    stacks = len(config['heads'])

    return ([gru_scan_cost(batch, frames, hidden, size, 2 * stacks)] *
            config['gru_layers'] +
            [gru_scan_cost(batch, frames, hidden, size, 2)] * 2)
