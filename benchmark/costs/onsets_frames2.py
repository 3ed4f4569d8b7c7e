"""Analytic model FLOPs of Onsets & Frames 2 from its configuration.

Counted from the widths alone: the 3x3 convolutions, the dense layers, the
LSTMs' input and recurrent products and the logistic heads, two operations
a multiply-add. A training step counts three forwards (forward, and the
backward's two products a layer) and no recomputation. Elementwise work,
the features and the decode are not counted.
"""


def forward_flops(config, batch, frames):
    """FLOPs of one forward over ``batch`` clips of ``frames`` frames."""

    c = config['model_complexity']
    mels = config['n_mels']
    keys = config['num_keys']
    heads = len(config['heads'])
    nf1, nf3 = 16 * c, 32 * c
    dim_am = 256 * c
    hidden = 128 * (c - 1)

    stack = 2 * 9 * (1 * nf1 * mels + nf1 * nf1 * mels +
                     nf1 * nf3 * (mels // 2))
    stack += 2 * nf3 * (mels // 4) * dim_am

    def bilstm(dim_in):
        return 2 * (2 * dim_in * 4 * hidden + 2 * hidden * 4 * hidden)

    # Onset and offset language models on the acoustic embeddings, the
    # refinement over the heads' logits
    lms = (heads - 1) * bilstm(dim_am) + bilstm(heads * keys)
    outs = 2 * dim_am * keys + heads * 2 * (2 * hidden) * keys

    return float(batch * frames * (heads * stack + lms + outs))


def step_flops(config, batch, frames):
    """FLOPs of one training step: three forwards."""

    return 3.0 * forward_flops(config, batch, frames)


def features_cost(config, batch, num_samples):
    """(flops, bytes) of the mel stage of one batch."""

    from .kernels import mel_stage_cost

    return mel_stage_cost(batch, num_samples, config['n_fft'],
                          config['hop_length'], config['n_mels'])


def recurrences(config, batch, frames, size, train):
    """(flops, bytes) of each LSTM kernel launch of one forward (kernel B,
    ``size`` bytes a value) or one training step (kernels E and F): two
    directions of each BiLSTM."""

    from .kernels import bptt_cost, scan_cost

    hidden = config['lstm_units']
    launches = 2 * len(config['heads'])
    if not train:
        return [scan_cost(batch, frames, hidden, size)] * launches

    return ([scan_cost(batch, frames, hidden, size, residuals=True)] *
            launches + [bptt_cost(batch, frames, hidden, size)] * launches)
