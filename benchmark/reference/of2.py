"""Plain reference of Onsets & Frames 2 (Hawthorne et al., ICLR 2019,
arXiv:1810.12247) at the widths of ``configs/of2.json``.

HTK mel features; three acoustic stacks (pitch, onset, offset) of three 3x3
conv + batch-norm + ReLU blocks with a 1x2 max-pool over frequency after
the second and third, and a dense projection; bidirectional LSTMs over the
onset and offset embeddings; logistic heads; the refinement BiLSTM over
the heads' logits (onset and offset detached) gives the multi-pitch
logits. Training: dropout 0.25 after the pooled blocks and 0.5 after the
dense, batch statistics in the norms, binary cross-entropy of the
multi-pitch, onset and offset logits (averaged over frames, summed over
keys, averaged over the batch), Adam.

Parameters are named and laid out as the port's ``state_dict`` (OIHW conv
kernels, (out, in) dense weights, (H, 4H) recurrent kernels with the gates
i, f, g, o), because the same tensors are handed to both.
"""

import numpy as np
import torch

from . import plain

MULTIPITCH, ONSETS, OFFSETS = 'multi_pitch', 'onsets', 'offsets'


def _widths(config):
    c = config['model_complexity']
    return 16 * c, 32 * c, 256 * c, 128 * (c - 1)


def parameters(config):
    """(name, shape, init) of every parameter and norm statistic."""

    nf1, nf3, dim_am, hidden = _widths(config)
    mels, keys = config['n_mels'], config['num_keys']
    heads = config['heads']

    def kernel(name, shape, fan_in):
        return [(f'{name}.weight', shape, ('normal', 0.0, fan_in ** -0.5)),
                (f'{name}.bias', shape[:1], ('normal', 0.0, 0.05))]

    def norm(name, channels):
        return [(f'{name}.weight', (channels,), ('normal', 1.0, 0.1)),
                (f'{name}.bias', (channels,), ('normal', 0.0, 0.1)),
                (f'{name}.running_mean', (channels,), ('normal', 0.0, 0.1)),
                (f'{name}.running_var', (channels,), ('uniform', 0.5, 1.5))]

    def bilstm(name, dim_in):
        spec = []
        for side in ('fwd', 'bwd'):
            spec += [(f'{name}.recurrent_kernel_{side}', (hidden, 4 * hidden),
                      ('normal', 0.0, hidden ** -0.5))]
            spec += kernel(f'{name}.input_proj_{side}', (4 * hidden, dim_in),
                           dim_in)
        return spec

    def head(name, dim_in):
        return [(f'{name}.Dense_0.weight', (keys, dim_in),
                 ('normal', 0.0, dim_in ** -0.5)),
                (f'{name}.Dense_0.bias', (keys,), ('normal', -2.0, 0.05))]

    spec = []
    for name in heads:
        am = f'{name}_am'
        spec += kernel(f'{am}.Conv_0', (nf1, 1, 3, 3), 9)
        spec += norm(f'{am}.BatchNorm_0', nf1)
        spec += kernel(f'{am}.Conv_1', (nf1, nf1, 3, 3), 9 * nf1)
        spec += norm(f'{am}.BatchNorm_1', nf1)
        spec += kernel(f'{am}.Conv_2', (nf3, nf1, 3, 3), 9 * nf1)
        spec += norm(f'{am}.BatchNorm_2', nf3)
        spec += kernel(f'{am}.Dense_0', (dim_am, nf3 * (mels // 4)),
                       nf3 * (mels // 4))
    for name in heads[1:]:
        spec += bilstm(f'{name}_lm.FastBiLSTM_0', dim_am)
        spec += head(f'{name}_out', 2 * hidden)
    spec += head('pitch_out', dim_am)
    spec += bilstm('adjoin_lm.FastBiLSTM_0', len(heads) * keys)
    spec += head('adjoin_out', 2 * hidden)

    return spec


def features(audio, config, precision='float32'):
    return plain.mel_features(audio, config, precision)


def _acoustic(params, name, feats, precision, generator):
    """(B, 1, F, T) features -> (B, T, dim_am) embeddings of one stack."""

    x = feats.transpose(-1, -2)  # (B, 1, T, F)
    for block in range(3):
        prefix = f'{name}_am'
        x = plain.conv2d(x, params[f'{prefix}.Conv_{block}.weight'],
                         params[f'{prefix}.Conv_{block}.bias'], 1, precision)
        norm = f'{prefix}.BatchNorm_{block}'
        if generator is None:
            x = plain.batch_norm_eval(x, params[f'{norm}.weight'],
                                      params[f'{norm}.bias'],
                                      params[f'{norm}.running_mean'],
                                      params[f'{norm}.running_var'])
        else:
            x = plain.batch_norm_train(x, params[f'{norm}.weight'],
                                       params[f'{norm}.bias'])
        x = torch.relu(x)
        if block:
            x = torch.nn.functional.max_pool2d(x, (1, 2), stride=(1, 2))
            if generator is not None:
                x = plain.dropout(x, 0.25, generator)

    # (B, C, T, F/4) -> (B, T, F/4 * C), frequency-major
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], x.shape[2], -1)
    x = plain.linear(x, params[f'{name}_am.Dense_0.weight'],
                     params[f'{name}_am.Dense_0.bias'], precision)

    return x if generator is None else plain.dropout(x, 0.5, generator)


def forward(params, feats, config, precision='float32', generator=None):
    """Logits {multi_pitch, onsets, offsets}, each (B, T, keys). With a
    dropout ``generator`` the forward trains (batch statistics, dropout
    drawn in the stacks' order)."""

    heads = config['heads']
    emb = {name: _acoustic(params, name, feats, precision, generator)
           for name in heads}

    def out(name, x):
        return plain.linear(x, params[f'{name}.Dense_0.weight'],
                            params[f'{name}.Dense_0.bias'], precision)

    pitch = out('pitch_out', emb['pitch'])
    onsets = out('onset_out', plain.bilstm(emb['onset'], params,
                                           'onset_lm.FastBiLSTM_0', precision))
    offsets = out('offset_out', plain.bilstm(
        emb['offset'], params, 'offset_lm.FastBiLSTM_0', precision))
    joint = torch.cat([onsets.detach(), offsets.detach(), pitch], dim=-1)
    multi_pitch = out('adjoin_out', plain.bilstm(
        joint, params, 'adjoin_lm.FastBiLSTM_0', precision))

    return {MULTIPITCH: multi_pitch, ONSETS: onsets, OFFSETS: offsets}


def bce(logits, labels):
    """(B, T, K) logits against (B, K, T) labels: averaged over frames,
    summed over keys, averaged over the batch."""

    x = logits.transpose(-1, -2)
    loss = (-labels * torch.nn.functional.logsigmoid(x) -
            (1.0 - labels) * torch.nn.functional.logsigmoid(-x))

    return loss.mean(dim=-1).sum(dim=-1).mean()


def loss(params, batch, config, precision, generator):
    """The training loss of a batch ({features, multi_pitch, onsets,
    offsets}) with dropout from ``generator``."""

    logits = forward(params, batch['features'], config, precision, generator)

    return sum(bce(logits[key], batch[key])
               for key in (MULTIPITCH, ONSETS, OFFSETS))


def calibrate(params, audio, config, rates=((MULTIPITCH, 'adjoin_out', 0.03),
                                            (ONSETS, 'onset_out', 0.001))):
    """Shift the head biases in ``params`` so that ``rate`` of the probe's
    cells clear 0.5: each head's logit quantile at ``1 - rate`` comes off
    its bias. Float32, from one forward."""

    with torch.no_grad(), plain.exact_float32():
        logits = forward(params, features(audio, config), config)
        for key, head, rate in rates:
            shift = torch.quantile(logits[key].flatten(), 1.0 - rate)
            params[f'{head}.Dense_0.bias'] -= shift


def decode(logits, config):
    """The notes that the served maps of a clip hold: from the served
    (T, keys) multi-pitch and onset logits, thresholded at 0.5 after the
    logistic function computed as the served dtype computes it (``1 / (1
    + exp(-x))``, each operation rounded in that dtype, on the logits'
    device), each note a (pitch, onset frame, end frame) row."""

    def active(x):
        x = x.transpose(-1, -2)
        return ((1.0 / (1.0 + torch.exp(-x))) >= 0.5).cpu().numpy()

    notes = plain.notes_from_maps(active(logits[MULTIPITCH]),
                                  active(logits[ONSETS]))
    notes[:, 0] += config['lowest_key']

    return notes


def served(result, config):
    """A served clip's (pitches, intervals) -> (n, 3) rows as
    :func:`decode` gives them."""

    pitches, intervals = result

    return plain.served_notes(pitches, intervals,
                              config['hop_length'] / config['sample_rate'])


def logits_of(raw):
    """The port's raw output dict -> the logits the served notes are
    decoded from, which the check compares. (The offset head feeds the
    multi-pitch logits through the refinement; its own logits, near the
    -2 prior with a small spread, are not served.)"""

    return {key: raw[key] for key in (MULTIPITCH, ONSETS)}


def targets(notes, frames, config, device, rng=None):
    """Ground-truth maps (keys, T) of one crop's notes (pitch, onset s,
    offset s): a key is active on the frames whose time lies in a note,
    its onset on the note's first such frame and its offset on its last.
    ``rng`` is not drawn from: every note's place is fixed by its pitch."""

    hop_s = config['hop_length'] / config['sample_rate']
    maps = {key: np.zeros((config['num_keys'], frames), np.float32)
            for key in (MULTIPITCH, ONSETS, OFFSETS)}
    for pitch, onset, offset in notes:
        first = int(np.ceil(onset / hop_s))
        last = min(frames, int(np.ceil(offset / hop_s))) - 1
        if last < first:
            continue
        row = int(pitch) - config['lowest_key']
        maps[MULTIPITCH][row, first:last + 1] = 1.0
        maps[ONSETS][row, first] = 1.0
        maps[OFFSETS][row, last] = 1.0

    return {key: torch.as_tensor(value, device=device)
            for key, value in maps.items()}
