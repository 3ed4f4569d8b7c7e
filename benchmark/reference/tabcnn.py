"""Plain reference of TabCNN (Wiggins and Kim, ISMIR 2019) at the widths
of ``configs/tabcnn.json``.

CQT features; each frame's context window of ``frame_width`` frames (the
clip zero-padded by half a window at each end) through three 3x3 VALID
convolutions with ReLU (32, 64, 64 channels at complexity 1), a 2x2
max-pool, a dense layer of 128 with ReLU, and a softmax over each string's
frets and silence (silence last). Training: dropout 0.25 after the pool and
0.5 after the dense layer, the softmax cross-entropy summed over the
strings, averaged over frames and the batch, Adadelta.

The port serves the same function as one convolution over the whole clip
(``fullseq``); the reference computes it window by window, as the model is
defined. Parameters are named and laid out as the port's ``state_dict``.
"""

import numpy as np
import torch

from . import plain

TABLATURE = 'tablature'


def _sizes(config):
    c = config['model_complexity']
    bins, width = config['n_bins'], config['frame_width']
    features = 64 * c * ((bins - 6) // 2) * ((width - 6) // 2)
    classes = config['num_frets'] + 2

    return 32 * c, 64 * c, 128 * c, features, classes


def parameters(config):
    nf1, nf2, emb, features, classes = _sizes(config)
    outputs = config['num_strings'] * classes

    def layer(name, shape, fan_in):
        return [(f'{name}.weight', shape, ('normal', 0.0, fan_in ** -0.5)),
                (f'{name}.bias', shape[:1], ('normal', 0.0, 0.05))]

    return (layer('conv1', (nf1, 1, 3, 3), 9) +
            layer('conv2', (nf2, nf1, 3, 3), 9 * nf1) +
            layer('conv3', (nf2, nf2, 3, 3), 9 * nf2) +
            layer('dense1', (emb, features), features) +
            layer('tablature_out.Dense_0', (outputs, emb), emb))


def features(audio, config, precision='float32'):
    return plain.cqt_features(audio, config, precision)


def forward(params, feats, config, precision='float32', generator=None,
            chunk=4096):
    """(B, 1, F, T) features -> {tablature: (B, T, strings * classes)}
    logits, ``chunk`` windows at a time when not training. With a dropout
    ``generator`` the forward trains."""

    batch, _, bins, frames = feats.shape
    width = config['frame_width']
    pad = width // 2
    padded = torch.nn.functional.pad(feats, (pad, pad))
    # (B, 1, F, T, W) -> (B, T, 1, F, W) -> (B T, 1, F, W)
    windows = padded.unfold(-1, width, 1)[..., :frames, :]
    windows = windows.permute(0, 3, 1, 2, 4).reshape(
        batch * frames, 1, bins, width)

    def stack(x):
        for name in ('conv1', 'conv2', 'conv3'):
            x = torch.relu(plain.conv2d(x, params[f'{name}.weight'],
                                        params[f'{name}.bias'], 0, precision))
        return torch.nn.functional.max_pool2d(x, (2, 2), stride=(2, 2))

    if generator is None:
        x = torch.cat([stack(windows[i:i + chunk])
                       for i in range(0, windows.shape[0], chunk)])
    else:
        x = plain.dropout(stack(windows), 0.25, generator)

    # (N, C, F', W') -> (N, F', W', C) -> (B, T, F' W' C)
    x = x.permute(0, 2, 3, 1).reshape(batch, frames, -1)
    x = torch.relu(plain.linear(x, params['dense1.weight'],
                                params['dense1.bias'], precision))
    if generator is not None:
        x = plain.dropout(x, 0.5, generator)

    return {TABLATURE: plain.linear(x, params['tablature_out.Dense_0.weight'],
                                    params['tablature_out.Dense_0.bias'],
                                    precision)}


def loss(params, batch, config, precision, generator):
    """The softmax cross-entropy of a batch ({features, tablature: (B, S,
    T) class ids, -1 silence})."""

    logits = forward(params, batch['features'], config, precision,
                     generator)[TABLATURE]
    classes = config['num_frets'] + 2
    logits = logits.reshape(logits.shape[:-1] + (config['num_strings'],
                                                 classes))
    labels = batch[TABLATURE].transpose(-1, -2)
    labels = torch.where(labels < 0, classes - 1, labels)
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, labels[..., None])[..., 0]

    return nll.sum(dim=-1).mean(dim=-1).mean()


def calibrate(params, audio, config, rate=0.05):
    """Raise each string's silence bias in ``params`` by the ``1 - rate``
    quantile of the best fret's margin over silence on the probe, so that
    about ``rate`` of (string, frame) cells decode to a fret."""

    strings, classes = config['num_strings'], config['num_frets'] + 2
    with torch.no_grad(), plain.exact_float32():
        logits = forward(params, features(audio, config), config)[TABLATURE]
        logits = logits.reshape(-1, strings, classes)
        margin = logits[..., :-1].amax(dim=-1) - logits[..., -1]
        shift = torch.quantile(margin, 1.0 - rate, dim=0)
        bias = params['tablature_out.Dense_0.bias']
        bias[torch.arange(strings, device=bias.device) * classes +
             classes - 1] += shift


def decode(logits, config):
    """The notes the served tablature of a clip holds: each string's class
    is the first largest of its (T, classes) served logits, silence last;
    a string's fret f sounds where its class is f, a note on each rise,
    pitch = fret + the string's open pitch. (string, pitch, onset frame,
    end frame) rows."""

    strings, classes = config['num_strings'], config['num_frets'] + 2
    tab = logits[TABLATURE]
    ids = tab.reshape(tab.shape[:-1] + (strings, classes)).argmax(dim=-1)
    ids = ids.transpose(0, 1).cpu().numpy()  # (S, T)
    rows = []
    for string in range(strings):
        frets = np.arange(classes - 1)[:, None] == ids[string][None, :]
        notes = plain.notes_from_maps(frets)
        notes[:, 0] += config['tuning'][string]
        rows.append(np.concatenate([np.full((len(notes), 1), string), notes],
                                   axis=1))

    return np.concatenate(rows)


def served(result, config):
    """A served clip's {string: (pitches, intervals)} -> rows as
    :func:`decode` gives them."""

    frame_seconds = config['hop_length'] / config['sample_rate']
    rows = []
    for string in range(config['num_strings']):
        pitches, intervals = result[string]
        notes = plain.served_notes(pitches, intervals, frame_seconds)
        rows.append(np.concatenate([np.full((len(notes), 1), string), notes],
                                   axis=1))

    return np.concatenate(rows)


def logits_of(raw):
    return {TABLATURE: raw[TABLATURE]}


def string_of(pitch, frets, rng, config):
    """A string that can play ``pitch``: one drawn from those whose range
    of open pitch to open pitch + frets holds it."""

    tuning = np.asarray(config['tuning'])
    playable = np.nonzero((tuning <= pitch) & (pitch <= tuning + frets))[0]

    return int(rng.choice(playable))


def targets(notes, frames, config, device, rng):
    """Tablature (S, T) class ids (-1 silence) of one crop's notes: each
    note on a string that can play it, on the frames whose time lies in the
    note; a later note on a string takes the frames it shares."""

    hop_s = config['hop_length'] / config['sample_rate']
    tab = np.full((config['num_strings'], frames), -1, np.int64)
    for pitch, onset, offset in notes:
        string = string_of(int(pitch), config['num_frets'], rng, config)
        first = int(np.ceil(onset / hop_s))
        last = min(frames, int(np.ceil(offset / hop_s)))
        tab[string, first:last] = int(pitch) - config['tuning'][string]

    return {TABLATURE: torch.as_tensor(tab, device=device)}
