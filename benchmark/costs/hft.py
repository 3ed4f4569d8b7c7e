"""Analytic model FLOPs of hFT-Transformer, and the least work of its
attention, from its configuration.

Counted from the widths alone, two operations a multiply-add: the front
end's (1, 5) conv and bin embedding, every attention's Q, K, V and O
projections and its score and value products, the feed-forwards and heads
B (the serving forward skips heads A). The first decoder layer's query
projection is of the learned queries alone, the same for every frame, so
it counts once a forward. The model runs whole segments of
``n_frame`` frames: a clip of T frames makes ceil(T / n_frame) of them,
and the padded frames count. Elementwise work (LayerNorms, softmax, the
embeddings' sums), the features and the decode are not counted.
"""


def segments(config, frames):
    """Segments of one clip of ``frames`` frames."""

    return -(-frames // config['n_frame'])


def _attention_flops(config, queries, keys):
    """One attention over ``queries`` tokens from ``keys`` tokens: the four
    projections and the score and value products."""

    hid = config['hid_dim']

    return 2 * hid * hid * (2 * queries + 2 * keys) + 4 * queries * keys * hid


def _query_flops(config):
    """The first decoder layer's query projection of the learned
    queries."""

    return 2 * config['num_keys'] * config['hid_dim'] ** 2


def _feedforward_flops(config, tokens):
    return 4 * tokens * config['hid_dim'] * config['pf_dim']


def frame_flops(config):
    """FLOPs of one segment frame of the serving forward."""

    bins, notes, frame = config['n_bin'], config['num_keys'], config['n_frame']
    hid, layers = config['hid_dim'], config['n_layers']
    width = 2 * config['n_margin'] + 2 - config['cnn_kernel']
    cnn_dim = config['cnn_channel'] * width

    front = (2 * bins * width * config['cnn_channel'] * config['cnn_kernel'] +
             2 * bins * cnn_dim * hid)
    encoder = layers * (_attention_flops(config, bins, bins) +
                        _feedforward_flops(config, bins))
    decoder = layers * (_attention_flops(config, notes, bins) +
                        _feedforward_flops(config, notes))
    decoder += (layers - 1) * _attention_flops(config, notes, notes)
    decoder -= _query_flops(config)
    # A frame's share of the time encoder: its notes' tokens
    time = layers * notes * (_attention_flops(config, frame, frame) +
                             _feedforward_flops(config, frame)) // frame
    heads = 2 * notes * hid * (3 + config['n_velocity'])

    return front + encoder + decoder + time + heads


def forward_flops(config, batch, frames):
    """FLOPs of one forward over ``batch`` clips of ``frames`` frames."""

    return float(batch * segments(config, frames) * config['n_frame'] *
                 frame_flops(config) + _query_flops(config))


def features_cost(config, batch, num_samples):
    """(flops, bytes) of the mel stage of one batch."""

    from .kernels import mel_stage_cost

    return mel_stage_cost(batch, num_samples, config['n_fft'],
                          config['hop_length'], config['n_bin'])


def _attention_cost(config, sequences, queries, keys, size):
    hid = config['hid_dim']
    flops = 4.0 * sequences * queries * keys * hid
    num_bytes = size * sequences * hid * (2 * queries + 2 * keys)

    return flops, float(num_bytes)


def attention_cost(config, batch, frames, size):
    """(flops, bytes) of each attention call of one forward, 11 at the
    published depth: the score and value products (4 L S E operations a
    sequence), and Q and O (L E values each), K and V (S E each) read or
    written once at ``size`` bytes a value. In order: the frequency
    encoder's self-attentions over the bins of each frame, the frequency
    decoder's cross-attentions from the notes to the bins and its
    self-attentions over the notes, the time encoder's self-attentions over
    the frames of each note."""

    bins, notes, frame = config['n_bin'], config['num_keys'], config['n_frame']
    layers = config['n_layers']
    count = batch * segments(config, frames)
    rows = count * frame

    return ([_attention_cost(config, rows, bins, bins, size)] * layers +
            [_attention_cost(config, rows, notes, bins, size)] * layers +
            [_attention_cost(config, rows, notes, notes, size)] *
            (layers - 1) +
            [_attention_cost(config, count * notes, frame, frame, size)] *
            layers)
