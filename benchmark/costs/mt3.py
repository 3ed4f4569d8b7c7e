"""Analytic model FLOPs of MT3's piano transcriber, and the least work of
its encoder's attention and of its greedy decode, from its configuration.

Counted from the widths alone, two operations a multiply-add. A segment
of ``input_length`` frames: the input projection, each encoder layer's
Q, K, V and O projections, score and value products and gated MLP; the
cross-attention's keys and values of every decoder layer, projected once;
then each of ``outputs_length`` greedy steps a row: each decoder layer's
self-attention projections and products over the cache (t + 1 keys at
step t), the cross-attention's query and output projections and products
over the segment's frames, the gated MLP, and the logits. Every row
decodes to the cap in the cell, which its check holds (``rows_ended``).
Norms, softmax, embeddings, the argmax, the features and the host decode
are not counted. A clip of T frames (of the clip's hop) makes ceil((T - 1)
hop / segment) segments, the last one padded, whose work counts whole.
"""


def segments(config, frames):
    """Segments of one clip of ``frames`` frames (1 + samples // hop)."""

    size = config['input_length'] * config['hop_length']

    return max(1, -(-(frames - 1) * config['hop_length'] // size))


def _inner(config):
    return config['num_heads'] * config['head_dim']


def _mlp_flops(config):
    return 6 * config['emb_dim'] * config['mlp_dim']


def encoder_flops(config):
    """One segment's encoder."""

    emb, inner, length = config['emb_dim'], _inner(config), \
        config['input_length']
    layer = (8 * emb * inner + 4 * length * inner + _mlp_flops(config))

    return length * (2 * config['n_mels'] * emb +
                     config['num_encoder_layers'] * layer)


def cross_flops(config):
    """One segment's cross-attention keys and values, every layer."""

    return (config['input_length'] * config['num_decoder_layers'] * 4 *
            config['emb_dim'] * _inner(config))


def step_flops(config, step):
    """One row's greedy step ``step`` (from 0)."""

    emb, inner = config['emb_dim'], _inner(config)
    layer = (12 * emb * inner + 4 * (step + 1) * inner +
             4 * config['input_length'] * inner + _mlp_flops(config))

    return (config['num_decoder_layers'] * layer +
            2 * emb * config['vocab_size'])


def segment_flops(config):
    return (encoder_flops(config) + cross_flops(config) +
            sum(step_flops(config, t) for t in range(config['outputs_length'])))


def forward_flops(config, batch, frames):
    """FLOPs of one forward over ``batch`` clips of ``frames`` frames."""

    return float(batch * segments(config, frames) * segment_flops(config))


def features_cost(config, batch, num_samples):
    """(flops, bytes) of the mel stage of one batch: its segments, each
    ``input_length`` frames from its first sample (the centred count of
    ``mel_stage_cost`` less one), its whole audio read."""

    from .kernels import F32, mel_stage_cost

    size = config['input_length'] * config['hop_length']
    rows = batch * max(1, -(-num_samples // size))
    flops, num_bytes = mel_stage_cost(rows, size - config['hop_length'],
                                      config['n_fft'], config['hop_length'],
                                      config['n_mels'])

    return flops, num_bytes + F32 * rows * config['hop_length']


def attention_cost(config, batch, frames, size):
    """(flops, bytes) of each attention call of one forward's encoder, one
    a layer: the score and value products (4 L S I operations a segment,
    I the heads' inner width) and Q, K, V and the output read or written
    once at ``size`` bytes a value."""

    rows = batch * segments(config, frames)
    length, inner = config['input_length'], _inner(config)
    call = (4.0 * rows * length * length * inner,
            float(size * rows * inner * 4 * length))

    return [call] * config['num_encoder_layers']


def generate_cost(config, batch, frames, size):
    """(flops, bytes) of the work under ``amt.generate`` for one forward:
    the cross-attention keys and values (the encoder output and the
    weights read, the keys and values written), then each greedy step of
    every row: its operations, and its bytes, the decoder's weights read
    once (bf16 at ``size``, the float32 logits projection at 4), every
    row's cross keys and values, and its self-attention cache up to the
    step, the step's own position written and read once."""

    rows = batch * segments(config, frames)
    emb, inner, mlp = config['emb_dim'], _inner(config), config['mlp_dim']
    layers, length = config['num_decoder_layers'], config['input_length']
    projection = (rows * cross_flops(config),
                  float(size * (rows * length * emb + layers * 2 * inner * emb +
                                rows * length * layers * 2 * inner)))
    weights = (size * layers * (6 * inner * emb + 3 * mlp * emb + 3 * emb) +
               size * emb + 4 * config['vocab_size'] * emb)
    position = size * rows * layers * 2 * inner

    return [projection] + [
        (float(rows * step_flops(config, t)),
         float(weights + position * (length + t + 1)))
        for t in range(config['outputs_length'])]
