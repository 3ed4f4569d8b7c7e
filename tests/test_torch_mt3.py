"""MT3's piano transcriber (``models/mt3.py``, the T5 layers of
``ops/attention.py``), its features (``features.MelSpec`` with MT3's four
options), its token codec (``tools/event_codec.py``) and
``serving.Seq2SeqPipeline``, against the tests' plain reference
(``tests/mt3_reference.py``) on the CPU.

The model is held to the reference on seeded random weights at a small
size (2 + 2 layers, width 64, 2 heads of 16, MLP 128, 16 mels, 16-frame
segments, a cap of 12 tokens) in float32. Tolerances, each with its
reason:

- features: 1e-3 absolute on log-mels. The port's plain STFT is a float32
  DFT product and the reference's ``torch.fft.rfft``; their magnitudes
  differ by about 1e-6 of the frame's largest, which the log turns into
  at most a few 1e-4 in the quietest unfloored bins;
- encoder output and logits: 1e-4 of the reference's spread. Both run the
  same float32 arithmetic in another order (fused QKV products, the
  cache's one query a step against the teacher-forced sequence), which
  moves the values by a few float32 ulps a layer.
"""

import numpy as np
import pytest
import torch

import mt3_reference as ref
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import Seq2SeqTranscriber, mt3
from amt_tools_tpu_torch.ops import attention
from amt_tools_tpu_torch.serving import Seq2SeqPipeline
from amt_tools_tpu_torch.tools import event_codec as codec

torch.set_num_threads(2)

SMALL = {'n_mels': 16, 'emb_dim': 64, 'num_heads': 2, 'head_dim': 16,
         'mlp_dim': 128, 'num_encoder_layers': 2, 'num_decoder_layers': 2,
         'vocab_size': 1536}
FEATURES = {'sample_rate': 16000, 'n_fft': 2048, 'hop_length': 128,
            'n_mels': 16, 'fmin': 20.0, 'fmax': 7600.0, 'log_floor': 1e-5,
            'input_length': 16}
CONFIG = dict(SMALL, **FEATURES)
CAP = 12
SEGMENT = 16 * 128


def _model(seed=1, max_len=CAP):
    """The port's model at the small widths, its RMS scales drawn too (the
    default init leaves them 1)."""

    model = Seq2SeqTranscriber(max_len=max_len, generator=torch.Generator()
                               .manual_seed(seed), **SMALL).eval()
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, value in model.named_parameters():
            if name.endswith('norm.weight'):
                value.add_(0.1 * torch.randn(value.shape, generator=g))

    return model


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _mel():
    return MelSpec(sample_rate=16000, hop_length=128, n_mels=16, n_fft=2048,
                   center=False, pad_end=True, magnitude=True,
                   filterbank='tf', fmin=20.0, fmax=7600.0, log_floor=1e-5)


def _audio(clips, samples, seed=3):
    """Decaying partials at random pitches over a little noise."""

    g = np.random.RandomState(seed)
    t = np.arange(samples) / 16000.0
    audio = 0.01 * g.randn(clips, samples)
    for c in range(clips):
        for _ in range(4):
            f = 440.0 * 2 ** ((g.randint(40, 90) - 69) / 12)
            onset = g.uniform(0, samples / 16000.0)
            audio[c] += (0.3 * np.sin(2 * np.pi * f * t) *
                         np.exp(-3 * np.clip(t - onset, 0, None)) *
                         (t >= onset))

    return torch.as_tensor(audio, dtype=torch.float32)


def _feats(rows, seed=2):
    g = torch.Generator().manual_seed(seed)
    return -8.0 + 6.0 * torch.rand(rows, 1, 16, 16, generator=g)


def _spread_gap(got, want):
    return float((got - want).abs().max() / want.std())


def _generate(model, feats, max_len=CAP, lag=2):
    """Tokens and the step logits that ``logits_dense`` gave, the stop
    test ``lag`` steps behind."""

    steps = []
    hook = model.decoder.logits_dense.register_forward_hook(
        lambda module, args, out: steps.append(out.detach().clone()))
    lagged = mt3.STOP_LAG
    mt3.STOP_LAG = lag
    try:
        with torch.inference_mode():
            tokens = model.generate(model.encode(feats), max_len)
    finally:
        hook.remove()
        mt3.STOP_LAG = lagged

    return tokens, torch.stack(steps, dim=1)


def test_state_dict_names_are_t5xs():
    names = list(Seq2SeqTranscriber().state_dict())
    for name in ['encoder.continuous_inputs_projection.weight',
                 'encoder.layers_0.pre_attention_layer_norm.weight',
                 'encoder.layers_7.attention.query.weight',
                 'encoder.layers_3.attention.out.weight',
                 'encoder.layers_5.pre_mlp_layer_norm.weight',
                 'encoder.layers_2.mlp.wi_0.weight',
                 'encoder.layers_2.mlp.wi_1.weight',
                 'encoder.layers_2.mlp.wo.weight',
                 'encoder.encoder_norm.weight',
                 'decoder.token_embedder.weight',
                 'decoder.layers_0.pre_self_attention_layer_norm.weight',
                 'decoder.layers_4.self_attention.key.weight',
                 'decoder.layers_6.pre_cross_attention_layer_norm.weight',
                 'decoder.layers_7.encoder_decoder_attention.value.weight',
                 'decoder.layers_1.pre_mlp_layer_norm.weight',
                 'decoder.decoder_norm.weight',
                 'decoder.logits_dense.weight']:
        assert name in names, name
    # The projection, 8 encoder layers of 9 tensors, the encoder's norm,
    # the embedding, 8 decoder layers of 14, the decoder's norm and the
    # logits; the position table is no parameter
    assert len(names) == 1 + 8 * 9 + 1 + 1 + 8 * 14 + 1 + 1
    state = Seq2SeqTranscriber().state_dict()
    # 45.9 M, counted from the widths
    assert sum(v.numel() for v in state.values()) == 45_896_704
    assert state['encoder.layers_0.attention.query.weight'].shape == (384, 512)
    assert state['decoder.logits_dense.weight'].shape == (1536, 512)
    assert 'positions' not in state


def test_loading_is_strict():
    model = _model()
    params = _params(model)
    fresh = Seq2SeqTranscriber(max_len=CAP, **SMALL)
    fresh.load_state_dict(params, strict=True)
    params['decoder.layers_1.mlp.wi_2.weight'] = params.pop(
        'decoder.layers_1.mlp.wi_1.weight')
    with pytest.raises(RuntimeError):
        fresh.load_state_dict(params, strict=True)


def test_the_position_table_is_t5xs():
    table = Seq2SeqTranscriber(**SMALL).positions
    assert table.shape == (2048, 64)
    assert torch.equal(table[0, :32], torch.zeros(32))
    assert torch.equal(table[0, 32:], torch.ones(32))
    # The slowest timescale, 1 / 10000, in the last sine and cosine
    assert float(table[1000, 31]) == pytest.approx(np.sin(0.1), abs=1e-6)
    torch.testing.assert_close(table[:40], ref._positions(40, 64), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('samples', [SEGMENT * 5 // 2, SEGMENT - 300],
                         ids=['two_and_a_half_segments', 'under_a_segment'])
def test_features_match_the_reference(samples):
    audio = _audio(2, samples)
    pipeline = Seq2SeqPipeline(_model(), _mel(), capacity=CAP,
                               input_length=16, device='cpu')
    kept = []
    process = pipeline.data_proc.process
    pipeline.data_proc.process = lambda x: kept.append(process(x)) or kept[-1]
    pipeline(audio)
    segments = -(-samples // SEGMENT)
    assert pipeline.segments == 2 * segments
    got, = kept
    with ref.exact_float32():
        want = ref.features(audio, CONFIG)
    assert got.shape == want.shape == (2 * segments, 1, 16, 16)
    assert float((got - want).abs().max()) < 1e-3


def test_tf_filterbank_matches_the_reference():
    from amt_tools_tpu_torch.ops import spectral

    got = spectral.tf_mel_filterbank(16000, 2048, 16, 20.0, 7600.0)
    want = ref.mel_bank(16000, 2048, 16, 20.0, 7600.0)
    assert got.shape == (16, 1025) and not got[:, 0].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_the_encoder_matches_the_reference():
    model = _model()
    feats = _feats(3)
    before = attention.attention.encoder_self
    with torch.no_grad():
        encoded, kv = model.encode(feats)
        want = ref.encode(_params(model), feats, CONFIG)
    assert attention.attention.encoder_self - before == 2
    assert _spread_gap(encoded, want) < 1e-4
    # Every layer's keys and values from one product, split into views
    assert kv.shape == (3, 16, 2 * 2 * 32)
    cross = model.decoder.split(kv)
    assert len(cross) == 2 and cross[1][1].shape == (3, 2, 16, 16)


def test_cached_steps_match_the_full_forward():
    """Every step's logits through the cache equal the teacher-forced
    forward's over the generated tokens, the tokens are their argmax, and
    no row ends: the model runs to the cap."""

    model = _model()
    feats = _feats(4)
    counts = attention.attention.decoder_self, attention.attention.decoder_cross
    tokens, steps = _generate(model, feats)
    assert (attention.attention.decoder_self - counts[0],
            attention.attention.decoder_cross - counts[1]) == (2 * CAP,
                                                               2 * CAP)
    assert tokens.shape == (4, CAP) and steps.shape == (4, CAP, 1536)
    assert torch.equal(tokens, steps.argmax(-1))
    params = _params(model)
    with torch.no_grad():
        want = ref.logits(params, ref.encode(params, feats, CONFIG), tokens,
                          CONFIG)
        scored = model.score(feats, tokens)
    assert _spread_gap(steps, want) < 1e-4
    assert _spread_gap(scored, want) < 1e-4


def test_tokens_are_the_lowest_largest_logit():
    """Two equal largest logits: the lower id is taken."""

    model = _model()
    with torch.no_grad():
        weight = model.decoder.logits_dense.weight
        row = weight[700].clone()
        weight.zero_()
        weight[700] = weight[900] = row
    tokens, steps = _generate(model, _feats(2))
    assert torch.equal(steps[..., 700], steps[..., 900])
    assert set(tokens.flatten().tolist()) <= {0, 700}


def test_rows_that_end_emit_pad_and_the_loop_stops():
    """Under a test-only EOS bias rows end at different steps; after its
    EOS a row emits PAD; once every row has ended the loop runs ``lag``
    steps more and stops before the cap. The bias: EOS's row of
    ``logits_dense`` is 1.01 times that of a token every row emits first
    at a different step, so that EOS wins there."""

    model = _model(max_len=40)
    feats = _feats(6, seed=5)
    tokens, _ = _generate(model, feats, max_len=40)
    first = {}
    for token in sorted(set(tokens[:, 1:].flatten().tolist())):
        hits = tokens == token
        if bool(hits.any(dim=1).all()):
            first[token] = len(set(hits.int().argmax(dim=1).tolist()))
    token = max(first, key=first.get)
    assert first[token] > 1
    with torch.no_grad():
        weight = model.decoder.logits_dense.weight
        weight[codec.EOS] = 1.01 * weight[token]
    for lag in (0, 2, 5):
        tokens, steps = _generate(model, feats, max_len=40, lag=lag)
        eos = tokens == codec.EOS
        assert bool(eos.any(dim=1).all()), tokens
        ends = eos.int().argmax(dim=1)
        assert len(set(ends.tolist())) > 1, ends
        position = torch.arange(tokens.shape[1])[None]
        assert bool((tokens[position > ends[:, None]] == codec.PAD).all())
        live = position <= ends[:, None]
        assert torch.equal(tokens[live], steps.argmax(-1)[live])
        assert tokens.shape[1] == int(ends.max()) + 1 + lag < 40


def test_the_pipeline_serves_the_reference_decode_of_its_tokens():
    model = _model()
    audio = _audio(3, SEGMENT * 5 // 2, seed=7)
    pipeline = Seq2SeqPipeline(model, _mel(), capacity=CAP, input_length=16,
                               device='cpu')
    kept = []
    model.register_forward_hook(lambda m, a, out: kept.append(out.clone()))
    notes = pipeline(audio)
    tokens, = kept
    assert tokens.shape == (9, CAP)
    assert (pipeline.clips_decoded, pipeline.decode_steps,
            pipeline.rows_ended) == (3, CAP, 0)
    invalid = 0
    for c, (pitches, intervals, velocities) in enumerate(notes):
        want = []
        for s in range(3):
            found, bad = ref.decode_segment(tokens[3 * c + s], s * 0.128,
                                            0.128)
            want += found
            invalid += bad
        got = sorted(zip(pitches.tolist(), intervals[:, 0].tolist(),
                         intervals[:, 1].tolist(), velocities.tolist()))
        assert got == sorted(want)
        assert list(intervals[:, 0]) == sorted(intervals[:, 0])
    assert pipeline.tokens_invalid == invalid
    assert pipeline.notes_decoded == sum(len(n[0]) for n in notes)


# The codec


def _t(kind, value):
    return codec.token(kind, value)


def _decode(tokens, start=0.0, seconds=4.096):
    rows, pitches, onsets, offsets, velocities, invalid = codec.decode_rows(
        np.asarray([tokens]), [start], seconds)
    notes = [(int(p), round(float(a), 6), round(float(b), 6), int(v))
             for p, a, b, v in zip(pitches, onsets, offsets, velocities)]

    return notes, invalid


CODEC_CASES = {
    'accumulated shifts': (
        [_t('shift', 100), _t('shift', 50), _t('pitch', 60), _t('shift', 200),
         _t('velocity', 0), _t('pitch', 60)],
        0.0, [(60, 1.5, 2.0, 100)], 0),
    'an event restarts the shift count': (
        [_t('shift', 30), _t('pitch', 64), _t('pitch', 67), _t('shift', 40),
         _t('velocity', 0), _t('pitch', 64), _t('shift', 40), _t('pitch', 67)],
        0.0, [(64, 0.3, 0.4, 100), (67, 0.3, 0.4, 100)], 0),
    'velocity state and onsets closing onsets': (
        [_t('velocity', 80), _t('pitch', 50), _t('shift', 10),
         _t('velocity', 90), _t('pitch', 50), _t('shift', 20),
         _t('velocity', 0), _t('pitch', 50)],
        0.0, [(50, 0.0, 0.1, 80), (50, 0.1, 0.2, 90)], 0),
    'segment offset and a note open at the end': (
        [_t('shift', 5), _t('pitch', 70)], 4.096,
        [(70, 4.146, 8.192, 100)], 0),
    'invalid ids': (
        [codec.PAD, codec.UNK, codec.VOCAB_USED, 1535, _t('tie', 0),
         _t('program', 3), _t('drum', 36), _t('velocity', 0),
         _t('pitch', 40)],
        0.0, [], 8),
    'an event earlier than the last': (
        [_t('shift', 50), _t('pitch', 60), _t('shift', 20), _t('pitch', 62),
         _t('shift', 60), _t('pitch', 64)],
        0.0, [(60, 0.5, 4.096, 100), (64, 0.6, 4.096, 100)], 1),
    'a shift past the segment drops the rest': (
        [_t('pitch', 60), _t('shift', 1000), _t('pitch', 61), codec.PAD],
        0.0, [(60, 0.0, 4.096, 100)], 3),
    'EOS ends the row': (
        [_t('pitch', 60), _t('shift', 10), codec.EOS, _t('pitch', 61),
         codec.PAD],
        0.0, [(60, 0.0, 4.096, 100)], 0),
    'the shortest note': (
        [_t('pitch', 60), _t('velocity', 0), _t('pitch', 60)],
        0.0, [(60, 0.0, 0.01, 100)], 0),
}


@pytest.mark.parametrize('case', list(CODEC_CASES))
def test_codec_rules(case):
    tokens, start, notes, invalid = CODEC_CASES[case]
    assert _decode(tokens, start) == (notes, invalid)
    found, bad = ref.decode_segment(tokens, start, 4.096)
    assert [(p, round(a, 6), round(b, 6), v) for p, a, b, v in found] == notes
    assert bad == invalid


def test_codec_ids():
    assert codec.NUM_EVENTS == 1514 and codec.VOCAB_USED == 1517
    assert (_t('shift', 0), _t('pitch', 0), _t('velocity', 0), _t('tie', 0),
            _t('program', 0), _t('drum', 127)) == (3, 1004, 1132, 1260, 1261,
                                                   1516)
    with pytest.raises(ValueError):
        _t('pitch', 128)


def test_decode_rows_equals_the_loop_on_random_rows():
    """Rows of random ids weighted to the events that matter: the
    vectorized decode and the reference's loop give the same notes, in the
    same order of rows, and the same invalid count."""

    g = np.random.RandomState(11)
    rows, length = 300, 64
    # Shifts of 0-25 steps, 6 pitches, velocities 0, 20, ..., 100
    kind = g.randint(0, 3, (rows, length))
    tokens = np.choose(kind, [_t('shift', 0) + g.randint(0, 26, kind.shape),
                              _t('pitch', 58) + g.randint(0, 6, kind.shape),
                              _t('velocity', 0) +
                              20 * g.randint(0, 6, kind.shape)])
    tokens = np.where(g.rand(rows, length) < 0.9, tokens,
                      g.randint(0, 1536, (rows, length)))
    tokens[g.rand(rows) < 0.3, g.randint(0, length)] = codec.EOS
    starts = np.arange(rows) % 3 * 1.0
    got = codec.decode_rows(tokens, starts, 1.0)
    want, invalid = [], 0
    for r in range(rows):
        found, bad = ref.decode_segment(tokens[r], starts[r], 1.0)
        want += [(r,) + note for note in found]
        invalid += bad
    assert got[-1] == invalid
    assert sorted((int(r), int(p), float(a), float(b), int(v))
                  for r, p, a, b, v in zip(*got[:5])) == sorted(want)
    assert list(got[0]) == sorted(got[0])
    assert len(want) > 300 and invalid > 100


def test_attention_takes_a_scale_a_causal_mask_and_a_cache_prefix():
    """The plain route: T5's scale of 1, queries that see no later key,
    and keys and values given as the first positions of a cache."""

    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(3, 2, 5, 8, generator=g) for _ in range(3))
    before = attention.attention.plain
    got = attention.attention(q, k, v, 'encoder_self', scale=1.0)
    want = torch.softmax(q @ k.transpose(-1, -2), -1) @ v
    torch.testing.assert_close(got, want)
    causal = attention.attention(q, k, v, 'decoder_self', scale=1.0,
                                 causal=True)
    for i in range(5):
        torch.testing.assert_close(causal[:, :, i], (torch.softmax(
            q[:, :, i:i + 1] @ k[:, :, :i + 1].transpose(-1, -2), -1) @
            v[:, :, :i + 1])[:, :, 0])
    cache = torch.randn(2, 3, 2, 9, 8, generator=g)
    prefix = attention.attention(q[:, :, :1], cache[0, :, :, :4],
                                 cache[1, :, :, :4], 'decoder_cross',
                                 scale=1.0)
    torch.testing.assert_close(prefix, attention.attention(
        q[:, :, :1], cache[0, :, :, :4].contiguous(),
        cache[1, :, :, :4].contiguous(), 'decoder_cross', scale=1.0))
    assert attention.attention.plain - before == 4
    with pytest.raises(ValueError):
        attention.attention(q, k, v, 'no_such_kind')


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: the capture runs
    the step eagerly, a replay is counted."""

    replays = 0

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def pool(self):
        return 'pool'

    def replay(self):
        _FakeGraph.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_a_capture_counts_replays_not_itself(monkeypatch):
    """``_Steps.capture``'s bookkeeping, its CUDA calls stood in for: the
    eager step before the captures runs on zeroed inputs, a graph a
    position, the attention counters untouched by the capture, and each
    replay counted as its layers' self- and cross-attention calls."""

    import contextlib

    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _FakeGraph)
    monkeypatch.setattr(torch.cuda, 'Stream', lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, 'stream',
                        lambda stream: contextlib.nullcontext())
    model = _model()
    with torch.inference_mode():
        steps = mt3._Steps(model.decoder, 3, 16, torch.float32,
                           torch.device('cpu'), model.positions, 5, key=None)
        assert not bool(steps.token.any()) and not bool(steps.kv.any())
        before = {k: getattr(attention.attention, k)
                  for k in attention.KINDS + ('plain',)}
        steps.capture()
        assert {k: getattr(attention.attention, k)
                for k in before} == before
        assert len(steps.graphs) == 5
        replays = _FakeGraph.replays
        steps.run(3)
    assert _FakeGraph.replays == replays + 1
    assert (attention.attention.decoder_self - before['decoder_self'],
            attention.attention.decoder_cross -
            before['decoder_cross']) == (2, 2)


def test_a_decode_of_fewer_rows_pads_the_kept_steps():
    """A decode of fewer rows than the kept :class:`mt3._Steps` replays it
    with the rest as padding and gives what a fresh model gives; a decode
    of more rows, or after a weight changes, makes new steps. The serving
    call projects the keys and values straight into the kept buffer and
    gives what ``encode`` then ``generate`` give."""

    model, fresh = _model(), _model()
    feats = _feats(5, seed=7)
    with torch.inference_mode():
        tokens = model(feats)
        kept = model.decoder._kept
        assert kept.rows == 5
        fewer = model(feats[1:4])
        assert model.decoder._kept is kept
        assert torch.equal(fewer, tokens[1:4])
        assert torch.equal(fewer, fresh.generate(fresh.encode(feats[1:4])))
        _, kv = model.encode(feats[:2])
        assert torch.equal(kept.kv[:3], model.encode(feats[1:4])[1])
        assert torch.equal(model.generate((None, kv)), tokens[:2])
        assert model.decoder._kept is kept
        assert torch.equal(model(_feats(6, seed=8))[:5],
                           fresh(_feats(6, seed=8))[:5])
        assert model.decoder._kept is not kept
        assert model.decoder._kept.rows == 6
    kept = model.decoder._kept
    with torch.no_grad():
        model.decoder.logits_dense.weight.mul_(2.0)
    with torch.inference_mode():
        model(feats)
    assert model.decoder._kept is not kept
