"""The port's spans (``profiling.span``) and the serving pipelines' host
decode counters, on the CPU.

- Under ``torch.profiler`` a piano batch, a guitar batch, a High-resolution
  Piano Transcription batch, an hFT-Transformer batch, an MT3 batch and an
  O&F2 train step hold each ``amt.`` span where the port opens it, once a layer
  call: the features, the acoustic stacks, the LSTM layers and the device
  decode inside ``dispatch``, the device decode after the forward, the
  host decode inside ``finalize``, the step's forward around its stacks
  and LSTMs, and the LSTMs' backward once a direction, outside the forward.
- With no profiler recording, every span is one shared null context and a
  batch makes no ``record_function``.
- A capacity of one note forces every clip through a re-decode: the
  pipelines count the re-decodes, clips and notes, and the notes equal a
  large capacity's.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from amt_tools_tpu_torch import profiling, tools
from amt_tools_tpu_torch.datasets import random_notes, render_notes
from amt_tools_tpu_torch.features import CQT, MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2, TabCNN
from amt_tools_tpu_torch.models.onsetsframes import AcousticModel
from amt_tools_tpu_torch.ops.lstm import FastBiLSTM
from amt_tools_tpu_torch.serving import (TablaturePipeline,
                                         TranscriptionPipeline,
                                         calibrate_activity,
                                         calibrate_tablature_activity)
from amt_tools_tpu_torch.train import make_train_step

torch.set_num_threads(1)

N_MELS = 16
PIANO_SECONDS = 1.0
GUITAR = dict(sample_rate=22050, hop_length=512, n_bins=24,
              bins_per_octave=12, fmin=110.0)
GUITAR_SECONDS = 1.0


def _audio(profile, sample_rate, seconds, clips=2, notes=8):
    rng = np.random.RandomState(0)
    rendered = []
    for b in range(clips):
        pitches, intervals = random_notes(profile, seconds, notes, rng)
        rendered.append(render_notes(pitches, intervals, sample_rate,
                                     seconds, seed=b))

    return np.stack(rendered)


@pytest.fixture(scope='module')
def piano():
    """A calibrated tiny O&F2 and its audio: several notes a clip."""

    model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                          model_complexity=2,
                          generator=torch.Generator().manual_seed(0))
    audio = _audio(tools.PianoProfile(), 16000, PIANO_SECONDS)
    calibrate_activity(model, MelSpec(n_mels=N_MELS), audio,
                       rates=((tools.KEY_MULTIPITCH, 'adjoin_out', 0.1),
                              (tools.KEY_ONSETS, 'onset_out', 0.05)),
                       device='cpu')

    return model, audio


@pytest.fixture(scope='module')
def guitar():
    """A calibrated tiny whole-sequence TabCNN and its audio."""

    profile = tools.GuitarProfile()
    model = TabCNN(dim_in=GUITAR['n_bins'], profile=profile, fullseq=True,
                   generator=torch.Generator().manual_seed(0))
    audio = _audio(profile, GUITAR['sample_rate'], GUITAR_SECONDS)
    calibrate_tablature_activity(model, CQT(**GUITAR), audio, rate=0.2,
                                 device='cpu')

    return model, audio


def _spans(prof):
    """Counter of (span, the ``amt.`` and ``test.`` ranges around it,
    innermost first) over the profiled host events."""

    found = collections.Counter()
    for event in prof.events():
        if (event.device_type != DeviceType.CPU or
                not event.name.startswith('amt.')):
            continue
        around = []
        parent = event.cpu_parent
        while parent is not None:
            if parent.name.startswith(('amt.', 'test.')):
                around.append(parent.name)
            parent = parent.cpu_parent
        found[event.name, tuple(around)] += 1

    return found


def _intervals(prof, name):
    return [event.time_range for event in prof.events()
            if event.device_type == DeviceType.CPU and event.name == name]


def _serve_profiled(pipeline, audio):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('test.dispatch'):
            handle = pipeline.dispatch(audio)
        with record_function('test.finalize'):
            notes = pipeline.finalize(handle)

    return prof, notes


def _count(model, kind):
    return sum(isinstance(module, kind) for module in model.modules())


def test_a_piano_batch_holds_every_serving_span(piano):
    model, audio = piano
    pipeline = TranscriptionPipeline(model, MelSpec(n_mels=N_MELS),
                                     device='cpu')
    prof, notes = _serve_profiled(pipeline, audio)

    stacks, lstms = _count(model, AcousticModel), _count(model, FastBiLSTM)
    assert (stacks, lstms) == (3, 3)
    assert _spans(prof) == {
        ('amt.features', ('test.dispatch',)): 1,
        ('amt.acoustic', ('test.dispatch',)): stacks,
        ('amt.lstm', ('test.dispatch',)): lstms,
        ('amt.decode', ('test.dispatch',)): 1,
        ('amt.serving.decode_host', ('test.finalize',)): 1}

    # The device decode starts once the forward has returned
    decode, = _intervals(prof, 'amt.decode')
    forward = _intervals(prof, 'amt.acoustic') + _intervals(prof, 'amt.lstm')
    assert decode.start >= max(span.end for span in forward)
    assert len(notes) == len(audio)


def test_a_guitar_batch_holds_every_serving_span(guitar):
    model, audio = guitar
    pipeline = TablaturePipeline(model, CQT(**GUITAR), device='cpu')
    prof, notes = _serve_profiled(pipeline, audio)

    assert _spans(prof) == {
        ('amt.features', ('test.dispatch',)): 1,
        ('amt.acoustic', ('test.dispatch',)): 1,
        ('amt.decode', ('test.dispatch',)): 1,
        ('amt.serving.decode_host', ('test.finalize',)): 1}
    decode, = _intervals(prof, 'amt.decode')
    acoustic, = _intervals(prof, 'amt.acoustic')
    assert decode.start >= acoustic.end
    assert len(notes) == len(audio)


def test_an_hpt_batch_holds_every_serving_span_and_four_gru_layers():
    """The High-resolution Piano Transcription pipeline: its four stacks'
    convs and fc5 in one ``amt.acoustic``, its GRU layers in four
    ``amt.gru`` (the stacks' first and second layers, the onset and the
    frame conditioning), the regression decode's device stage in
    ``amt.decode`` after them and its host stage in
    ``amt.serving.decode_host``."""

    from amt_tools_tpu_torch.models import RegressCRNN
    from amt_tools_tpu_torch.serving import RegressionPipeline

    mel = MelSpec(hop_length=160, fmin=30, fmax=8000, absolute_db=True,
                  pad_mode='reflect')
    pipeline = RegressionPipeline(
        RegressCRNN(dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0)), mel,
        device='cpu')
    audio = _audio(tools.PianoProfile(), 16000, 0.1)
    prof, notes = _serve_profiled(pipeline, audio)

    assert _spans(prof) == {
        ('amt.features', ('test.dispatch',)): 1,
        ('amt.acoustic', ('test.dispatch',)): 1,
        ('amt.gru', ('test.dispatch',)): 4,
        ('amt.decode', ('test.dispatch',)): 1,
        ('amt.serving.decode_host', ('test.finalize',)): 1}
    decode, = _intervals(prof, 'amt.decode')
    acoustic, = _intervals(prof, 'amt.acoustic')
    grus = _intervals(prof, 'amt.gru')
    assert all(gru.start >= acoustic.end for gru in grus)
    assert decode.start >= max(gru.end for gru in grus)
    assert len(notes) == len(audio)


def test_an_hft_batch_holds_every_serving_span_and_three_transformers():
    """The hFT-Transformer pipeline (at a small width): its front end in
    one ``amt.acoustic``, its three stacks (the frequency encoder, the
    frequency decoder, the time encoder) in three ``amt.transformer``
    after it, the regression decode's device stage in ``amt.decode`` after
    them and its host stage in ``amt.serving.decode_host``."""

    from amt_tools_tpu_torch.models import HFTransformer
    from amt_tools_tpu_torch.serving import RegressionPipeline

    mel = MelSpec(hop_length=256, n_mels=N_MELS, htk=True, fmax=8000.0,
                  log_offset=1e-8)
    model = HFTransformer(n_bin=N_MELS, n_margin=4, n_frame=8, hid_dim=32,
                          n_heads=2, pf_dim=64, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
    pipeline = RegressionPipeline(model, mel, device='cpu',
                                  onset_threshold=0.5, offset_threshold=0.5,
                                  frame_threshold=0.5)
    audio = _audio(tools.PianoProfile(), 16000, 0.2)
    prof, notes = _serve_profiled(pipeline, audio)

    assert _spans(prof) == {
        ('amt.features', ('test.dispatch',)): 1,
        ('amt.acoustic', ('test.dispatch',)): 1,
        ('amt.transformer', ('test.dispatch',)): 3,
        ('amt.decode', ('test.dispatch',)): 1,
        ('amt.serving.decode_host', ('test.finalize',)): 1}
    decode, = _intervals(prof, 'amt.decode')
    acoustic, = _intervals(prof, 'amt.acoustic')
    stacks = _intervals(prof, 'amt.transformer')
    assert all(stack.start >= acoustic.end for stack in stacks)
    assert decode.start >= max(stack.end for stack in stacks)
    assert len(notes) == len(audio)


def test_an_mt3_batch_holds_its_encoder_and_two_generate_spans():
    """MT3's pipeline (at a small width): the features in one
    ``amt.features``, the encoder in one ``amt.transformer`` after them,
    then two ``amt.generate`` (the cross-attention's keys and values, then
    the decode loop), and the token decode in ``amt.serving.decode_host``;
    no ``amt.decode``, since the decode to notes runs on the host."""

    from amt_tools_tpu_torch.models import Seq2SeqTranscriber
    from amt_tools_tpu_torch.serving import Seq2SeqPipeline

    mel = MelSpec(hop_length=128, n_mels=N_MELS, center=False, pad_end=True,
                  magnitude=True, filterbank='tf', fmin=20.0, fmax=7600.0,
                  log_floor=1e-5)
    model = Seq2SeqTranscriber(n_mels=N_MELS, emb_dim=32, num_heads=2,
                               head_dim=16, mlp_dim=64, num_encoder_layers=2,
                               num_decoder_layers=2, max_len=6,
                               dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(0))
    pipeline = Seq2SeqPipeline(model, mel, capacity=6, input_length=16,
                               device='cpu')
    audio = _audio(tools.PianoProfile(), 16000, 0.2)
    prof, notes = _serve_profiled(pipeline, audio)

    assert _spans(prof) == {
        ('amt.features', ('test.dispatch',)): 1,
        ('amt.transformer', ('test.dispatch',)): 1,
        ('amt.generate', ('test.dispatch',)): 2,
        ('amt.serving.decode_host', ('test.finalize',)): 1}
    encoder, = _intervals(prof, 'amt.transformer')
    cross, loop = sorted(_intervals(prof, 'amt.generate'),
                         key=lambda span: span.start)
    assert encoder.end <= cross.start and cross.end <= loop.start
    assert len(notes) == len(audio) and pipeline.decode_steps == 6


def test_a_train_step_holds_its_forward_and_the_lstm_backward():
    model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                          model_complexity=2,
                          generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, torch.optim.Adam(model.parameters()))
    rng = np.random.RandomState(0)
    batch = {tools.KEY_FEATS: torch.from_numpy(
                 rng.rand(2, 1, N_MELS, 12).astype(np.float32)),
             tools.KEY_MULTIPITCH: torch.from_numpy(
                 (rng.rand(2, 88, 12) < 0.1).astype(np.float32))}

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('test.step'):
            step(batch, torch.Generator().manual_seed(1))

    found = _spans(prof)
    backward = {around: n for (name, around), n in found.items()
                if name == 'amt.lstm.backward'}
    # Once a BiLSTM a step (its two directions are one grouped launch),
    # outside the forward (on the card, on autograd's own thread)
    assert sum(backward.values()) == _count(model, FastBiLSTM) == 3
    assert all('amt.train.forward' not in around for around in backward)
    forward = ('amt.train.forward', 'test.step')
    assert {key: n for key, n in found.items()
            if key[0] != 'amt.lstm.backward'} == {
        ('amt.train.forward', ('test.step',)): 1,
        ('amt.acoustic', forward): 3,
        ('amt.lstm', forward): 3}


def test_without_a_profiler_a_span_is_the_shared_null_context(
        piano, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    shared = profiling.span('amt.features')
    assert isinstance(shared, contextlib.nullcontext)
    assert profiling.span('amt.lstm.backward') is shared
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span('amt.features'), record_function)

    # A whole batch opens no range
    def refuse(name, args=None):
        raise AssertionError(f'a range {name!r} with no profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    model, audio = piano
    pipeline = TranscriptionPipeline(model, MelSpec(n_mels=N_MELS),
                                     device='cpu')
    assert len(pipeline(audio)) == len(audio)


def _note_count(clip):
    groups = clip.values() if isinstance(clip, dict) else [clip]

    return sum(len(pitches) for pitches, _ in groups)


def _same_notes(got, want):
    got_groups = got.values() if isinstance(got, dict) else [got]
    want_groups = want.values() if isinstance(want, dict) else [want]
    for (pitches, intervals), (ref_pitches, ref_intervals) in zip(
            got_groups, want_groups, strict=True):
        np.testing.assert_array_equal(pitches, ref_pitches)
        np.testing.assert_array_equal(intervals, ref_intervals)


@pytest.mark.parametrize('kind', ['piano', 'guitar'])
def test_an_overflow_counts_redecodes_and_keeps_the_notes(kind, request):
    model, audio = request.getfixturevalue(kind)
    if kind == 'piano':
        def build(capacity):
            return TranscriptionPipeline(model, MelSpec(n_mels=N_MELS),
                                         capacity=capacity, device='cpu')
    else:
        def build(capacity):
            return TablaturePipeline(model, CQT(**GUITAR), capacity=capacity,
                                     device='cpu')

    large, small = build(4096), build(1)
    want = large(audio)
    got = small(audio)

    notes = sum(_note_count(clip) for clip in want)
    # Every clip holds more than one note, so every clip overflows
    assert all(_note_count(clip) > 1 for clip in want)
    assert (large.clips_decoded, large.notes_decoded, large.redecodes) == (
        len(audio), notes, 0)
    assert (small.clips_decoded, small.notes_decoded, small.redecodes) == (
        len(audio), notes, len(audio))
    for clip, ref in zip(got, want, strict=True):
        _same_notes(clip, ref)
