"""Int8-static serving pipelines of the port against the JAX package's, on
the CPU, with Flax variables made from a seed and calibrated by the JAX
package's ``calibrate_quant_stats`` and activity calibration (the
``bench.py:102-106`` recipe).

Tolerances: each package computes its own features (within 1e-5 of each
other), so an activation that lies at a rounding boundary may quantize one
step apart, which moves the logits further than float sums do. Logits
within 1e-2 (read: 2.0e-3 piano, 1.6e-3 guitar) and within 2e-4 on the
mean; a thresholded piano map may differ only where the JAX logit is
within 1e-2 of the threshold, a tablature cell only where the JAX top-two
margin is within 2e-2; notes are equal in every pitch row whose maps agree
and on every string whose tablature agrees (PARITY.md's rule). Also: the
pipelines refuse missing or zero scales at construction.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.features import CQT as JaxCQT
from amt_tools_tpu.features import MelSpec as JaxMelSpec
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import TabCNN as JaxTabCNN
from amt_tools_tpu.ops import qconv as jqconv
from amt_tools_tpu.serving import TablaturePipeline as JaxTablaturePipeline
from amt_tools_tpu.serving import TranscriptionPipeline as JaxPipeline
from amt_tools_tpu.serving import calibrate_activity as jax_activity
from amt_tools_tpu.serving import calibrate_quant_stats as jax_calibrate
from amt_tools_tpu.serving import \
    calibrate_tablature_activity as jax_tablature_activity

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.datasets import random_notes, render_notes
from amt_tools_tpu_torch.features import CQT, MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2, TabCNN
from amt_tools_tpu_torch.ops import decode
from amt_tools_tpu_torch.ops.qconv import validate_quant_stats
from amt_tools_tpu_torch.serving import (TablaturePipeline,
                                         TranscriptionPipeline,
                                         calibrate_quant_stats)
from amt_tools_tpu_torch.weights import from_flax

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

PIPE_ATOL = 1e-2
PIPE_MEAN_ATOL = 2e-4
N_MELS = 48
GUITAR = dict(sample_rate=22050, hop_length=512, n_bins=192,
              bins_per_octave=24, exact='high', grouped='auto')


def _strip_stats(variables):
    return {k: v for k, v in variables.items() if k != jqconv.QUANT_STATS}


def _jax_of2(**kwargs):
    return JaxOnsetsFrames2(dim_in=N_MELS, profile=jtools.PianoProfile(),
                            model_complexity=2, **kwargs)


def _port_of2(**kwargs):
    return OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                         model_complexity=2, **kwargs)


def _clips(profile, count, seconds, sample_rate, notes_per_second):
    rng = np.random.RandomState(0)
    clips = []
    for b in range(count):
        pitches, intervals = random_notes(
            profile, seconds, int(notes_per_second * seconds), rng)
        clips.append(render_notes(pitches, intervals, sample_rate, seconds,
                                  seed=b))
    return np.stack(clips)


def _assert_close_logits(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= PIPE_ATOL
    assert diff.mean() <= PIPE_MEAN_ATOL


@pytest.fixture(scope='module')
def piano_served():
    """Audio, int8-static Flax variables (calibrated scales, then activity),
    the JAX logits and the JAX pipeline's notes."""

    audio = _clips(tools.PianoProfile(), 2, 3.0, 16000, 4)
    jax_mel = JaxMelSpec(n_mels=N_MELS)
    jax_model = _jax_of2(quant_acoustic='static', quant_lm='static')
    feats = jax_model.pre_proc({jtools.KEY_FEATS: jax_mel.process_jax(
        jnp.asarray(audio))})[jtools.KEY_FEATS]
    variables = _strip_stats(jax.jit(jax_model.init)(
        jax.random.PRNGKey(0), jnp.zeros_like(feats)))
    # The bench recipe: scales first, then activity on the int8 forward
    variables = jax_calibrate(jax_model, variables, jax_mel,
                              jnp.asarray(audio))
    variables = jax_activity(jax_model, variables, jax_mel,
                             jnp.asarray(audio))
    raw = jax_model.apply(variables, feats)
    notes = JaxPipeline(jax_model, variables, jax_mel, capacity=256)(audio)

    return audio, variables, raw, notes


def test_int8_static_pipeline_matches_jax(piano_served):
    audio, variables, jax_raw, jax_notes = piano_served

    model = _port_of2(quant_acoustic='static', quant_lm='static')
    model.load_state_dict(from_flax(variables))
    mel = MelSpec(n_mels=N_MELS)
    pipe = TranscriptionPipeline(model, mel, capacity=256, device='cpu')
    notes = pipe(audio)

    with torch.no_grad():
        feats = mel.process(torch.from_numpy(audio))
        port_raw = model(model.pre_proc({tools.KEY_FEATS: feats})[
            tools.KEY_FEATS])

    rows = np.zeros((len(audio), 88), dtype=bool)  # maps that differ
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
        want = np.asarray(jax_raw[key])
        got = port_raw[key].numpy()
        _assert_close_logits(got, want)
        differ = (got > 0) != (want > 0)
        assert (np.abs(want[differ]) <= PIPE_ATOL).all()
        rows |= differ.any(axis=1)

    compared = 0
    for b in range(len(audio)):
        (p_got, i_got), (p_want, i_want) = notes[b], jax_notes[b]
        keep_got = ~rows[b][p_got.astype(int) - 21]
        keep_want = ~rows[b][p_want.astype(int) - 21]
        np.testing.assert_array_equal(p_got[keep_got], p_want[keep_want])
        np.testing.assert_array_equal(i_got[keep_got], i_want[keep_want])
        compared += int(keep_want.sum())
    assert compared > 0, 'no notes were compared'


def test_int8_static_tablature_pipeline_matches_jax():
    profile = tools.GuitarProfile(num_frets=19)
    audio = _clips(profile, 2, 3.0, 22050, 2)

    jax_cqt = JaxCQT(**GUITAR)
    jax_model = JaxTabCNN(dim_in=192, profile=jtools.GuitarProfile(
        num_frets=19), fullseq=True, quant_acoustic='static')
    feats = jax_model.pre_proc({jtools.KEY_FEATS: jax_cqt.process_jax(
        jnp.asarray(audio))})[jtools.KEY_FEATS]
    variables = _strip_stats(jax.jit(
        lambda k, x: jax_model.init(k, x, train=False))(
            {'params': jax.random.PRNGKey(0),
             'dropout': jax.random.PRNGKey(1)}, jnp.zeros_like(feats)))
    variables = jax_calibrate(jax_model, variables, jax_cqt,
                              jnp.asarray(audio))
    variables = jax_tablature_activity(jax_model, variables, jax_cqt,
                                       jnp.asarray(audio))
    jax_raw = np.array(jax_model.apply(variables, feats)[
        jtools.KEY_TABLATURE])
    jax_notes = JaxTablaturePipeline(jax_model, variables, jax_cqt,
                                     capacity=64)(audio)

    model = TabCNN(dim_in=192, profile=profile, fullseq=True,
                   quant_acoustic='static')
    model.load_state_dict(from_flax(variables))
    cqt = CQT(**GUITAR)
    notes = TablaturePipeline(model, cqt, capacity=64, device='cpu')(audio)
    with torch.no_grad():
        raw = model(model.pre_proc({tools.KEY_FEATS: cqt.process(
            torch.from_numpy(audio))})[tools.KEY_FEATS])[
                tools.KEY_TABLATURE].numpy()
    _assert_close_logits(raw, jax_raw)

    head = model.tablature_out
    tab = head.finalize_output(torch.from_numpy(raw)).numpy()
    jax_tab = head.finalize_output(torch.from_numpy(jax_raw)).numpy()
    top2 = np.sort(jax_raw.reshape(jax_raw.shape[:2] + (6, 21)),
                   axis=-1)[..., -2:]
    margin = np.swapaxes(top2[..., 1] - top2[..., 0], -1, -2)
    assert (margin[tab != jax_tab] <= 2 * PIPE_ATOL).all()
    assert (tab >= 0).any(), 'the calibrated model decodes no fret'

    compared = 0
    for b in range(len(audio)):
        for string in range(6):
            if np.array_equal(tab[b, string], jax_tab[b, string]):
                np.testing.assert_array_equal(notes[b][string][0],
                                              jax_notes[b][string][0])
                np.testing.assert_array_equal(notes[b][string][1],
                                              jax_notes[b][string][1])
                compared += 1
    assert compared > 0, 'no string was compared'


def test_pipelines_refuse_missing_or_zero_stats():
    """Zero scales (a float checkpoint, never calibrated) and a model with
    no static int8 layer under a 'static' switch: construction raises,
    naming calibrate_quant_stats."""

    audio = np.random.RandomState(0).randn(1, 8000).astype(np.float32) * 0.1
    mel = MelSpec(n_mels=N_MELS)
    model = _port_of2(quant_acoustic='static')
    with pytest.raises(ValueError, match='calibrate_quant_stats'):
        TranscriptionPipeline(model, mel, device='cpu')

    # One zero scale is enough to refuse
    calibrate_quant_stats(model, mel, audio, device='cpu')
    TranscriptionPipeline(model, mel, device='cpu')
    model.offset_am.Conv_2.act_amax.zero_()
    with pytest.raises(ValueError, match='offset_am.Conv_2'):
        validate_quant_stats(model)

    guitar = TabCNN(dim_in=48, profile=tools.GuitarProfile(),
                    quant_acoustic='static')
    with pytest.raises(ValueError, match='calibrate_quant_stats'):
        TablaturePipeline(guitar, CQT(n_bins=48), device='cpu')

    # TabCNN has no language model: a 'static' quant_lm leaves no scale
    no_stats = TabCNN(dim_in=48, profile=tools.GuitarProfile(),
                      quant_lm='static')
    with pytest.raises(ValueError, match='calibrate_quant_stats'):
        TablaturePipeline(no_stats, CQT(n_bins=48), device='cpu')

    # A dynamic model needs no scales
    TranscriptionPipeline(_port_of2(quant_acoustic=True, quant_lm=True), mel,
                          device='cpu')


def test_int8_pipelines_decode_through_the_on_device_decode():
    """The int8 path ends in the same decode as the float one: a dynamic
    O&F2 pipeline's notes are those of its own thresholded logits."""

    audio = _clips(tools.PianoProfile(), 1, 2.0, 16000, 4)
    model = _port_of2(quant_acoustic=True, quant_lm=True,
                      generator=torch.Generator().manual_seed(5))
    mel = MelSpec(n_mels=N_MELS)
    with torch.no_grad():
        raw = model.eval()(model.pre_proc({tools.KEY_FEATS: mel.process(
            torch.from_numpy(audio))})[tools.KEY_FEATS])
    # Shift the biases so the random model fires
    with torch.no_grad():
        shift = torch.quantile(raw[tools.KEY_MULTIPITCH].flatten(), 0.97)
        model.adjoin_out.Dense_0.bias -= shift
        raw = model(model.pre_proc({tools.KEY_FEATS: mel.process(
            torch.from_numpy(audio))})[tools.KEY_FEATS])

    notes = TranscriptionPipeline(model, mel, device='cpu',
                                  use_onsets=False)(audio)
    multi_pitch = decode.threshold(decode.sigmoid(
        raw[tools.KEY_MULTIPITCH].transpose(-1, -2)))
    rows, on, off, counts = (x.numpy() for x in decode.notes_on_device(
        multi_pitch, None, capacity=2048))
    want = decode.notes_from_device(rows[0], on[0], off[0], counts[0],
                                    mel.get_times(audio[0]),
                                    tools.PianoProfile())
    assert len(notes[0][0]) > 0
    np.testing.assert_array_equal(notes[0][0], want[0])
    np.testing.assert_array_equal(notes[0][1], want[1])
