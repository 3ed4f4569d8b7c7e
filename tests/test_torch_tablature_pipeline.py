"""The port's guitar serving path vs the JAX package's, on the CPU: the
tablature decode functions, ``calibrate_tablature_activity`` and
``TablaturePipeline`` at the real CQT recipe (192 bins at 24 per octave
from C1, exact='high', grouped='auto', hop 512 at 22.05 kHz) with a full
width float32 TabCNN (fullseq) on the same Flax variables.

Tolerances:
- decode functions and ``decode_tablature``: none, equal values and notes;
- logits: 2e-3 absolute (the port's grouped CQT against JAX's full-bank
  XLA CQT, features within 2e-4, through the model);
- tablature: a cell may differ only where the JAX logits' top-two margin
  is within twice that, 4e-3 (both sides' logits may move by 2e-3);
- notes: identical on every string whose tablature is identical and whose
  margins all exceed 1e-4 (the JAX pipeline is one jitted program whose
  logits may differ from JAX's op-by-op forward in the last bits, enough to
  flip a near tie), and at least one string is compared.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.datasets import synthetic as jsynthetic
from amt_tools_tpu.features import CQT as JaxCQT
from amt_tools_tpu.models import TabCNN as JaxTabCNN
from amt_tools_tpu.ops import decode as jdecode
from amt_tools_tpu.serving import TablaturePipeline as JaxPipeline
from amt_tools_tpu.serving import \
    calibrate_tablature_activity as jax_calibrate

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.datasets import random_notes, render_notes
from amt_tools_tpu_torch.features import CQT
from amt_tools_tpu_torch.models import TabCNN
from amt_tools_tpu_torch.ops import decode
from amt_tools_tpu_torch.serving import (TablaturePipeline,
                                         calibrate_tablature_activity)
from amt_tools_tpu_torch.weights import from_flax

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

LOGIT_ATOL = 2e-3
SR = 22050
SECONDS = 3.0
RECIPE = dict(sample_rate=SR, hop_length=512, n_bins=192, bins_per_octave=24,
              exact='high', grouped='auto')


def _clips(profile, count, seconds, seed=0):
    rng = np.random.RandomState(seed)
    clips = []
    for b in range(count):
        pitches, intervals = random_notes(profile, seconds,
                                          int(2 * seconds), rng)
        clips.append(render_notes(pitches, intervals, SR, seconds, seed=b))
    return np.stack(clips)


@pytest.fixture(scope='module')
def served():
    """Audio, uncalibrated and calibrated Flax variables, the JAX logits
    and the JAX pipeline's notes."""

    profile = jtools.GuitarProfile(num_frets=19)
    audio = _clips(tools.GuitarProfile(num_frets=19), 2, SECONDS)

    jax_cqt = JaxCQT(**RECIPE)
    model = JaxTabCNN(dim_in=192, profile=profile, fullseq=True)
    feats = model.pre_proc(
        {jtools.KEY_FEATS: jax_cqt.process_jax(jnp.asarray(audio))})
    feats = feats[jtools.KEY_FEATS]
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        feats)
    calibrated = jax_calibrate(model, variables, jax_cqt, jnp.asarray(audio))
    raw = np.array(model.apply(calibrated, feats)[jtools.KEY_TABLATURE])

    pipeline = JaxPipeline(model, calibrated, jax_cqt, capacity=64)

    return audio, variables, calibrated, raw, pipeline(audio), pipeline


def _port_model(variables):
    model = TabCNN(dim_in=192, profile=tools.GuitarProfile(num_frets=19),
                   fullseq=True)
    model.load_state_dict(from_flax(variables))
    return model


def _top2_margin(raw):
    """(B, T, 6 * 21) logits -> (B, 6, T) margin of the best class over the
    second best."""

    top2 = np.sort(raw.reshape(raw.shape[:2] + (6, 21)), axis=-1)[..., -2:]
    return np.swapaxes(top2[..., 1] - top2[..., 0], -1, -2)


def _assert_same_notes(got, want):
    """Per-clip stacked notes: the same strings with identical notes."""

    assert len(got) == len(want)
    for got_clip, want_clip in zip(got, want):
        assert sorted(got_clip) == sorted(want_clip) == list(range(6))
        for string in range(6):
            np.testing.assert_array_equal(got_clip[string][0],
                                          want_clip[string][0])
            np.testing.assert_array_equal(got_clip[string][1],
                                          want_clip[string][1])


def test_pipeline_matches_jax_end_to_end(served):
    audio, _, calibrated, jax_raw, jax_notes, _ = served

    model = _port_model(calibrated)
    cqt = CQT(**RECIPE)
    pipe = TablaturePipeline(model, cqt, capacity=64, device='cpu')

    # Overlapped protocol: dispatch the next batch before finalizing
    first = pipe.dispatch(audio)
    second = pipe.dispatch(torch.from_numpy(audio))
    notes = pipe.finalize(first)
    _assert_same_notes(pipe.finalize(second), notes)

    with torch.no_grad():
        feats = cqt.process(torch.from_numpy(audio))
        raw = model(model.pre_proc({tools.KEY_FEATS: feats})[
            tools.KEY_FEATS])[tools.KEY_TABLATURE].numpy()
    np.testing.assert_allclose(raw, jax_raw, rtol=0, atol=LOGIT_ATOL)

    head = model.tablature_out
    tab = head.finalize_output(torch.from_numpy(raw)).numpy()
    jax_tab = head.finalize_output(torch.from_numpy(jax_raw)).numpy()
    margin = _top2_margin(jax_raw)
    assert (margin[tab != jax_tab] <= 2 * LOGIT_ATOL).all()
    assert (tab >= 0).any(), 'the calibrated model decodes no fret'

    tuning = tools.GuitarProfile(num_frets=19).get_midi_tuning()
    compared = 0
    for b in range(len(audio)):
        assert sorted(notes[b]) == list(range(6))
        for string in range(6):
            pitches, intervals = notes[b][string]
            assert np.all((pitches >= tuning[string]) &
                          (pitches <= tuning[string] + 19))
            if (np.array_equal(tab[b, string], jax_tab[b, string]) and
                    margin[b, string].min() > 1e-4):
                want_p, want_i = jax_notes[b][string]
                np.testing.assert_array_equal(pitches, want_p)
                np.testing.assert_array_equal(intervals, want_i)
                compared += 1
    assert compared > 0, 'no string was compared'


def test_calibrate_tablature_activity_matches_jax(served):
    audio, variables, calibrated, _, _, _ = served

    model = _port_model(variables)
    before = model.tablature_out.Dense_0.bias.detach().clone()
    shifts = calibrate_tablature_activity(model, CQT(**RECIPE), audio,
                                          device='cpu')

    want_bias = np.asarray(calibrated['params']['tablature_out']['Dense_0']
                           ['bias'])
    want = want_bias - np.asarray(variables['params']['tablature_out']
                                  ['Dense_0']['bias'])
    silence = np.arange(6) * 21 + 20
    assert shifts.shape == (6,)
    np.testing.assert_allclose(shifts, want[silence], rtol=0, atol=LOGIT_ATOL)

    # Only the silence-class biases moved, each by its string's shift
    got = model.tablature_out.Dense_0.bias.detach() - before
    expected = np.zeros(126, np.float32)
    expected[silence] = shifts
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=1e-6)


def _random_tablature(seed, batch=2, frames=40):
    rng = np.random.RandomState(seed)
    return rng.randint(-1, 20, (batch, 6, frames))


def test_decode_functions_bit_for_bit():
    """Every tablature conversion on dense random tablature."""

    profile, jprofile = tools.GuitarProfile(), jtools.GuitarProfile()
    tab = _random_tablature(7)
    port_tab, jax_tab = torch.from_numpy(tab), jnp.asarray(tab, jnp.int32)

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    stacked = decode.tablature_to_stacked_multi_pitch(port_tab, profile)
    jstacked = jdecode.tablature_to_stacked_multi_pitch(jax_tab, jprofile)
    assert stacked.shape == (2, 6, 44, 40) and stacked.dtype == torch.float32
    same(stacked, jstacked)

    same(decode.tablature_to_local_multi_pitch(port_tab, 20),
         jdecode.tablature_to_local_multi_pitch(jax_tab, 20))
    same(decode.stacked_multi_pitch_to_tablature(stacked, profile),
         jdecode.stacked_multi_pitch_to_tablature(jstacked, jprofile))
    same(decode.stacked_multi_pitch_to_tablature(stacked, profile), tab)
    same(decode.stacked_multi_pitch_to_multi_pitch(stacked),
         jdecode.stacked_multi_pitch_to_multi_pitch(jstacked))

    for silence in (False, True):
        logistic = decode.stacked_multi_pitch_to_logistic(stacked, profile,
                                                          silence)
        jlogistic = jdecode.stacked_multi_pitch_to_logistic(jstacked, jprofile,
                                                            silence)
        same(logistic, jlogistic)
        same(decode.logistic_to_tablature(logistic, profile, silence),
             jdecode.logistic_to_tablature(jlogistic, jprofile, silence))
        same(decode.logistic_to_tablature(logistic, profile, silence), tab)

    # Soft activations: the silence threshold and ties between frets
    soft = np.random.RandomState(8).randint(0, 4, (2, 120, 30)) / 40.0
    soft = soft.astype(np.float32)
    for thr in (0.05, 0.0):
        same(decode.logistic_to_tablature(torch.from_numpy(soft), profile,
                                          False, thr),
             jdecode.logistic_to_tablature(jnp.asarray(soft), jprofile,
                                           False, thr))

    multi_pitch = decode.stacked_multi_pitch_to_multi_pitch(stacked)
    same(decode.multi_pitch_to_offsets(multi_pitch),
         jdecode.multi_pitch_to_offsets(jnp.asarray(multi_pitch.numpy())))


def test_decode_tablature_matches_jax(served):
    """Identical notes from identical tablature, with the local-fret rows
    mapped back through the tuning."""

    _, _, calibrated, _, _, jax_pipeline = served
    tab = _random_tablature(9)
    times = np.arange(40) * 512 / SR

    pipe = TablaturePipeline(_port_model(calibrated), CQT(**RECIPE),
                             capacity=64, device='cpu')
    got = pipe.decode_tablature(tab, times)
    _assert_same_notes(got, jax_pipeline.decode_tablature(tab, times))
    assert sum(len(p) for clip in got for p, _ in clip.values()) > 0


def test_decode_tablature_overflow_redecode(served):
    _, _, calibrated, _, _, _ = served
    tab = _random_tablature(3)
    times = np.arange(40) * 512 / SR

    model = _port_model(calibrated)
    big = TablaturePipeline(model, CQT(**RECIPE), capacity=64, device='cpu')
    tiny = TablaturePipeline(model, CQT(**RECIPE), capacity=2, device='cpu')

    want = big.decode_tablature(tab, times)
    # Dense random tablature has more than 2 notes per string, so the tiny
    # pipeline must take the re-decode path
    assert any(len(p) > 2 for clip in want for p, _ in clip.values())

    _assert_same_notes(tiny.decode_tablature(tab, times), want)


def test_synthetic_audio_serves_a_guitar_profile():
    """``random_notes`` and ``render_notes`` read only ``profile.low`` and
    ``profile.high``, so they serve a ``GuitarProfile`` as they stand: the
    same notes and samples as the JAX package's."""

    for seed in (0, 1):
        got_p, got_i = random_notes(tools.GuitarProfile(), 5.0, 10,
                                    np.random.RandomState(seed))
        want_p, want_i = jsynthetic.random_notes(jtools.GuitarProfile(), 5.0,
                                                 10,
                                                 np.random.RandomState(seed))
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_array_equal(got_i, want_i)
        assert got_p.min() >= 40 and got_p.max() <= 83

        np.testing.assert_array_equal(
            render_notes(got_p, got_i, SR, 5.0, seed=seed),
            jsynthetic.render_notes(want_p, want_i, SR, 5.0, seed=seed))


def test_building_a_tablature_pipeline_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    model = TabCNN(dim_in=48, profile=tools.GuitarProfile())
    TablaturePipeline(model, CQT(n_bins=48), device='cpu')

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_tablature_entry_points_raise_without_a_device_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the default device is valid')

    model = TabCNN(dim_in=48, profile=tools.GuitarProfile())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TablaturePipeline(model, CQT(n_bins=48))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_tablature_activity(model, CQT(n_bins=48),
                                     np.zeros((1, 4000)))
