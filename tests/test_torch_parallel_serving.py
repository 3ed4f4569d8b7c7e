"""Data-parallel serving of the port against its one-process pipelines and
the JAX package's mesh pipeline, on the CPU.

The port runs one gloo group of 4 spawned ranks (``tests/torch_ranks.py``),
each serving 2 of a batch of 8 clips and returning all 8 clips' notes in
clip order; JAX serves the same batch on its 8-device virtual mesh.
Mirrors ``tests/test_serving.py:108-180``: the notes of the mesh pipeline
equal the one-process pipeline's bit for bit, in float32, bf16 and
int8-static (piano) and for the tablature pipeline; overflowing clips
re-decode to the notes a large capacity gives; a batch that does not
divide over the ranks is refused. Against JAX's mesh pipeline (float32,
the same Flax variables) PARITY.md's rule holds: logits within
``LOGIT_ATOL``, thresholded maps differing only where JAX's logit is within
``LOGIT_ATOL`` of the threshold, notes equal in every pitch row whose maps
agree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.features import MelSpec as JaxMelSpec
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.parallel import get_mesh as jax_get_mesh
from amt_tools_tpu.serving import TranscriptionPipeline as JaxPipeline
from amt_tools_tpu.serving import calibrate_activity as jax_calibrate

import torch_ranks
from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.datasets import random_notes, render_notes
from amt_tools_tpu_torch.features import CQT, MelSpec
from amt_tools_tpu_torch.ops import decode
from amt_tools_tpu_torch.serving import (calibrate_quant_stats,
                                         calibrate_tablature_activity)
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

LOGIT_ATOL = 2e-3


def _clips(profile, count, seconds, sample_rate, seed):
    rng = np.random.RandomState(seed)
    clips = []
    for b in range(count):
        pitches, intervals = random_notes(profile, seconds,
                                          int(4 * seconds), rng)
        clips.append(render_notes(pitches, intervals, sample_rate, seconds,
                                  seed=b))
    return np.stack(clips)


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    audio = _clips(tools.PianoProfile(), 8, 2.0, 16000, 0)
    guitar_audio = _clips(tools.GuitarProfile(num_frets=19), 8, 2.0, 22050,
                          1)

    jax_mel = JaxMelSpec(n_mels=torch_ranks.N_MELS)
    jax_model = JaxOnsetsFrames2(dim_in=torch_ranks.N_MELS,
                                 profile=jtools.PianoProfile(),
                                 model_complexity=2)
    feats = jax_model.pre_proc(
        {jtools.KEY_FEATS: jax_mel.process_jax(jnp.asarray(audio))})
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                        feats[jtools.KEY_FEATS][:1])
    variables = jax_calibrate(jax_model, variables, jax_mel,
                              jnp.asarray(audio[:2]))
    state = from_flax(variables)

    int8_spec = {'quant_acoustic': 'static', 'quant_lm': 'static'}
    int8_model = torch_ranks.piano_model(int8_spec, state)
    calibrate_quant_stats(int8_model, MelSpec(n_mels=torch_ranks.N_MELS),
                          audio[:2], device='cpu')

    guitar = torch_ranks.guitar_pipeline({}, None).model
    calibrate_tablature_activity(guitar, CQT(**torch_ranks.GUITAR_CQT),
                                 guitar_audio[:2], rate=0.1, device='cpu')

    piano = {'float32': ({}, state),
             'bfloat16': ({'dtype': torch.bfloat16}, state),
             'int8_static': (int8_spec, int8_model.state_dict())}
    inputs = {'audio': audio, 'piano': piano,
              'guitar': ({}, guitar.state_dict()),
              'guitar_audio': guitar_audio}
    ranks = torch_ranks.Ranks('serving_checks', 4,
                              tmp_path_factory.mktemp('serving'), inputs)

    # JAX's mesh pipeline and the one-process pipelines while ranks run
    jax_notes = JaxPipeline(jax_model, variables, jax_mel, capacity=256,
                            mesh=jax_get_mesh())(audio)
    jax_raw = jax_model.apply(variables, feats[jtools.KEY_FEATS])
    single = {name: torch_ranks.piano_pipeline(spec, weights)(audio)
              for name, (spec, weights) in piano.items()}
    single['guitar'] = torch_ranks.guitar_pipeline(
        {}, guitar.state_dict())(guitar_audio)

    return ranks.results(), single, (jax_notes, jax_raw), inputs


def _assert_same_notes(got, want):
    assert len(got) == len(want)
    for (p_got, i_got), (p_want, i_want) in zip(got, want):
        np.testing.assert_array_equal(p_got, p_want)
        np.testing.assert_array_equal(i_got, i_want)


@pytest.mark.parametrize('name', ['float32', 'bfloat16', 'int8_static'])
def test_mesh_pipeline_matches_one_process(served, name):
    ranks, single, _, _ = served

    assert sum(len(p) for p, _ in single[name]) > 0, 'no notes decoded'
    for result in ranks:
        first, second = result[name]
        # Every rank returns every clip, in clip order
        _assert_same_notes(first, single[name])
        _assert_same_notes(second, single[name])


def test_mesh_tablature_pipeline_matches_one_process(served):
    ranks, single, _, _ = served

    want = single['guitar']
    assert sum(len(p) for clip in want for p, _ in clip.values()) > 0
    for result in ranks:
        got = result['guitar']
        assert len(got) == len(want)
        for clip, ref in zip(got, want):
            assert sorted(clip) == sorted(ref)
            _assert_same_notes([clip[s] for s in sorted(clip)],
                               [ref[s] for s in sorted(ref)])


def test_mesh_pipeline_overflow_redecodes_completely(served):
    """A clip with more notes than capacity loses nothing on a mesh."""

    ranks, _, _, _ = served

    for result in ranks:
        small, large = result['overflow']
        assert any(len(p) > 8 for p, _ in large), 'fixture not dense enough'
        _assert_same_notes(small, large)


def test_mesh_pipeline_refuses_an_indivisible_batch(served):
    ranks, _, _, _ = served

    for result in ranks:
        assert result['indivisible'].startswith('ValueError')
        assert 'does not divide' in result['indivisible']


def _maps(logits):
    logits = torch.from_numpy(np.swapaxes(np.array(logits), -1, -2))
    return decode.threshold(decode.sigmoid(logits)).numpy() > 0


def test_mesh_pipeline_matches_jax_mesh_pipeline(served):
    """PARITY.md's rule between the port's and JAX's mesh pipelines."""

    ranks, _, (jax_notes, jax_raw), inputs = served
    audio = inputs['audio']
    spec, state = inputs['piano']['float32']
    model = torch_ranks.piano_model(spec, state).eval()
    with torch.no_grad():
        feats = MelSpec(n_mels=torch_ranks.N_MELS).process(
            torch.from_numpy(audio))
        raw = model(model.pre_proc({tools.KEY_FEATS: feats})[
            tools.KEY_FEATS])

    rows = np.zeros((len(audio), 88), dtype=bool)
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
        ref = np.asarray(jax_raw[key])
        got = raw[key].numpy()
        np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)
        differ = _maps(got) != _maps(ref)
        assert (np.abs(np.swapaxes(ref, -1, -2)[differ]) <= LOGIT_ATOL).all()
        rows |= differ.any(-1)

    low = tools.PianoProfile().low
    notes = ranks[0]['float32'][0]
    compared = 0
    for b, ((p_got, i_got), (p_ref, i_ref)) in enumerate(zip(notes,
                                                             jax_notes)):
        keep_got = ~rows[b][p_got.astype(int) - low]
        keep_ref = ~rows[b][p_ref.astype(int) - low]
        np.testing.assert_array_equal(p_got[keep_got], p_ref[keep_ref])
        np.testing.assert_array_equal(i_got[keep_got], i_ref[keep_ref])
        compared += int(keep_ref.sum())
    assert compared > 0, 'no notes compared'
