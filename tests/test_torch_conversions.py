"""The port's copies of the JAX package's host helpers against the JAX
functions, on the cases of ``tests/test_tools_conversions.py`` and on
seeded random inputs: the notes, pitch-list, logistic and tablature
conversions, the activation filters and the timing helpers of
``tools/utils.py``, ``hz_to_midi`` and ``midi_to_note``, the constants, and
``ops.decode.pack_bits``/``unpack_bits``. Every result equals JAX's exactly
(the same numpy code), dtypes included; the dict and tensor helpers, which
act on torch tensors here and on JAX arrays there, give the same values.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.ops import decode as jdecode
from amt_tools_tpu.tools import constants as jconstants
from amt_tools_tpu.tools import instrument as jinstrument
from amt_tools_tpu.tools import utils as jutils

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.ops import decode
from amt_tools_tpu_torch.tools import constants, instrument, utils

RNG = np.random.RandomState(0)
PIANO = (tools.PianoProfile(), jtools.PianoProfile())
GUITAR = (tools.GuitarProfile(), jtools.GuitarProfile())


def _same(got, want):
    """Equal values, types and dtypes, through dicts, lists and tuples."""

    if isinstance(want, dict):
        return (isinstance(got, dict) and list(got) == list(want) and
                all(_same(got[k], want[k]) for k in want))
    if isinstance(want, (list, tuple)):
        return (type(got) is type(want) and len(got) == len(want) and
                all(_same(g, w) for g, w in zip(got, want)))
    if isinstance(want, np.ndarray):
        return (isinstance(got, np.ndarray) and got.dtype == want.dtype and
                got.shape == want.shape and
                np.array_equal(got, want, equal_nan=want.dtype.kind == 'f'))
    return type(got) is type(want) and (got == want or (got != got and
                                                        want != want))


def _notes():
    pitches = np.array([60.0, 64.0, 60.0, 60.0])
    intervals = np.array([[0.00, 0.52], [0.26, 0.77], [0.61, 1.02],
                          [0.00, 0.31]])
    return pitches, intervals


def _batched():
    return jutils.notes_to_batched_notes(*_notes())


def _stacked():
    return {40: (np.array([40.0, 43.0]), np.array([[0.0, 1.0], [1.2, 1.9]])),
            45: (np.array([45.0, 47.0, 45.0]),
                 np.array([[0.5, 1.5], [2.0, 2.5], [0.5, 0.9]])),
            50: (np.array([]), np.zeros((0, 2)))}


def _pitch_list():
    return [np.array([60.0, 64.2]), np.array([]), np.array([20.0, 61.0]),
            np.array([np.nan, -3.0, 70.0]), np.array([109.4])]


def _stacked_pitch_list():
    times = np.arange(4) * 0.1
    return {'E': (times, [np.array([40.0]), np.array([]), np.array([42.0]),
                          np.array([41.0])]),
            'A': (times, [np.array([]), np.array([45.0]), np.array([46.0]),
                          np.array([])])}


def _tablature():
    return RNG.randint(-1, GUITAR[0].num_pitches, size=(6, 25))


def _logistic(silence):
    tablature = _tablature()
    return jutils.tablature_to_logistic(tablature, GUITAR[1],
                                        silence=silence) * RNG.rand(1, 25)


def _acts():
    acts = (RNG.rand(4, 30) > 0.6).astype(np.float32)
    acts[0, 5] = 1
    acts[0, 4] = acts[0, 6] = 0
    return acts


# (name, args for the port, args for JAX): profiles differ by package
CASES = [
    ('cat_batched_notes', (_batched(), _batched()[:2])),
    ('sort_batched_notes', (_batched(),)),
    ('sort_batched_notes', (_batched(), 1)),
    ('filter_batched_note_repeats', (_batched(),)),
    ('transpose_batched_notes', (_batched(),)),
    ('stacked_notes_to_batched_notes',
     ({k: jutils.notes_to_batched_notes(*v) for k, v in _stacked().items()},)),
    ('batched_notes_to_hz', (_batched(),)),
    ('batched_notes_to_midi', (jutils.batched_notes_to_hz(_batched()),)),
    ('notes_to_midi', (np.array([440.0, 261.63]),)),
    ('offset_notes', (*_notes(), 3)),
    ('detect_overlap_notes', (_notes()[1],)),
    ('detect_overlap_notes', (np.array([[0.0, 1.0], [1.0, 2.0]]),)),
    ('batched_notes_to_stacked_notes', (_batched(),)),
    ('batched_notes_to_stacked_notes', (_batched().T, True, 4)),
    ('stacked_notes_to_hz', (_stacked(),)),
    ('stacked_notes_to_midi', (jutils.stacked_notes_to_hz(_stacked()),)),
    ('cat_stacked_notes', (_stacked(), _stacked())),
    ('filter_stacked_note_repeats', (_stacked(),)),
    ('stacked_notes_to_frets', (_stacked(),)),
    ('stacked_notes_to_frets', (_stacked(), [40, 45, 50])),
    ('find_pitch_bounds_stacked_notes', (_stacked(),)),
    ('pitch_list_to_multi_pitch', (_pitch_list()[:3], PIANO)),
    ('pitch_list_to_midi', (jutils.pitch_list_to_hz(_pitch_list()[:3]),)),
    ('clean_pitch_list', (_pitch_list(),)),
    ('pack_pitch_list', (np.arange(5) * 0.1, _pitch_list())),
    ('unpack_pitch_list',
     (jutils.pack_pitch_list(np.arange(5) * 0.1, _pitch_list()),)),
    ('contains_empties_pitch_list', (_pitch_list(),)),
    ('contains_empties_pitch_list', (_pitch_list()[:1],)),
    ('detect_overlap_pitch_list', (_pitch_list(),)),
    ('detect_overlap_pitch_list', ([np.array([60.0])],)),
    ('filter_pitch_list', (_pitch_list(), PIANO)),
    ('stacked_pitch_list_to_hz', (_stacked_pitch_list(),)),
    ('stacked_pitch_list_to_midi',
     (jutils.stacked_pitch_list_to_hz(_stacked_pitch_list()),)),
    ('stacked_pitch_list_to_stacked_multi_pitch',
     (_stacked_pitch_list(), GUITAR)),
    ('stacked_pitch_list_to_tablature', (_stacked_pitch_list(), GUITAR)),
    ('logistic_to_stacked_multi_pitch', (_logistic(True), GUITAR)),
    ('logistic_to_stacked_multi_pitch', (_logistic(False), GUITAR, False)),
    ('logistic_to_tablature', (_logistic(True), GUITAR, True)),
    ('logistic_to_tablature', (_logistic(False), GUITAR, False)),
    ('logistic_to_tablature', (_logistic(False), GUITAR, False, 0.3)),
    ('stacked_multi_pitch_to_logistic',
     (jutils.tablature_to_stacked_multi_pitch(_tablature(), GUITAR[1]),
      GUITAR)),
    ('stacked_multi_pitch_to_logistic',
     (jutils.tablature_to_stacked_multi_pitch(_tablature(), GUITAR[1]),
      GUITAR, True)),
    ('tablature_to_logistic', (_tablature(), GUITAR)),
    ('tablature_to_logistic', (_tablature(), GUITAR, True)),
    ('stacked_notes_to_stacked_onsets',
     (jutils.stacked_notes_to_midi(jutils.stacked_notes_to_hz(_stacked())),
      np.arange(30) * 0.1, GUITAR)),
    ('stacked_notes_to_stacked_offsets',
     (_stacked(), np.arange(30) * 0.1, GUITAR, 0.15)),
    ('blur_activations', (_acts(),)),
    ('blur_activations', (_acts(), np.array([[0.25, 0.5, 0.25]]), True,
                          True)),
    ('normalize_activations', (np.array([0.0, 2.0, -4.0]),)),
    ('normalize_activations', (np.zeros(3),)),
    ('threshold_activations', (np.array([0.2, 0.5, 0.9]),)),
    ('threshold_activations', (_acts() * 0.9, 0.4)),
    ('remove_activation_blips', (_acts(),)),
    ('interpolate_gaps', (np.array([0.0, 1.0, 0.0, 0.0, 4.0, 0.0, 2.0, 0.0]),)),
    ('interpolate_gaps', (np.array([5.0, -1.0, 7.0]), -1)),
    ('get_frame_times', (3.0, 16000, 512)),
]


def _split(args):
    """Each (port, JAX) pair of profiles to its package's side."""

    port = tuple(a[0] if isinstance(a, tuple) and len(a) == 2 and
                 hasattr(a[0], 'get_range_len') else a for a in args)
    jax = tuple(a[1] if isinstance(a, tuple) and len(a) == 2 and
                hasattr(a[1], 'get_range_len') else a for a in args)
    return port, jax


@pytest.mark.parametrize('name,args', CASES,
                         ids=[f'{n}-{i}' for i, (n, _) in enumerate(CASES)])
def test_copied_helper_equals_jax(name, args):
    port_args, jax_args = _split(args)
    want = getattr(jutils, name)(*copy.deepcopy(jax_args))
    got = getattr(utils, name)(*copy.deepcopy(port_args))

    assert _same(got, want), (got, want)


def test_the_copied_helpers_are_the_missing_names():
    """Every case runs a name the port copies, and every copied name of
    ``utils.__all__`` that takes only host arrays has a case."""

    copied = {name for name, _ in CASES}
    device_and_timing = {'dict_to_device', 'dict_detach', 'array_to_tensor',
                         'tensor_to_array', 'print_time',
                         'compute_time_difference'}
    start = utils.__all__.index('cat_batched_notes')
    assert copied | device_and_timing == set(utils.__all__[start:])


def test_round_trips_of_the_jax_cases():
    guitar = GUITAR[0]
    tablature = _tablature()
    for silence in (True, False):
        logistic = utils.tablature_to_logistic(tablature, guitar,
                                               silence=silence)
        assert logistic.shape == (6 * (guitar.num_pitches + silence), 25)
        np.testing.assert_array_equal(
            utils.logistic_to_tablature(logistic, guitar, silence=silence),
            tablature)
    np.testing.assert_array_equal(
        utils.logistic_to_stacked_multi_pitch(
            utils.tablature_to_logistic(tablature, guitar, silence=True),
            guitar, silence=True),
        utils.tablature_to_stacked_multi_pitch(tablature, guitar))

    pitch_list = [np.array([60.0]), np.array([]), np.array([61.0, 70.0])]
    multi_pitch = utils.pitch_list_to_multi_pitch(pitch_list, PIANO[0])
    recon = utils.multi_pitch_to_pitch_list(multi_pitch, PIANO[0])
    assert all(np.array_equal(a, b) for a, b in zip(recon, pitch_list))

    times, unpacked = utils.unpack_pitch_list(
        utils.pack_pitch_list(np.arange(3) * 0.1, pitch_list))
    assert all(np.array_equal(a, b) for a, b in zip(unpacked, pitch_list))

    acts = np.zeros((2, 6))
    acts[0, 2] = 1
    acts[1, 2:4] = 1
    out = utils.remove_activation_blips(acts)
    assert out[0].sum() == 0 and out[1].sum() == 2


def test_tensor_and_dict_helpers():
    """The device helpers move and detach torch tensors where JAX's place
    and stop-gradient JAX arrays; the values are JAX's."""

    x = RNG.rand(2, 3).astype(np.float32)
    track = {'a': x, 'nested': {'b': torch.ones(2, requires_grad=True)},
             's': 'str'}

    placed = utils.dict_to_device(track, 'cpu')
    assert isinstance(placed['a'], torch.Tensor)
    assert placed['a'].device.type == 'cpu'
    np.testing.assert_array_equal(
        placed['a'].numpy(),
        np.asarray(jutils.dict_to_device({'a': x})['a']))
    assert placed['s'] == 'str'

    detached = utils.dict_detach(track)
    assert not detached['nested']['b'].requires_grad
    assert detached['a'] is x

    tensor = utils.array_to_tensor(x, 'cpu')
    assert isinstance(tensor, torch.Tensor) and tensor.dtype == torch.float32
    np.testing.assert_array_equal(tensor.numpy(),
                                  np.asarray(jutils.array_to_tensor(x)))
    back = utils.tensor_to_array(tensor.to(torch.bfloat16))
    assert _same(back, jutils.tensor_to_array(
        jnp.asarray(x, dtype=jnp.bfloat16)).astype(np.float32))


def test_timing_helpers(capsys):
    utils.print_time(1.5, 'step')
    jutils.print_time(1.5, 'step')
    mine, theirs = capsys.readouterr().out.splitlines()
    assert mine == theirs == 'step time : 1.5 seconds'

    start = utils.get_current_time()
    elapsed = utils.compute_time_difference(start, pr=False)
    assert 0 <= elapsed < 60


def test_instrument_names():
    hz = np.array([27.5, 261.63, 440.0, 4186.01])
    assert _same(instrument.hz_to_midi(hz), jinstrument.hz_to_midi(hz))
    assert _same(instrument.hz_to_midi(440.0), jinstrument.hz_to_midi(440.0))
    midi = np.array([21, 60.4, 61, 108])
    assert instrument.midi_to_note(midi) == jinstrument.midi_to_note(midi)
    assert instrument.midi_to_note(69) == jinstrument.midi_to_note(69) == 'A4'


def test_constants_equal_jax():
    """Every constant the JAX package names, with its value; the paths of
    the tools directory are each package's own."""

    names = [n for n in dir(jconstants) if n.isupper()]
    assert set(names) <= set(dir(constants))
    for name in names:
        if name == 'TOOL_DIR':
            assert getattr(constants, name).endswith(
                'amt_tools_tpu_torch/tools')
            continue
        assert getattr(constants, name) == getattr(jconstants, name), name


@pytest.mark.parametrize('frames', [1, 8, 13, 16])
def test_pack_bits_equals_jax(frames):
    acts = (RNG.rand(2, 5, frames) > 0.5).astype(np.float32)

    packed = decode.pack_bits(torch.from_numpy(acts))
    want = np.asarray(jdecode.pack_bits(jnp.asarray(acts)))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), want)

    got = decode.unpack_bits(packed, frames)
    assert _same(got, jdecode.unpack_bits(want, frames))
    np.testing.assert_array_equal(got, acts)
