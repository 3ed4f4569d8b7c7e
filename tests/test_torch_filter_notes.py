"""``tools.filter_notes`` against the JAX package's, warnings included.

JAX's ``filter_notes`` takes ``suppress_warnings`` (default True) and,
when it is False, warns once for notes outside the profile's pitch range
and once for notes outside the time window, in that order. The port keeps
the signature, the warnings and their order, and filters the same notes;
its callers keep the default, so they stay silent.
"""

import warnings

import numpy as np
import pytest

from amt_tools_tpu import tools as jtools

from amt_tools_tpu_torch import tools

PITCHES = np.array([20.0, 60.0, 62.0, 109.0])
INTERVALS = np.array([[0.0, 1.0], [5.0, 6.0], [0.5, 1.5], [1.0, 2.0]])

PITCH_WARNING = ('Ignoring notes with nominal pitch exceeding supported '
                 'boundaries.')
TIME_WARNING = 'Ignoring notes outside specified time boundaries.'


def _both(**kwargs):
    """(port result, port warnings, JAX result, JAX warnings)."""

    results = []
    for module, profile in ((tools, tools.PianoProfile()),
                            (jtools, jtools.PianoProfile())):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            got = module.filter_notes(PITCHES, INTERVALS, profile, 0.0, 2.0,
                                      **kwargs)
        results += [got, [(w.category, str(w.message)) for w in caught]]

    return results


@pytest.mark.parametrize('kwargs', [{}, {'suppress_warnings': True},
                                    {'suppress_warnings': False}])
def test_filter_notes_matches_jax(kwargs):
    mine, my_warnings, theirs, their_warnings = _both(**kwargs)

    np.testing.assert_array_equal(mine[0], theirs[0])
    np.testing.assert_array_equal(mine[1], theirs[1])
    np.testing.assert_array_equal(mine[0], [62.0])
    assert my_warnings == their_warnings
    if kwargs.get('suppress_warnings', True):
        assert my_warnings == []
    else:
        assert my_warnings == [(RuntimeWarning, PITCH_WARNING),
                               (RuntimeWarning, TIME_WARNING)]


@pytest.mark.parametrize('module', [tools, jtools], ids=['port', 'jax'])
def test_filter_notes_warns_each_kind(module):
    with pytest.warns(RuntimeWarning, match='nominal pitch'):
        module.filter_notes([20.0], [[0.0, 1.0]], module.PianoProfile(),
                            suppress_warnings=False)
    with pytest.warns(RuntimeWarning, match='time boundaries'):
        module.filter_notes([60.0], [[5.0, 6.0]], module.PianoProfile(), 0.0,
                            2.0, suppress_warnings=False)


def test_callers_stay_silent():
    """``notes_to_multi_pitch`` filters out-of-range notes with the
    default: no warning, as before."""

    times = np.arange(10) * 0.1
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        tools.notes_to_multi_pitch(PITCHES, INTERVALS, times,
                                   tools.PianoProfile())
