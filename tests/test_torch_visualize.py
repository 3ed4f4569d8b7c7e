"""The port's ``tools/visualize.py`` and ``train(vis_fnc=)`` against JAX's.

Mirrors ``tests/test_stream_visualize.py::test_static_plotters`` and
``::test_iterative_visualizers``: each plotter draws the same artists from
the same numpy inputs as the JAX plotter (line data, image arrays, scatter
offsets, text), also when the inputs are tensors (bf16 widened to
float32), and the iterative visualizers hold the same buffers and throttle
alike. ``train(vis_fnc=...)`` calls its function at the iterations JAX's
``train`` calls it, with the model and the optimizer.
"""

import subprocess
import sys

import matplotlib

matplotlib.use('Agg')

import numpy as np
import pytest
import torch

import jax
import optax

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.tools import visualize as jviz
from amt_tools_tpu.train import train as jax_train

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.models import OnsetsFrames2
from amt_tools_tpu_torch.tools import visualize as viz
from amt_tools_tpu_torch.train import train

torch.set_num_threads(1)


def _tone(fs=16000, dur=0.2):
    t = np.arange(int(fs * dur)) / fs
    return (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def _artists(fig):
    """What a figure's first axes draw, as comparable values."""

    ax = fig.axes[0]
    plt = matplotlib.pyplot
    drawn = {'lines': [line.get_xydata().tolist() for line in ax.lines],
             'images': [np.asarray(im.get_array()).tolist()
                        for im in ax.images],
             'extents': [list(im.get_extent()) for im in ax.images],
             'scatter': [np.asarray(c.get_offsets()).tolist()
                         for c in ax.collections],
             'texts': [(t.get_text(), t.get_position()) for t in ax.texts],
             'xlim': ax.get_xlim(), 'ylim': ax.get_ylim(),
             'labels': (ax.get_xlabel(), ax.get_ylabel())}
    plt.close(fig)

    return drawn


def _inputs():
    audio = _tone()
    times = np.arange(len(audio)) / 16000
    tfr = np.random.RandomState(0).rand(32, 50)
    mp = np.zeros((88, 50))
    mp[30, 10:30] = 1
    tabs = np.full((6, 20), -1)
    tabs[0, 5:10] = 3
    tabs[4, 12:15] = 7
    pitch_list = [np.array([60.0])] * 10

    return {
        'wave': (viz.plot_waveform, jviz.plot_waveform, (audio, times), {}),
        'tfr': (viz.plot_tfr, jviz.plot_tfr, (tfr, np.arange(50) * 0.032),
                {}),
        'roll': (viz.plot_pianoroll, jviz.plot_pianoroll,
                 (mp, np.arange(50) * 0.032),
                 {'profile': tools.PianoProfile()}),
        'notes': (viz.plot_notes, jviz.plot_notes,
                  (np.array([60.0, 64.0]), np.array([[0.1, 0.5],
                                                     [0.6, 1.0]])), {}),
        'tabs': (viz.plot_guitar_tablature, jviz.plot_guitar_tablature,
                 (tabs, np.arange(20) * 0.023), {}),
        'pl': (viz.plot_pitch_list, jviz.plot_pitch_list,
               (np.arange(10) * 0.032, pitch_list), {}),
        'spl': (viz.plot_stacked_pitch_list, jviz.plot_stacked_pitch_list,
                ({'E': (np.arange(10) * 0.032, pitch_list)},), {}),
    }


@pytest.mark.parametrize('name', sorted(_inputs()))
def test_static_plotters(tmp_path, name):
    port, jax_fn, args, kwargs = _inputs()[name]
    jax_kwargs = dict(kwargs)
    if 'profile' in kwargs:
        jax_kwargs['profile'] = jtools.PianoProfile()

    fig = port(*args, **kwargs)
    fig.savefig(tmp_path / f'{name}.png')
    assert (tmp_path / f'{name}.png').exists()
    mine = _artists(fig)
    theirs = _artists(jax_fn(*args, **jax_kwargs))
    assert mine == theirs

    # The same drawing from tensors, bf16 included (widened to float32)
    def as_tensor(x):
        if isinstance(x, np.ndarray) and x.dtype.kind == 'f' and x.ndim == 2:
            return torch.from_numpy(x).to(torch.bfloat16)
        return torch.from_numpy(x) if isinstance(x, np.ndarray) else x

    if name in ('tfr', 'roll'):
        tensor_args = (as_tensor(args[0]),) + args[1:]
        widened = (torch.from_numpy(args[0]).to(torch.bfloat16).float()
                   .numpy(),) + args[1:]
        assert _artists(port(*tensor_args, **kwargs)) == \
            _artists(jax_fn(*widened, **jax_kwargs))
    elif name in ('wave', 'notes', 'tabs'):
        tensor_args = tuple(torch.from_numpy(np.asarray(a)) for a in args)
        assert _artists(port(*tensor_args, **kwargs)) == mine


def test_iterative_visualizers():
    pairs = [
        (viz.WaveformVisualizer(sample_rate=16000, buffer_size=1600,
                                plot_frequency=2),
         jviz.WaveformVisualizer(sample_rate=16000, buffer_size=1600,
                                 plot_frequency=2),
         [np.zeros(160), np.ones(160), np.arange(2000) / 2000.0]),
        (viz.TFRVisualizer(num_bins=32, buffer_size=20),
         jviz.TFRVisualizer(num_bins=32, buffer_size=20),
         [np.random.RandomState(0).rand(32, 5), np.ones((1, 32, 3))]),
        (viz.GuitarTablatureVisualizer(buffer_size=20),
         jviz.GuitarTablatureVisualizer(buffer_size=20),
         [np.full((6, 3), 2), np.arange(6)]),
        (viz.PianorollVisualizer(buffer_size=20),
         jviz.PianorollVisualizer(buffer_size=20),
         [np.ones((88, 4)), np.zeros(88)]),
    ]
    for mine, theirs, updates in pairs:
        for i, update in enumerate(updates):
            mine.update(torch.from_numpy(np.asarray(update)) if i % 2
                        else update)
            theirs.update(update)
            assert (mine.fig is None) == (theirs.fig is None)
            np.testing.assert_array_equal(mine.buffer, theirs.buffer)
        mine.close()
        theirs.close()

    # First update (counter 1): throttled; second: draws
    wv = viz.WaveformVisualizer(sample_rate=16000, buffer_size=1600,
                                plot_frequency=2)
    wv.update(np.zeros(160))
    assert wv.fig is None
    wv.update(np.ones(160))
    assert wv.fig is not None
    wv.close()

    sv = viz.StackedPitchListVisualizer(time_window=1.0)
    jsv = jviz.StackedPitchListVisualizer(time_window=1.0)
    for start in (0, 5, 12):
        update = {'0': ((np.arange(5) + start) * 0.1,
                        [np.array([440.0])] * 5)}
        sv.update(update)
        jsv.update(update)
        for key in jsv.stacked_pitch_list:
            np.testing.assert_array_equal(sv.stacked_pitch_list[key][0],
                                          jsv.stacked_pitch_list[key][0])
    sv.close()
    jsv.close()


def test_module_imports_without_matplotlib():
    code = ('import sys; sys.modules["matplotlib"] = None; '
            'from amt_tools_tpu_torch.tools import visualize; '
            'print(len(visualize.__all__))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True).stdout

    assert out.strip() == '17'
    assert sorted(viz.__all__) == sorted(jviz.__all__)


DIM_IN, FRAMES = 16, 12


def _batch():
    rng = np.random.RandomState(0)
    return {
        tools.KEY_FEATS: rng.rand(2, 1, DIM_IN, FRAMES).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(2, 88, FRAMES) < 0.1).astype(
            np.float32),
    }


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize('iterations, checkpoints', [(5, 2), (4, 0)])
def test_vis_fnc_called_at_jax_iterations(tmp_path, iterations,
                                          checkpoints):
    loader = _Loader([_batch()])

    jax_calls = []
    jax_model = JaxOnsetsFrames2(dim_in=DIM_IN, profile=jtools.PianoProfile(),
                                 model_complexity=2)
    jax_train(jax_model, loader, optax.sgd(1e-3), iterations,
              checkpoints=checkpoints, log_dir=None,
              rng=jax.random.PRNGKey(0),
              vis_fnc=lambda model, state, it: jax_calls.append(it))

    calls = []
    model = OnsetsFrames2(dim_in=DIM_IN, profile=tools.PianoProfile(),
                          model_complexity=2)
    optimizer = torch.optim.SGD(model.parameters(), lr=1e-3)

    def vis(got_model, got_optimizer, iteration):
        assert got_model is model and got_optimizer is optimizer
        calls.append(iteration)

    train(model, loader, optimizer, iterations, checkpoints=checkpoints,
          log_dir=str(tmp_path), device='cpu', vis_fnc=vis)

    assert calls == jax_calls
    assert calls[-1] == iterations
