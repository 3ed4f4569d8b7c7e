"""Visualization: static plotters + iterative real-time visualizers.

Counterpart of ``amt_tools_tpu/tools/visualize.py`` (17 names, ``:15-33``):
the static plotters and the throttled iterative ``Visualizer`` hierarchy
used by the real-time demos. All plotting is host-side matplotlib, imported
only when a plot is drawn, so the module imports without matplotlib and
headless or compute-only use never touches a display backend. Array inputs
may be numpy arrays or tensors on any device (bf16 widened to float32,
``utils.to_numpy``).
"""

import numpy as np

from . import constants
from . import utils

__all__ = [
    'initialize_figure',
    'global_toolbar_disable',
    'get_dynamic_x_bounds',
    'get_dynamic_y_bounds',
    'plot_waveform',
    'plot_tfr',
    'plot_pitch_list',
    'plot_stacked_pitch_list',
    'plot_guitar_tablature',
    'plot_pianoroll',
    'plot_notes',
    'Visualizer',
    'WaveformVisualizer',
    'TFRVisualizer',
    'StackedPitchListVisualizer',
    'GuitarTablatureVisualizer',
    'PianorollVisualizer',
]


def _get_plt():
    import matplotlib.pyplot as plt

    return plt


def _host(x):
    """A numpy array of an array, a tensor (any device) or a list."""

    return utils.to_numpy(x)


def _init_axes(fig=None):
    plt = _get_plt()

    if fig is None:
        fig = plt.figure(tight_layout=True)
    if not len(fig.axes):
        fig.add_subplot(111)

    return fig, fig.axes[0]


def initialize_figure(figsize=None, interactive=False):
    """Create a new figure (optionally in interactive mode)."""

    plt = _get_plt()

    if interactive:
        plt.ion()

    return plt.figure(figsize=figsize, tight_layout=True)


def global_toolbar_disable():
    """Hide the matplotlib window toolbar for clean real-time displays."""

    import matplotlib

    matplotlib.rcParams['toolbar'] = 'None'


def get_dynamic_x_bounds(ax, x_values, scale_factor=1.0):
    """X-axis bounds covering the data, expanded by a scale factor."""

    x_values = _host(x_values)
    lo, hi = float(np.min(x_values)), float(np.max(x_values))
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * scale_factor

    return [mid - half, mid + half] if half > 0 else [lo - 1, hi + 1]


def get_dynamic_y_bounds(ax, y_values, scale_factor=1.2):
    """Y-axis bounds covering the data, expanded by a scale factor."""

    y_values = _host(y_values)
    lo, hi = float(np.min(y_values)), float(np.max(y_values))
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * scale_factor

    return [mid - half, mid + half] if half > 0 else [lo - 1, hi + 1]


##################################################
# STATIC PLOTTERS                                #
##################################################


def plot_waveform(samples, times=None, include_axes=True, color='k', fig=None):
    """Plot a mono waveform against time."""

    fig, ax = _init_axes(fig)

    samples = _host(samples)
    times = np.arange(len(samples)) if times is None else _host(times)

    ax.plot(times, samples, color=color, linewidth=0.5)

    if include_axes:
        ax.set_xlabel('Time (s)')
        ax.set_ylabel('Amplitude')
    else:
        ax.axis('off')

    ax.set_xlim(times[0], times[-1] if len(times) > 1 else times[0] + 1)

    return fig


def plot_tfr(tfr, times=None, include_axes=True, fig=None, cmap='magma'):
    """Plot a time-frequency representation (F x T) as an image."""

    fig, ax = _init_axes(fig)

    tfr = _host(tfr)
    if times is not None:
        times = _host(times)
    if tfr.ndim == 3:
        # Collapse a leading channel axis
        tfr = tfr.mean(axis=0)

    extent = None
    if times is not None and len(times) > 1:
        extent = [times[0], times[-1], 0, tfr.shape[0]]

    ax.imshow(tfr, origin='lower', aspect='auto', extent=extent, cmap=cmap)

    if include_axes:
        ax.set_xlabel('Time (s)')
        ax.set_ylabel('Frequency bin')
    else:
        ax.axis('off')

    return fig


def plot_pitch_list(times, pitch_list, hertz=False, point_size=5,
                    include_axes=True, color='k', label=None, fig=None):
    """Scatter-plot per-frame pitch observations."""

    fig, ax = _init_axes(fig)

    unrolled_times, unrolled_pitches = utils.unroll_pitch_list(
        _host(times), [_host(p) for p in pitch_list])

    ax.scatter(unrolled_times, unrolled_pitches, s=point_size, color=color,
               label=label)

    if include_axes:
        ax.set_xlabel('Time (s)')
        ax.set_ylabel('Pitch (Hz)' if hertz else 'Pitch (MIDI)')
    else:
        ax.axis('off')

    if label is not None:
        ax.legend()

    return fig


def plot_stacked_pitch_list(stacked_pitch_list, hertz=False, point_size=5,
                            include_axes=True, colors=None, fig=None):
    """Scatter-plot each slice of a stacked pitch list in its own color."""

    fig, ax = _init_axes(fig)

    for i, (key, (times, pitch_list)) in enumerate(stacked_pitch_list.items()):
        color = None if colors is None else colors[i % len(colors)]
        fig = plot_pitch_list(times, pitch_list, hertz=hertz,
                              point_size=point_size, include_axes=include_axes,
                              color=color or f'C{i}', label=str(key), fig=fig)

    return fig


def plot_guitar_tablature(tablature, times=None, profile=None, include_axes=True,
                          fig=None):
    """Plot tablature as fret numbers on string lines."""

    fig, ax = _init_axes(fig)

    tablature = _host(tablature)
    num_strings, num_frames = tablature.shape

    times = np.arange(num_frames) if times is None else _host(times)

    labels = constants.DEFAULT_GUITAR_LABELS[:num_strings]

    # One horizontal line per string
    for s in range(num_strings):
        ax.axhline(y=s, color='gray', linewidth=0.5, zorder=1)

    # Fret numbers at note onsets
    onset_map = utils.multi_pitch_to_onsets((tablature >= 0).astype(float))
    for s in range(num_strings):
        for t in np.where(onset_map[s] > 0)[0]:
            ax.text(times[t], s, str(int(tablature[s, t])),
                    ha='center', va='center', fontsize=8,
                    bbox=dict(boxstyle='round,pad=0.1', fc='white', ec='black',
                              linewidth=0.5), zorder=2)

    ax.set_yticks(range(num_strings))
    ax.set_yticklabels(labels)
    ax.set_ylim(-0.5, num_strings - 0.5)
    ax.set_xlim(times[0], times[-1] if len(times) > 1 else times[0] + 1)

    if include_axes:
        ax.set_xlabel('Time (s)' if times is not None else 'Frame')
        ax.set_ylabel('String')
    else:
        ax.axis('off')

    return fig


def plot_pianoroll(multi_pitch, times=None, profile=None, include_axes=True,
                   fig=None, cmap='gray_r'):
    """Plot a multi-pitch activation map as a pianoroll image."""

    fig, ax = _init_axes(fig)

    multi_pitch = _host(multi_pitch)
    if times is not None:
        times = _host(times)

    extent = None
    low = profile.low if profile is not None else 0
    if times is not None and len(times) > 1:
        extent = [times[0], times[-1], low, low + multi_pitch.shape[0]]

    ax.imshow(multi_pitch, origin='lower', aspect='auto', extent=extent,
              cmap=cmap)

    if include_axes:
        ax.set_xlabel('Time (s)')
        ax.set_ylabel('Pitch (MIDI)')
    else:
        ax.axis('off')

    return fig


def plot_notes(pitches, intervals, include_axes=True, color='k', fig=None):
    """Plot notes as horizontal bars (pitch vs time interval)."""

    fig, ax = _init_axes(fig)

    intervals = _host(intervals).reshape(-1, 2)

    for pitch, (onset, offset) in zip(np.atleast_1d(_host(pitches)),
                                      intervals):
        ax.plot([onset, offset], [pitch, pitch], color=color, linewidth=3,
                solid_capstyle='butt')

    if include_axes:
        ax.set_xlabel('Time (s)')
        ax.set_ylabel('Pitch (MIDI)')
    else:
        ax.axis('off')

    return fig


##################################################
# ITERATIVE VISUALIZERS                          #
##################################################


class Visualizer(object):
    """Base class for real-time visualizers with plot-frequency throttling."""

    def __init__(self, figsize=None, include_axes=True, plot_frequency=1):
        self.figsize = figsize
        self.include_axes = include_axes
        self.plot_frequency = max(1, plot_frequency)

        self.fig = None
        self.frame_counter = 0

    def increment_frame_count(self):
        self.frame_counter += 1

    def query_time_to_plot(self):
        """Whether enough frames have elapsed to re-draw."""

        return self.frame_counter % self.plot_frequency == 0

    def query_figure_exists(self):
        return self.fig is not None and len(self.fig.axes) > 0

    def pre_update(self):
        plt = _get_plt()

        if not self.query_figure_exists():
            self.fig = plt.figure(figsize=self.figsize, tight_layout=True)
            plt.ion()

    def post_update(self):
        if self.query_figure_exists():
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()

    def update(self, *args, **kwargs):
        """Throttled redraw entry point."""

        self.increment_frame_count()

        if not self.query_time_to_plot():
            return

        self.pre_update()
        self.paint(*args, **kwargs)
        self.post_update()

    def paint(self, *args, **kwargs):
        raise NotImplementedError

    def reset(self):
        self.frame_counter = 0

    def close(self):
        if self.fig is not None:
            _get_plt().close(self.fig)
            self.fig = None


class WaveformVisualizer(Visualizer):
    """Scrolling waveform display over a fixed-size sample buffer."""

    def __init__(self, figsize=None, include_axes=True, plot_frequency=1,
                 sample_rate=44100, buffer_size=44100):
        super().__init__(figsize, include_axes, plot_frequency)

        self.sample_rate = sample_rate
        self.buffer_size = buffer_size
        self.buffer = np.zeros(buffer_size, dtype=np.float32)
        self.current_sample = 0

    def paint(self, samples):
        samples = np.atleast_1d(_host(samples).astype(np.float32))

        n = min(len(samples), self.buffer_size)
        self.buffer = np.roll(self.buffer, -n)
        self.buffer[-n:] = samples[-n:]
        self.current_sample += len(samples)

        times = (np.arange(self.buffer_size) +
                 self.current_sample - self.buffer_size) / self.sample_rate

        self.fig.axes[0].clear() if self.fig.axes else None
        plot_waveform(self.buffer, times, self.include_axes, fig=self.fig)


class TFRVisualizer(Visualizer):
    """Scrolling time-frequency display over a fixed-size frame buffer."""

    def __init__(self, figsize=None, include_axes=True, plot_frequency=1,
                 sample_rate=22050, hop_length=512, num_bins=192, buffer_size=100):
        super().__init__(figsize, include_axes, plot_frequency)

        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.buffer_size = buffer_size
        self.buffer = np.zeros((num_bins, buffer_size), dtype=np.float32)
        self.current_frame = 0

    def paint(self, frames):
        frames = _host(frames).astype(np.float32)
        if frames.ndim == 3:
            frames = frames.mean(axis=0)
        if frames.ndim == 1:
            frames = frames[:, None]

        n = min(frames.shape[-1], self.buffer_size)
        self.buffer = np.roll(self.buffer, -n, axis=-1)
        self.buffer[:, -n:] = frames[:, -n:]
        self.current_frame += frames.shape[-1]

        times = (np.arange(self.buffer_size) + self.current_frame -
                 self.buffer_size) * self.hop_length / self.sample_rate

        if self.fig.axes:
            self.fig.axes[0].clear()
        plot_tfr(self.buffer, times, self.include_axes, fig=self.fig)


class StackedPitchListVisualizer(Visualizer):
    """Rolling display of a stacked pitch list within a time window."""

    def __init__(self, figsize=None, include_axes=True, plot_frequency=1,
                 time_window=5.0):
        super().__init__(figsize, include_axes, plot_frequency)

        self.time_window = time_window
        self.stacked_pitch_list = None

    def paint(self, stacked_pitch_list):
        if self.stacked_pitch_list is None:
            self.stacked_pitch_list = stacked_pitch_list
        else:
            self.stacked_pitch_list = utils.cat_stacked_pitch_list(
                self.stacked_pitch_list, stacked_pitch_list)

        # Keep only the most recent window
        latest = max((np.max(t) if len(t) else 0)
                     for t, _ in self.stacked_pitch_list.values())
        self.stacked_pitch_list = utils.slice_stacked_pitch_list(
            self.stacked_pitch_list, latest - self.time_window, latest)

        if self.fig.axes:
            self.fig.axes[0].clear()
        plot_stacked_pitch_list(self.stacked_pitch_list,
                                include_axes=self.include_axes, fig=self.fig)


class GuitarTablatureVisualizer(Visualizer):
    """Rolling fret-number display over a fixed-size frame buffer."""

    def __init__(self, figsize=None, include_axes=True, plot_frequency=1,
                 sample_rate=22050, hop_length=512, buffer_size=100):
        super().__init__(figsize, include_axes, plot_frequency)

        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.buffer_size = buffer_size
        self.buffer = np.full((6, buffer_size), -1, dtype=int)
        self.current_frame = 0

    def paint(self, tablature):
        tablature = _host(tablature)
        if tablature.ndim == 1:
            tablature = tablature[:, None]

        n = min(tablature.shape[-1], self.buffer_size)
        self.buffer = np.roll(self.buffer, -n, axis=-1)
        self.buffer[:, -n:] = tablature[:, -n:]
        self.current_frame += tablature.shape[-1]

        times = (np.arange(self.buffer_size) + self.current_frame -
                 self.buffer_size) * self.hop_length / self.sample_rate

        if self.fig.axes:
            self.fig.axes[0].clear()
        plot_guitar_tablature(self.buffer, times,
                              include_axes=self.include_axes, fig=self.fig)


class PianorollVisualizer(Visualizer):
    """Rolling pianoroll display over a fixed-size frame buffer."""

    def __init__(self, figsize=None, include_axes=True, plot_frequency=1,
                 sample_rate=16000, hop_length=512, num_pitches=88,
                 buffer_size=100, profile=None):
        super().__init__(figsize, include_axes, plot_frequency)

        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.buffer_size = buffer_size
        self.profile = profile
        self.buffer = np.zeros((num_pitches, buffer_size), dtype=np.float32)
        self.current_frame = 0

    def paint(self, multi_pitch):
        multi_pitch = _host(multi_pitch).astype(np.float32)
        if multi_pitch.ndim == 1:
            multi_pitch = multi_pitch[:, None]

        n = min(multi_pitch.shape[-1], self.buffer_size)
        self.buffer = np.roll(self.buffer, -n, axis=-1)
        self.buffer[:, -n:] = multi_pitch[:, -n:]
        self.current_frame += multi_pitch.shape[-1]

        times = (np.arange(self.buffer_size) + self.current_frame -
                 self.buffer_size) * self.hop_length / self.sample_rate

        if self.fig.axes:
            self.fig.axes[0].clear()
        plot_pianoroll(self.buffer, times, self.profile,
                       include_axes=self.include_axes, fig=self.fig)
