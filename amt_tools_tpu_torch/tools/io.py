"""Audio, annotation and file I/O (host numpy and scipy).

Counterpart of ``amt_tools_tpu/tools/io.py``, every name of its ``__all__``:
WAV reading through ``scipy.io.wavfile`` with ``scipy.signal.resample_poly``
at the same ``Fraction`` ratio, RMS or Lp normalization and the 16-bit PCM
writer; the MIDI (:mod:`.midi`) and JAMS (:mod:`.jams_io`) readers and
writers re-exported; the text writers; and the file management of the
datasets' downloads. A divergence by design: ``stream_url_resource``
streams through ``urllib.request`` where JAX uses ``requests``, in the same
chunks, so the port needs no package beyond the standard library there.
The files written are the JAX package's byte for byte.
"""

import os
import shutil
import urllib.request
import zipfile
from fractions import Fraction

import numpy as np

from . import utils
from .jams_io import (extract_duration_jams, extract_notes_jams,
                      extract_pitch_list_jams, extract_stacked_notes_jams,
                      extract_stacked_pitch_list_jams, load_duration_jams,
                      load_jams, load_notes_jams, load_pitch_list_jams,
                      load_stacked_notes_jams, load_stacked_pitch_list_jams,
                      resample_multipitch, write_stacked_notes_jams)
from .midi import load_notes_midi, parse_midi_events, write_notes_midi

__all__ = [
    'load_audio',
    'load_normalize_audio',
    'resample_audio',
    'write_wav',
    'load_notes_midi',
    'write_notes_midi',
    'parse_midi_events',
    'load_jams',
    'extract_duration_jams', 'load_duration_jams',
    'extract_stacked_notes_jams', 'load_stacked_notes_jams',
    'extract_notes_jams', 'load_notes_jams',
    'extract_stacked_pitch_list_jams', 'load_stacked_pitch_list_jams',
    'extract_pitch_list_jams', 'load_pitch_list_jams',
    'resample_multipitch',
    'write_and_print',
    'write_list',
    'write_pitch_list',
    'write_notes',
    'write_stacked_notes_jams',
    'stream_url_resource',
    'unzip_and_remove',
    'zip_and_save',
    'change_base_dir',
    'file_sort',
]


def resample_audio(audio, orig_fs, target_fs):
    """Polyphase-resample mono audio from ``orig_fs`` to ``target_fs``."""

    from scipy.signal import resample_poly

    if orig_fs == target_fs:
        return audio

    ratio = Fraction(int(target_fs), int(orig_fs)).limit_denominator(10000)

    return resample_poly(audio, ratio.numerator, ratio.denominator).astype(np.float32)


def load_audio(wav_path, fs=None):
    """Load a WAV file as mono float32 audio, optionally resampled to ``fs``.

    Returns (audio, fs). Handles integer PCM (8/16/32-bit) and float WAVs.
    """

    from scipy.io import wavfile

    orig_fs, audio = wavfile.read(wav_path)

    # Integer PCM into [-1, 1]
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    elif audio.dtype == np.int32:
        audio = audio.astype(np.float32) / 2147483648.0
    elif audio.dtype == np.uint8:
        audio = (audio.astype(np.float32) - 128.0) / 128.0
    else:
        audio = audio.astype(np.float32)

    # Collapse to mono
    if audio.ndim > 1:
        audio = audio.mean(axis=-1)

    if fs is not None and fs != orig_fs:
        audio = resample_audio(audio, orig_fs, fs)
    else:
        fs = orig_fs

    return audio.astype(np.float32), fs


def load_normalize_audio(wav_path, fs=None, norm=-1):
    """Load audio from a file and normalize it (-1 = RMS, p = Lp norm,
    None = off)."""

    audio, fs = load_audio(wav_path, fs=fs)

    if norm == -1:
        audio = utils.rms_norm(audio)
    elif norm is not None:
        denom = np.linalg.norm(audio.astype(np.float64), ord=norm)
        if denom > 0:
            audio = (audio / denom).astype(np.float32)

    return audio, fs


def write_wav(path, audio, fs):
    """Write mono float audio to a 16-bit PCM WAV file."""

    from scipy.io import wavfile

    audio = np.clip(np.asarray(audio, dtype=np.float64), -1.0, 1.0)
    wavfile.write(path, int(fs), (audio * 32767).astype(np.int16))


def write_and_print(file, text, verbose=True, end=''):
    """Write text to a file and optionally echo it to the console."""

    text = str(text) + end

    try:
        file.write(text)
    finally:
        if verbose:
            print(text, end='')


def write_list(lst, path):
    """Write all items of a list to a file, one per line."""

    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)

    with open(path, 'w') as file:
        for i, item in enumerate(lst):
            end = '' if (i + 1) == len(lst) else '\n'
            write_and_print(file, item, verbose=False, end=end)


def write_pitch_list(times, pitches, path, places=3):
    """Write a pitch list as lines of ``frame_time pitch1 pitch2 ...``."""

    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)

    times = np.round(times, decimals=places)

    with open(path, 'w') as estim_file:
        for i in range(len(times)):
            line = f'{times[i]} {str(np.round(pitches[i], decimals=places))[1: -1]}'
            end = '' if (i + 1) == len(pitches) else '\n'
            write_and_print(estim_file, line, verbose=False, end=end)


def write_notes(pitches, intervals, path, places=3):
    """Write notes as lines of ``onset offset pitch``."""

    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)

    pitches = np.round(pitches, decimals=places)
    intervals = np.round(intervals, decimals=places)

    with open(path, 'w') as estim_file:
        for i in range(len(pitches)):
            line = f'{intervals[i][0]} {intervals[i][1]} {str(pitches[i])}'
            end = '' if (i + 1) == len(pitches) else '\n'
            write_and_print(estim_file, line, verbose=False, end=end)


def stream_url_resource(url, save_path, chunk_size=1024 * 1024):
    """Download a file at a URL by streaming it to disk in chunks.

    Raises ``urllib.error.HTTPError`` on an error status, before anything
    is written.
    """

    with urllib.request.urlopen(url) as response, \
            open(save_path, 'wb') as file:
        while True:
            chunk = response.read(chunk_size)
            if not chunk:
                break
            file.write(chunk)


def unzip_and_remove(zip_path, target=None):
    """Extract a zip file next to itself (or into ``target``) and delete it."""

    print(f'Unzipping {os.path.basename(zip_path)}')

    if target is None:
        target = os.path.dirname(zip_path)

    with zipfile.ZipFile(zip_path, 'r') as zip_ref:
        zip_ref.extractall(target)

    os.remove(zip_path)


def zip_and_save(dir_path, zip_path):
    """Zip the contents of a directory."""

    with zipfile.ZipFile(zip_path, mode='w') as zipf:
        for root, _, files in os.walk(dir_path):
            for file in files:
                absolute_path = os.path.join(root, file)
                relative_path = absolute_path.replace(dir_path, '')
                zipf.write(absolute_path, relative_path)


def change_base_dir(new_dir, old_dir):
    """Move the contents of ``old_dir`` into ``new_dir`` and remove ``old_dir``."""

    for content in os.listdir(old_dir):
        shutil.move(os.path.join(old_dir, content), os.path.join(new_dir, content))

    os.rmdir(old_dir)


def file_sort(file_name):
    """Sort key that orders numbered checkpoints numerically (500 < 1500):
    shortest first, then lexicographic."""

    return (len(file_name), file_name)
