"""Transcription dataset base class and the seeded batch loader (host numpy).

Counterpart of ``amt_tools_tpu/datasets/common.py`` (``:22-514``):
:class:`TranscriptionDataset` with its default ``base_dir`` (a download on a
missing one), ``reset_data``, the RAM cache (``store_data``, preloaded by
``preload_workers`` threads), the npz caches of ground truth and features
(``save_data`` under ``save_loc``: ``get_gt_dir`` and ``get_feats_dir``,
the features keyed by the data module's ``features_name()``; the files and
paths are the JAX package's), random fixed-length crops
(``get_item(index, rng)``) that slice notes, stacked notes and pitch lists
with the frames, ``get_track_data`` and ``get_track_frames`` (the frame
count that bucketed evaluation groups tracks by); the native
:class:`DataLoader`, whose worker threads draw each item's crop seed in the
main thread; and :func:`collate`. The loader is kept, not swapped for
``torch.utils.data.DataLoader``, so a seed gives the same batches in both
packages. Features are computed by the data module's ``process_audio`` on
``device`` (the card unless the caller names one) and come back as host
numpy before they reach a cache; with ``num_workers`` the loader's threads
are the first to reach a kernel, and an exception in one reaches the
caller.
"""

import os
import shutil
import warnings
from abc import abstractmethod
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_futures

import numpy as np

from .. import tools

__all__ = ['TranscriptionDataset', 'DataLoader', 'collate']


class TranscriptionDataset(object):
    """Generic music transcription dataset."""

    def __init__(self, base_dir, splits, hop_length, sample_rate, data_proc,
                 profile, num_frames, audio_norm, split_notes, reset_data,
                 store_data, save_data, save_loc, seed, preload_workers=0,
                 device=None):
        if base_dir is None:
            base_dir = os.path.join(tools.DEFAULT_DATASETS_DIR,
                                    self.dataset_name())
        self.base_dir = base_dir

        if not os.path.isdir(self.base_dir):
            warnings.warn(f"Could not find dataset at specified path "
                          f"'{self.base_dir}'. Attempting to download...",
                          category=RuntimeWarning)
            self.download(self.base_dir)

        if splits is None:
            splits = self.available_splits()
        self.splits = splits

        self.hop_length = hop_length
        self.sample_rate = sample_rate

        if data_proc is None:
            from ..features import STFT
            data_proc = STFT(hop_length=self.hop_length,
                             sample_rate=self.sample_rate)
        self.data_proc = data_proc
        self.device = device

        if profile is None:
            profile = tools.PianoProfile()
        self.profile = profile

        if num_frames is None:
            # Transcribe whole tracks at a time
            self.seq_length = None
        else:
            # Maximum number of samples producing the desired frame count
            self.seq_length = int(max(self.data_proc.get_sample_range(num_frames)))
        self.num_frames = num_frames

        self.audio_norm = audio_norm
        self.split_notes = split_notes

        self.store_data = store_data
        self.save_data = save_data
        if save_loc is None:
            save_loc = tools.DEFAULT_FEATURES_GT_DIR
        self.save_loc = save_loc

        self.reset_data = reset_data
        for directory in (self.get_gt_dir(), self.get_feats_dir()):
            if os.path.exists(directory) and self.reset_data:
                shutil.rmtree(directory)
            if self.save_data:
                os.makedirs(directory, exist_ok=True)

        self.rng = np.random.RandomState(seed)

        self.tracks = []
        for split in self.splits:
            self.tracks += self.get_tracks(split)

        if self.store_data:
            self.data = {}
            if preload_workers and len(self.tracks) > 1:
                # Reading audio and parsing annotations is independent per
                # track (host work)
                with ThreadPoolExecutor(max_workers=preload_workers) as pool:
                    for track, data in zip(self.tracks,
                                           pool.map(self.load, self.tracks)):
                        self.data[track] = self._freeze_cached(data)
            else:
                for track in self.tracks:
                    self.data[track] = self._freeze_cached(self.load(track))

    @staticmethod
    def _freeze_cached(data):
        """Mark cached numpy arrays read-only: whole-track entries are
        handed out by reference, so an in-place edit downstream raises
        instead of corrupting the cache."""

        for value in data.values():
            if isinstance(value, np.ndarray):
                value.flags.writeable = False

        return data

    def __len__(self):
        return len(self.tracks)

    def __getitem__(self, index):
        """A random fixed-length slice of the indexed track, batch-ready."""

        return self.get_item(index)

    def get_item(self, index, rng=None):
        """:meth:`__getitem__` with an explicit crop RNG (a
        ``np.random.RandomState``; default: the dataset's own)."""

        data = self.get_track_data(self.tracks[index], rng=rng)
        data = tools.dict_to_dtype(data, dtype=tools.FLOAT32, copy=False)

        # Remove unbatchable entries
        for key in (tools.KEY_NOTES, tools.KEY_PITCHLIST, tools.KEY_FS):
            if tools.query_dict(data, key):
                data.pop(key)

        return data

    def calculate_feats(self, data):
        """Features (and frame times) of a track's audio: read from the
        features npz with ``save_data`` when it exists, else computed on
        ``device`` and, with ``save_data``, written to it."""

        if isinstance(data, dict):
            data = dict(data)  # a new dict; entries shared (keys only added)
        else:
            data = {tools.KEY_TRACK: data}

        track = data[tools.KEY_TRACK]

        feats_path = self.get_feats_dir(track)

        if self.save_data and os.path.exists(feats_path):
            feats_dict = tools.load_dict_npz(feats_path)
            feats = feats_dict[tools.KEY_FEATS]
            fs = feats_dict[tools.KEY_FS].item()
            hop_length = feats_dict[tools.KEY_HOP].item()
        else:
            feats = self.data_proc.process_audio(data[tools.KEY_AUDIO],
                                                 device=self.device)

            fs = self.data_proc.get_sample_rate()
            hop_length = self.data_proc.get_hop_length()

            if self.save_data:
                os.makedirs(os.path.dirname(feats_path), exist_ok=True)
                tools.save_dict_npz(feats_path, {tools.KEY_FS: fs,
                                                 tools.KEY_HOP: hop_length,
                                                 tools.KEY_FEATS: feats})

        if self.sample_rate != fs or self.hop_length != hop_length:
            warnings.warn("Loaded features' sampling rate or hop length "
                          'differs from expected.', category=RuntimeWarning)

        if tools.query_dict(data, tools.KEY_TIMES):
            times = data[tools.KEY_TIMES]
        else:
            times = self.data_proc.get_times(data[tools.KEY_AUDIO])
            data[tools.KEY_TIMES] = times

        data[tools.KEY_FEATS] = feats

        if self.store_data:
            self.data[track][tools.KEY_FEATS] = feats
            self.data[track][tools.KEY_TIMES] = times
            self._freeze_cached(self.data[track])

        return data

    def get_track_data(self, track_id, sample_start=None, seq_length=None,
                       snap_to_frame=True, rng=None):
        """Features + ground truth for a track, optionally sliced coherently.

        Full-length entries reference the RAM cache when ``store_data``;
        cropped array entries are fresh copies. ``rng`` overrides the
        dataset RNG for the crop draw.
        """

        if self.store_data:
            data = dict(self.data[track_id])
        else:
            data = self.load(track_id)

        if tools.KEY_FEATS not in data.keys():
            data.update(self.calculate_feats(data))

        if seq_length is None:
            if self.seq_length is None:
                return data
            seq_length = self.seq_length

        if sample_start is None:
            max_start = max(1, len(data[tools.KEY_AUDIO]) - seq_length)
            sample_start = (rng if rng is not None
                            else self.rng).randint(0, max_start)

        frame_start = sample_start // self.hop_length
        frame_end = frame_start + self.num_frames

        if snap_to_frame:
            sample_start = frame_start * self.hop_length

        sample_end = sample_start + seq_length

        data[tools.KEY_AUDIO] = np.array(
            data[tools.KEY_AUDIO][..., sample_start: sample_end])

        sec_start = sample_start / self.sample_rate
        sec_stop = sample_end / self.sample_rate

        if tools.query_dict(data, tools.KEY_NOTES):
            if isinstance(data[tools.KEY_NOTES], dict):
                # Stacked notes: slice each slice's batched representation
                temp = tools.apply_func_stacked_representation(
                    data[tools.KEY_NOTES],
                    lambda v: tools.notes_to_batched_notes(*v))
                temp = tools.apply_func_stacked_representation(
                    temp, tools.slice_batched_notes,
                    start_time=sec_start, stop_time=sec_stop)
                data[tools.KEY_NOTES] = tools.apply_func_stacked_representation(
                    temp, tools.batched_notes_to_notes)
            else:
                data[tools.KEY_NOTES] = tools.slice_batched_notes(
                    data[tools.KEY_NOTES], sec_start, sec_stop)

        if tools.query_dict(data, tools.KEY_PITCHLIST):
            if isinstance(data[tools.KEY_PITCHLIST], dict):
                data[tools.KEY_PITCHLIST] = tools.apply_func_stacked_representation(
                    data[tools.KEY_PITCHLIST],
                    lambda v: tools.slice_pitch_list(*v, start_time=sec_start,
                                                     stop_time=sec_stop))
            else:
                data[tools.KEY_PITCHLIST] = tools.slice_pitch_list(
                    *data[tools.KEY_PITCHLIST], sec_start, sec_stop)

        skipped_keys = [tools.KEY_AUDIO, tools.KEY_FS, tools.KEY_NOTES,
                        tools.KEY_PITCHLIST]

        return tools.slice_track(data, frame_start, frame_end, skipped_keys)

    def get_track_frames(self, track_id):
        """A track's whole-track feature frame count, as cheaply as possible
        (JAX ``:286-310``): from cached features or audio by the feature
        module's frame algebra, else from one load of the track; features
        are computed only when the track has neither."""

        if self.store_data and track_id in getattr(self, 'data', {}):
            data = self.data[track_id]
            if tools.query_dict(data, tools.KEY_FEATS):
                return int(np.asarray(data[tools.KEY_FEATS]).shape[-1])
            if tools.query_dict(data, tools.KEY_AUDIO):
                return int(self.data_proc.get_expected_frames(
                    data[tools.KEY_AUDIO]))

        data = self.load(track_id)
        if tools.query_dict(data, tools.KEY_FEATS):
            return int(np.asarray(data[tools.KEY_FEATS]).shape[-1])
        if tools.query_dict(data, tools.KEY_AUDIO):
            return int(self.data_proc.get_expected_frames(
                data[tools.KEY_AUDIO]))

        data.update(self.calculate_feats(data))
        return int(np.asarray(data[tools.KEY_FEATS]).shape[-1])

    @abstractmethod
    def get_tracks(self, split):
        """Track names associated with a dataset partition."""

        raise NotImplementedError

    @abstractmethod
    def load(self, track):
        """Ground truth for a track: the ground-truth npz with
        ``save_data`` when it exists (the children fill what is missing),
        and the track's name."""

        data = None

        gt_path = self.get_gt_dir(track)

        if self.save_data and os.path.exists(gt_path):
            data = tools.load_dict_npz(gt_path)

            if self.sample_rate != data[tools.KEY_FS].item():
                warnings.warn("Loaded track's sampling rate differs from "
                              'expected.', category=RuntimeWarning)

        if data is None:
            data = {}
        else:
            if tools.query_dict(data, tools.KEY_NOTES) and \
                    data[tools.KEY_NOTES].dtype == object:
                data[tools.KEY_NOTES] = tools.unpack_stacked_representation(
                    data[tools.KEY_NOTES])
            if tools.query_dict(data, tools.KEY_PITCHLIST) and \
                    data[tools.KEY_PITCHLIST].dtype == object:
                data[tools.KEY_PITCHLIST] = tools.unpack_stacked_representation(
                    data[tools.KEY_PITCHLIST])

        data[tools.KEY_TRACK] = track

        return data

    def get_gt_dir(self, track=None):
        """Ground-truth cache directory (or one track's cache path)."""

        path = os.path.join(self.save_loc, self.dataset_name(),
                            tools.GROUND_TRUTH_DIR)

        if track is not None:
            path = os.path.join(path, f'{track}.{tools.NPZ_EXT}')

        return path

    def get_feats_dir(self, track=None):
        """Feature cache directory (keyed by the feature module's name)."""

        path = os.path.join(self.save_loc, self.dataset_name(),
                            self.data_proc.features_name())

        if track is not None:
            path = os.path.join(path, f'{track}.{tools.NPZ_EXT}')

        return path

    @staticmethod
    @abstractmethod
    def available_splits():
        """Supported partitions for the dataset."""

        raise NotImplementedError

    @classmethod
    def dataset_name(cls):
        return cls.__name__

    @staticmethod
    def download(save_dir):
        """Prepare a fresh directory for a download (extended by children)."""

        if os.path.isdir(save_dir):
            shutil.rmtree(save_dir)

        os.makedirs(save_dir)


class DataLoader(object):
    """Native batching loader: shuffles track indices, collates crop dicts.

    Each iteration yields a dict of stacked numpy arrays; the loader is
    re-iterable (one pass per ``train()`` iteration). ``num_workers`` > 0
    prepares batches on a thread pool; crop starts then come from per-item
    RNGs seeded in the main thread, so the batches are a function of the
    seed alone, though not the ``num_workers=0`` stream (which consumes the
    dataset's own RNG).
    """

    def __init__(self, dataset, batch_size=1, shuffle=True, drop_last=False,
                 seed=0, num_workers=0, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self._pool = None

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)

        for start in range(0, len(order), self.batch_size):
            idcs = order[start: start + self.batch_size]
            if self.drop_last and len(idcs) < self.batch_size:
                break
            yield idcs

    def __iter__(self):
        if not self.num_workers:
            for idcs in self._batch_indices():
                yield collate([self.dataset[i] for i in idcs])
            return

        yield from self._iter_workers()

    def _make_batch(self, idcs, seeds):
        return collate([self.dataset.get_item(i, rng=np.random.RandomState(s))
                        for i, s in zip(idcs, seeds)])

    def _iter_workers(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                            thread_name_prefix='amt-loader')

        # Per-item crop seeds drawn up front in the main thread: the batch
        # stream does not depend on how the pool schedules the work
        jobs = [(idcs, self.rng.randint(0, 2**31 - 1, size=len(idcs)))
                for idcs in self._batch_indices()]

        depth = self.num_workers + self.prefetch
        pending = deque()
        try:
            for job in jobs:
                pending.append(self._pool.submit(self._make_batch, *job))
                if len(pending) >= depth:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            # A consumer that stops early must not leave work running into
            # the next pass
            for future in pending:
                future.cancel()
            wait_futures([f for f in pending if not f.cancelled()])


def collate(samples):
    """Stack a list of track dicts into one batch dict: arrays on a new
    leading axis, other entries into lists."""

    batch = {}
    for key in samples[0].keys():
        values = [sample[key] for sample in samples]
        if tools.utils._is_array(values[0]):
            batch[key] = np.stack([np.asarray(v) for v in values])
        else:
            batch[key] = values

    return batch
