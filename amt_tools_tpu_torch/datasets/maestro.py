"""MAESTRO piano transcription dataset, V1 to V3 (host numpy and stdlib).

Counterpart of ``amt_tools_tpu/datasets/maestro.py``: the splits from the
corpus's CSV, ``.midi`` ground truth through the MAPS loader, and the
download of the official zip, unzipped and re-rooted
(``tools.change_base_dir``). A divergence by design: the CSV is read with
the standard library's ``csv`` module, where JAX uses ``pandas.read_csv``
(``:35-45``); the track lists are the same.
"""

import csv
import os

from .. import tools
from .common import TranscriptionDataset
from .maps import MAPS

__all__ = ['MAESTRO_V1', 'MAESTRO_V2', 'MAESTRO_V3']


class _MAESTRO(MAPS):
    """Any version of MAESTRO; ground-truth handling shared with MAPS."""

    # A class attribute, so a download can be pointed at another server
    GCS_BASE = 'https://storage.googleapis.com/magentadata/datasets/maestro'

    def __init__(self, base_dir=None, splits=None, hop_length=512,
                 sample_rate=16000, data_proc=None, profile=None,
                 num_frames=None, audio_norm=-1, split_notes=False,
                 reset_data=False, store_data=False, save_data=True,
                 save_loc=None, seed=0, preload_workers=0, device=None):
        super().__init__(base_dir, splits, hop_length, sample_rate, data_proc,
                         profile, num_frames, audio_norm, split_notes,
                         reset_data, store_data, save_data, save_loc, seed,
                         preload_workers, device)

    def get_tracks(self, split):
        """Track names for a split from the dataset's CSV metadata."""

        csv_file = [f for f in os.listdir(self.base_dir)
                    if f.endswith(f'.{tools.CSV_EXT}')][0]
        with open(os.path.join(self.base_dir, csv_file), newline='') as f:
            rows = list(csv.DictReader(f))

        tracks = [row['audio_filename'] for row in rows
                  if row['split'] == split]

        return sorted(os.path.splitext(track)[0] for track in tracks)

    def remove_overlapping(self, splits):
        raise NotImplementedError('MAESTRO splits are already disjoint.')

    def get_track_dir(self, track):
        raise NotImplementedError('MAESTRO tracks are addressed by year/name.')

    def get_wav_path(self, track):
        return os.path.join(self.base_dir, f'{track}.{tools.WAV_EXT}')

    def get_midi_path(self, track):
        return os.path.join(self.base_dir, f'{track}.{tools.MIDI_EXT}')

    @staticmethod
    def available_splits():
        """MAESTRO provides canonical train/validation/test partitions."""

        return ['train', 'validation', 'test']

    @classmethod
    def download(cls, save_dir):
        """Download the official zip and re-root the directory."""

        TranscriptionDataset.download(save_dir)

        print(f'Downloading {cls.dataset_name()}')

        url = f'{cls.GCS_BASE}/{cls.url_version()}/{cls.url_version()}.zip'

        zip_path = os.path.join(save_dir, os.path.basename(url))

        tools.stream_url_resource(url, zip_path)
        tools.unzip_and_remove(zip_path)

        # The zip holds a version directory; re-root its contents
        tools.change_base_dir(save_dir, os.path.join(save_dir, cls.url_version()))

    @staticmethod
    def url_version():
        raise NotImplementedError


class MAESTRO_V1(_MAESTRO):
    """MAESTRO V1 (~1184 performances)."""

    @staticmethod
    def url_version():
        return 'maestro-v1.0.0'


class MAESTRO_V2(_MAESTRO):
    """MAESTRO V2 (~1282 performances)."""

    @staticmethod
    def url_version():
        return 'maestro-v2.0.0'


class MAESTRO_V3(_MAESTRO):
    """MAESTRO V3 (~1276 performances)."""

    @staticmethod
    def url_version():
        return 'maestro-v3.0.0'
