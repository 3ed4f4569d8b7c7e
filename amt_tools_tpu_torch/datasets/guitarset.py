"""GuitarSet guitar transcription dataset (host numpy; features on ``device``).

Counterpart of ``amt_tools_tpu/datasets/guitarset.py``: six player splits
of 60 alphabetically consecutive tracks, per-string JAMS notes
(``tools.load_stacked_notes_jams``) to tablature and collapsed multi-pitch,
and the download of the annotation and mono-mic audio archives.
"""

import os

from .. import tools
from .common import TranscriptionDataset

__all__ = ['GuitarSet']


class GuitarSet(TranscriptionDataset):
    """GuitarSet: 360 guitar excerpts with per-string JAMS annotations."""

    ZENODO_FILES = ['annotation.zip', 'audio_mono-mic.zip']
    ZENODO_URL = 'https://zenodo.org/record/3371780/files'

    def __init__(self, base_dir=None, splits=None, hop_length=512,
                 sample_rate=44100, data_proc=None, profile=None,
                 num_frames=None, audio_norm=-1, split_notes=False,
                 reset_data=False, store_data=True, save_data=True,
                 save_loc=None, seed=0, preload_workers=0, device=None):
        if profile is None:
            profile = tools.GuitarProfile()

        super().__init__(base_dir, splits, hop_length, sample_rate, data_proc,
                         profile, num_frames, audio_norm, split_notes,
                         reset_data, store_data, save_data, save_loc, seed,
                         preload_workers, device)

    def get_tracks(self, split):
        """60 alphabetically consecutive tracks a player split."""

        jams_dir = os.path.join(self.base_dir, 'annotation')
        jams_paths = sorted(os.listdir(jams_dir))

        tracks = [os.path.splitext(path)[0] for path in jams_paths]

        split_start = int(split) * 60

        return tracks[split_start: split_start + 60]

    def load(self, track):
        """Ground truth from per-string JAMS notes: tablature, multi-pitch."""

        data = super().load(track)

        if not tools.query_dict(data, tools.KEY_AUDIO):
            audio, fs = tools.load_normalize_audio(self.get_wav_path(track),
                                                   fs=self.sample_rate,
                                                   norm=self.audio_norm)

            times = self.data_proc.get_times(audio)

            stacked_notes = tools.load_stacked_notes_jams(
                self.get_jams_path(track))

            stacked_multi_pitch = tools.stacked_notes_to_stacked_multi_pitch(
                stacked_notes, times, self.profile)

            tablature = tools.stacked_multi_pitch_to_tablature(
                stacked_multi_pitch, self.profile)

            multi_pitch = tools.stacked_multi_pitch_to_multi_pitch(
                stacked_multi_pitch)

            data.update({tools.KEY_FS: fs,
                         tools.KEY_AUDIO: audio,
                         tools.KEY_TABLATURE: tablature,
                         tools.KEY_MULTIPITCH: multi_pitch})

            if self.save_data:
                gt_path = self.get_gt_dir(track)
                os.makedirs(os.path.dirname(gt_path), exist_ok=True)
                tools.save_dict_npz(gt_path, data)

        return data

    def get_wav_path(self, track):
        return os.path.join(self.base_dir, 'audio_mono-mic',
                            f'{track}_mic.{tools.WAV_EXT}')

    def get_jams_path(self, track):
        return os.path.join(self.base_dir, 'annotation',
                            f'{track}.{tools.JAMS_EXT}')

    @staticmethod
    def available_splits():
        """Splits are the six player identifiers."""

        return ['00', '01', '02', '03', '04', '05']

    @classmethod
    def download(cls, save_dir):
        """Download the annotation and mono-mic audio archives."""

        TranscriptionDataset.download(save_dir)

        print(f'Downloading {cls.dataset_name()}')

        for file_name in cls.ZENODO_FILES:
            url = f'{cls.ZENODO_URL}/{file_name}'
            zip_path = os.path.join(save_dir, file_name)

            tools.stream_url_resource(url, zip_path)
            # Each archive extracts into the directory of its stem
            tools.unzip_and_remove(zip_path,
                                   os.path.join(save_dir, os.path.splitext(file_name)[0]))
