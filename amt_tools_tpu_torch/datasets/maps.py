"""MAPS piano transcription dataset (host numpy; features on ``device``).

Counterpart of ``amt_tools_tpu/datasets/maps.py``: the nine piano-type
splits (``<piano>/MUS/<track>.{wav,mid}``), MIDI ground truth with the
sustain pedal (``tools.load_notes_midi``) and velocities on the MIDI scale,
multi-pitch, onset and offset maps with one hop of ambiguity,
``remove_overlapping``, and no download (MAPS is obtained by request).
"""

import os

from .. import tools
from .common import TranscriptionDataset

__all__ = ['MAPS']


class MAPS(TranscriptionDataset):
    """MAPS piano dataset (MIDI-annotated piano recordings, 9 piano types)."""

    def __init__(self, base_dir=None, splits=None, hop_length=512,
                 sample_rate=16000, data_proc=None, profile=None,
                 num_frames=None, audio_norm=-1, split_notes=False,
                 reset_data=False, store_data=True, save_data=True,
                 save_loc=None, seed=0, preload_workers=0, device=None):
        super().__init__(base_dir, splits, hop_length, sample_rate, data_proc,
                         profile, num_frames, audio_norm, split_notes,
                         reset_data, store_data, save_data, save_loc, seed,
                         preload_workers, device)

    def get_tracks(self, split):
        """Track names for one piano split (MUS pieces, without extension)."""

        split_dir = os.path.join(self.base_dir, split, 'MUS')
        split_paths = os.listdir(split_dir)

        # Three files (txt/midi/wav) a piece; collapse to unique stems
        return sorted(set(os.path.splitext(path)[0] for path in split_paths))

    def load(self, track):
        """Ground truth from MIDI (with the sustain pedal): maps and notes."""

        data = super().load(track)

        if not tools.query_dict(data, tools.KEY_AUDIO):
            audio, fs = tools.load_normalize_audio(self.get_wav_path(track),
                                                   fs=self.sample_rate,
                                                   norm=self.audio_norm)

            times = self.data_proc.get_times(audio)

            # (N, 4) notes with their MIDI velocities
            notes_velocity = tools.load_notes_midi(self.get_midi_path(track))
            batched_notes = notes_velocity[..., :-1]
            velocities = notes_velocity[..., -1]

            pitches, intervals = tools.batched_notes_to_notes(batched_notes)

            multi_pitch = tools.notes_to_multi_pitch(pitches, intervals, times,
                                                     self.profile)

            # One hop of ambiguity for onset/offset labels
            ambiguity = self.hop_length / self.sample_rate

            onsets = tools.notes_to_onsets(pitches, intervals, times,
                                           self.profile, ambiguity)
            offsets = tools.notes_to_offsets(pitches, intervals, times,
                                             self.profile, ambiguity)
            velocity = tools.notes_to_velocity(pitches, intervals, velocities,
                                               times, self.profile,
                                               midi_scale=True)

            data.update({tools.KEY_FS: fs,
                         tools.KEY_AUDIO: audio,
                         tools.KEY_MULTIPITCH: multi_pitch,
                         tools.KEY_ONSETS: onsets,
                         tools.KEY_OFFSETS: offsets,
                         tools.KEY_VELOCITY: velocity,
                         tools.KEY_NOTES: batched_notes})

            if self.save_data:
                gt_path = self.get_gt_dir(track)
                os.makedirs(os.path.dirname(gt_path), exist_ok=True)
                tools.save_dict_npz(gt_path, data)

        return data

    def remove_overlapping(self, splits):
        """Drop pieces that also appear (on other pianos) in ``splits``."""

        tracks = []
        for split in splits:
            tracks += self.get_tracks(split)

        # Strip the piano suffix to compare pieces
        tracks = ['_'.join(t.split('_')[:-1]) for t in tracks]
        self.tracks = [t for t in self.tracks
                       if '_'.join(t.split('_')[:-1]) not in tracks]

        if self.store_data:
            for key in list(self.data.keys()):
                if key not in self.tracks:
                    self.data.pop(key)

    def get_track_dir(self, track):
        """Directory of the piano (the suffix of the track name)."""

        piano = track.split('_')[-1]

        return os.path.join(self.base_dir, piano, 'MUS')

    def get_wav_path(self, track):
        return os.path.join(self.get_track_dir(track), f'{track}.{tools.WAV_EXT}')

    def get_midi_path(self, track):
        return os.path.join(self.get_track_dir(track), f'{track}.{tools.MID_EXT}')

    @staticmethod
    def available_splits():
        """Splits are the 9 piano types of the dataset."""

        return ['AkPnBcht', 'AkPnBsdf', 'AkPnCGdD',
                'AkPnStgb', 'ENSTDkAm', 'ENSTDkCl',
                'SptkBGAm', 'SptkBGCl', 'StbgTGd2']

    @staticmethod
    def download(save_dir):
        """MAPS has no public mirror; it must be obtained manually."""

        raise RuntimeError('MAPS must be requested and downloaded manually.')
