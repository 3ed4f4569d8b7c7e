"""Estimation layer: raw model predictions -> symbolic estimates (host).

Counterpart of ``amt_tools_tpu/transcribe.py`` with all 21 names of its
``__all__`` (``:21-44``): an ``Estimator`` hierarchy whose
``process_track`` runs pre_proc -> estimate -> write and packs the result
under the estimator's key, plus ``ComboEstimator`` for chaining. Estimates
are computed on host numpy by the conversions of ``tools.utils``, from
predictions that ``pre_proc`` brings back from the device
(``tools.dict_to_array``). ``DeviceNoteTranscriber`` decodes on the device
through ``ops.decode.notes_on_device``, on the card unless the caller names
another device.
"""

import os
from copy import deepcopy
from abc import abstractmethod

import numpy as np
import torch

from . import tools
from .ops import decode

__all__ = [
    'filter_notes_by_duration',
    'ComboEstimator',
    'Estimator',
    'MultiPitchWrapper',
    'StackedNoteTranscriber',
    'IterativeStackedNoteTranscriber',
    'NoteTranscriber',
    'DeviceNoteTranscriber',
    'NoteVelocityEstimator',
    'IterativeNoteTranscriber',
    'StackedMultiPitchRefiner',
    'MultiPitchRefiner',
    'StackedPitchListWrapper',
    'PitchListWrapper',
    'TablatureWrapper',
    'Collapser',
    'StackedMultiPitchCollapser',
    'StackedNotesCollapser',
    'StackedPitchListCollapser',
    'StackedOnsetsWrapper',
    'StackedOffsetsWrapper',
]


def filter_notes_by_duration(pitches, intervals, threshold=0.):
    """Remove notes shorter than ``threshold`` seconds (0 = non-zero only)."""

    batched_notes = tools.notes_to_batched_notes(pitches, intervals)
    durations = batched_notes[:, 1] - batched_notes[:, 0]

    if threshold:
        batched_notes = batched_notes[durations >= threshold]
    else:
        batched_notes = batched_notes[durations > threshold]

    return tools.batched_notes_to_notes(batched_notes)


class ComboEstimator(object):
    """Run multiple estimators in succession (order matters: later estimators
    may consume earlier estimates, e.g. refiners after transcribers)."""

    def __init__(self, estimators):
        self.estimators = estimators

    def process_track(self, raw_output, track=None):
        """Process a track with each estimator, accumulating estimates."""

        output = deepcopy(raw_output)

        for estimator in self.estimators:
            output.update(estimator.process_track(output, track))

        return output

    def set_save_dirs(self, save_dir, sub_dirs=None):
        """Set per-estimator save directories under ``save_dir``."""

        for i, estimator in enumerate(self.estimators):
            if sub_dirs is None:
                new_dir = save_dir
            elif sub_dirs[i] is None:
                new_dir = None
            else:
                new_dir = os.path.join(save_dir, sub_dirs[i])

            estimator.set_save_dir(new_dir)

    def reset_state(self):
        """Reset the state of all estimators in the combo."""

        for estimator in self.estimators:
            estimator.reset_state()


class Estimator(object):
    """Generic estimator: profile + estimates key + optional write-through."""

    def __init__(self, profile, estimates_key=None, save_dir=None):
        self.profile = profile

        self.estimates_key = self.get_default_key() if estimates_key is None \
            else estimates_key

        self.save_dir = None
        self.set_save_dir(save_dir)

    def set_save_dir(self, save_dir):
        """Set (and create) the directory estimates are written into."""

        self.save_dir = save_dir

        if self.save_dir is not None:
            os.makedirs(self.save_dir, exist_ok=True)

    @staticmethod
    @abstractmethod
    def get_default_key():
        """Default key describing this estimator's output."""

        raise NotImplementedError

    def pre_proc(self, raw_output):
        """Hook for extra steps; operates on a local numpy copy."""

        return tools.dict_to_array(deepcopy(raw_output))

    @abstractmethod
    def estimate(self, raw_output):
        """Obtain the estimate from the raw output."""

        raise NotImplementedError

    @abstractmethod
    def write(self, estimate, track):
        """Write an estimate to disk."""

        raise NotImplementedError

    def reset_state(self):
        """Reset any internal streaming state (no-op by default)."""

        pass

    def process_track(self, raw_output, track=None):
        """pre_proc -> estimate -> (write) -> pack under the estimates key."""

        raw_output = self.pre_proc(raw_output)
        estimate = self.estimate(raw_output)

        if self.save_dir is not None:
            self.write(estimate, track)

        return {self.estimates_key: estimate}


class MultiPitchWrapper(Estimator):
    """Pass-through + ``.npy`` writer for multi-pitch activation maps."""

    @staticmethod
    def get_default_key():
        return tools.KEY_MULTIPITCH

    def estimate(self, raw_output):
        return tools.unpack_dict(raw_output, self.estimates_key)

    def write(self, multi_pitch, track):
        tag = tools.get_tag(track)
        path = os.path.join(self.save_dir, f'{tag}')
        np.save(path, multi_pitch)


class StackedNoteTranscriber(Estimator):
    """Decode stacked multi-pitch maps (+ optional onsets/offsets) into
    per-slice note groups, with onset inhibition and duration filtering."""

    def __init__(self, profile, inhibition_window=None, minimum_duration=None,
                 multi_pitch_key=None, onsets_key=None, offsets_key=None,
                 estimates_key=None, save_dir=None):
        super().__init__(profile=profile, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.inhibition_window = inhibition_window
        self.minimum_duration = minimum_duration

        self.multi_pitch_key = tools.KEY_MULTIPITCH if multi_pitch_key is None else multi_pitch_key
        self.onsets_key = tools.KEY_ONSETS if onsets_key is None else onsets_key
        self.offsets_key = tools.KEY_OFFSETS if offsets_key is None else offsets_key

    @staticmethod
    def get_default_key():
        return tools.KEY_NOTES

    def estimate(self, raw_output):
        stacked_multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)
        stack_size = stacked_multi_pitch.shape[-3]

        times = tools.unpack_dict(raw_output, tools.KEY_TIMES)

        stacked_onsets = tools.unpack_dict(raw_output, self.onsets_key)
        stacked_offsets = tools.unpack_dict(raw_output, self.offsets_key)

        if stacked_onsets is None:
            stacked_onsets = [None] * stack_size
        if stacked_offsets is None:
            stacked_offsets = [None] * stack_size

        stacked_notes = {}

        for slc in range(stack_size):
            multi_pitch = stacked_multi_pitch[slc]
            onsets, offsets = stacked_onsets[slc], stacked_offsets[slc]

            if self.inhibition_window is not None:
                if onsets is None:
                    onsets = tools.multi_pitch_to_onsets(multi_pitch)
                # Remove onsets within the inhibition window of a previous one
                onsets = tools.inhibit_activations(onsets, times, self.inhibition_window)

            pitches, intervals = tools.multi_pitch_to_notes(
                multi_pitch, times, self.profile, onsets, offsets)

            if self.minimum_duration is not None:
                pitches, intervals = filter_notes_by_duration(
                    pitches, intervals, self.minimum_duration)

            stacked_notes.update(tools.notes_to_stacked_notes(pitches, intervals, slc))

        return stacked_notes

    def write(self, stacked_notes, track):
        tag = tools.get_tag(track)

        for key in stacked_notes.keys():
            slice_tag = f'{tag}_{key}' if len(stacked_notes) > 1 else f'{tag}'
            path = os.path.join(self.save_dir, f'{slice_tag}.{tools.TXT_EXT}')

            pitches, intervals = stacked_notes[key]
            tools.write_notes(pitches, intervals, path)


class IterativeStackedNoteTranscriber(StackedNoteTranscriber):
    """Stateful frame-at-a-time note tracking for online inference.

    Maintains the previous frame's activations and the onset time of each
    active pitch; emits completed notes when their activity ceases.
    """

    def __init__(self, profile, inhibition_window=None, minimum_duration=None,
                 multi_pitch_key=None, onsets_key=None, offsets_key=None,
                 estimates_key=None, save_dir=None):
        super().__init__(profile=profile, inhibition_window=inhibition_window,
                         minimum_duration=minimum_duration,
                         multi_pitch_key=multi_pitch_key, onsets_key=onsets_key,
                         offsets_key=offsets_key, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.previous_activations = None
        self.active_pitches = None

        self.reset_state()

    def reset_state(self):
        """Zero-out the streaming note-tracking state."""

        self.previous_activations = np.zeros((self.profile.get_num_dofs(),
                                              self.profile.get_range_len(), 1))
        self.active_pitches = np.zeros(self.previous_activations.shape)

    def estimate(self, raw_output):
        stacked_multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)
        stack_size = stacked_multi_pitch.shape[-3]

        time = np.asarray(tools.unpack_dict(raw_output, tools.KEY_TIMES)).flatten()[-1].item()

        stacked_onsets = tools.unpack_dict(raw_output, self.onsets_key)
        stacked_offsets = tools.unpack_dict(raw_output, self.offsets_key)

        # Append the new frame to the previous one for edge detection
        activations = np.concatenate((self.previous_activations,
                                      stacked_multi_pitch), axis=-1)

        if stacked_onsets is None:
            stacked_onsets = tools.stacked_multi_pitch_to_stacked_onsets(activations)[..., -1:]
        if stacked_offsets is None:
            stacked_offsets = tools.stacked_multi_pitch_to_stacked_offsets(activations)[..., :-1]

        # Onsets on already-active pitches terminate the existing note
        stacked_offsets = np.logical_or(
            stacked_offsets,
            np.logical_and(stacked_onsets, self.active_pitches)).astype(float)

        stacked_notes = {}

        for slc in range(stack_size):
            offsets = stacked_offsets[slc].squeeze(-1) == 1

            pitches = self.profile.get_midi_range()[offsets].astype(float)
            onset_times = self.active_pitches[slc, offsets]
            intervals = np.concatenate((onset_times,
                                        time * np.ones(onset_times.shape)), axis=-1)

            if self.minimum_duration is not None:
                pitches, intervals = filter_notes_by_duration(
                    pitches, intervals, self.minimum_duration)

            stacked_notes.update(tools.notes_to_stacked_notes(pitches, intervals, slc))

        # Update streaming state: clear finished notes, start new ones
        self.active_pitches[stacked_offsets == 1] = 0.
        self.active_pitches[stacked_onsets == 1] = time

        self.previous_activations = stacked_multi_pitch

        return stacked_notes

    def get_active_stacked_multi_pitch(self):
        """Currently-active notes as a stacked multi-pitch array."""

        stacked_multi_pitch = np.zeros(self.active_pitches.shape)
        stacked_multi_pitch[self.active_pitches != 0] = 1

        return stacked_multi_pitch

    def get_active_stacked_notes(self, current_time=None):
        """Currently-active notes as stacked notes (open-ended intervals)."""

        stacked_notes = {}

        active_pitch_onsets = self.active_pitches.squeeze(-1)

        for slc in range(active_pitch_onsets.shape[0]):
            active = active_pitch_onsets[slc] != 0
            pitches = self.profile.get_midi_range()[active].astype(float)
            onset_times = active_pitch_onsets[slc, active]

            if current_time is None:
                offset_times = onset_times
            else:
                offset_times = current_time * np.ones(onset_times.shape)

            intervals = np.stack((onset_times, offset_times), axis=-1)
            stacked_notes[slc] = (pitches, intervals)

        return stacked_notes


class NoteTranscriber(StackedNoteTranscriber):
    """Single-slice specialization: (F, T) multi-pitch -> (N, 3) notes."""

    def estimate(self, raw_output):
        multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)
        raw_output[self.multi_pitch_key] = tools.multi_pitch_to_stacked_multi_pitch(multi_pitch)

        onsets = tools.unpack_dict(raw_output, self.onsets_key)
        offsets = tools.unpack_dict(raw_output, self.offsets_key)

        if onsets is not None:
            raw_output[self.onsets_key] = tools.multi_pitch_to_stacked_multi_pitch(onsets)
        if offsets is not None:
            raw_output[self.offsets_key] = tools.multi_pitch_to_stacked_multi_pitch(offsets)

        output = super().estimate(raw_output)

        return tools.notes_to_batched_notes(*tools.stacked_notes_to_notes(output))

    def write(self, batched_notes, track):
        pitches, intervals = tools.batched_notes_to_notes(batched_notes)
        super().write(tools.notes_to_stacked_notes(pitches, intervals), track)


class DeviceNoteTranscriber(Estimator):
    """Single-slice note decode on the device.

    The O(F*T) note segmentation runs on ``device`` (the card unless the
    caller names one) through ``ops.decode.notes_on_device``, and only the
    fixed-capacity compact note buffers cross to the host. Output equals
    :class:`NoteTranscriber`'s without inhibition; ``minimum_duration``
    filtering runs on the decoded notes.
    """

    def __init__(self, profile, capacity=4096, minimum_duration=None,
                 multi_pitch_key=None, onsets_key=None, estimates_key=None,
                 save_dir=None, device=None):
        super().__init__(profile=profile, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.capacity = capacity
        self.minimum_duration = minimum_duration
        self.multi_pitch_key = tools.KEY_MULTIPITCH if multi_pitch_key is None else multi_pitch_key
        self.onsets_key = tools.KEY_ONSETS if onsets_key is None else onsets_key
        self.device = tools.resolve_device(device)

    @staticmethod
    def get_default_key():
        return tools.KEY_NOTES

    def _on_device(self, activations):
        return torch.as_tensor(np.asarray(activations)).to(self.device)

    def estimate(self, raw_output):
        multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)
        onsets = tools.unpack_dict(raw_output, self.onsets_key)
        times = tools.unpack_dict(raw_output, tools.KEY_TIMES)

        with torch.inference_mode():
            buffers = decode.notes_on_device(
                self._on_device(multi_pitch),
                None if onsets is None else self._on_device(onsets),
                capacity=self.capacity)
        rows, on, off, count = (tools.to_numpy(b) for b in buffers)

        pitches, intervals = decode.notes_from_device(
            rows, on, off, count, times, self.profile)

        if self.minimum_duration is not None:
            pitches, intervals = filter_notes_by_duration(
                pitches, intervals, self.minimum_duration)

        return tools.notes_to_batched_notes(pitches, intervals)

    def write(self, batched_notes, track):
        tag = tools.get_tag(track)
        path = os.path.join(self.save_dir, f'{tag}.{tools.TXT_EXT}')
        pitches, intervals = tools.batched_notes_to_notes(batched_notes)
        tools.write_notes(pitches, intervals, path)


class NoteVelocityEstimator(Estimator):
    """Attach per-note velocities to previously decoded notes.

    Chain after a note transcriber in a ``ComboEstimator``: reads the
    decoded (N, 3) batched notes and the model's (O, T) velocity map
    (``OnsetsFrames2(estimate_velocity=True)``) and emits an (N,) velocity
    per note — the value of the map at each note's onset
    (``tools.extract_note_velocities``).
    """

    def __init__(self, profile, notes_key=None, velocity_key=None,
                 estimates_key=None, save_dir=None, readout_window=5):
        super().__init__(profile=profile, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.notes_key = tools.KEY_NOTES if notes_key is None else notes_key
        self.velocity_key = tools.KEY_VELOCITY if velocity_key is None \
            else velocity_key
        # Average the map over each note's first few frames (clipped to its
        # span) instead of a single-frame readout — pools prediction noise
        self.readout_window = readout_window

    @staticmethod
    def get_default_key():
        return tools.KEY_NOTE_VELOCITY

    def estimate(self, raw_output):
        batched_notes = tools.unpack_dict(raw_output, self.notes_key)
        velocity = tools.unpack_dict(raw_output, self.velocity_key)
        times = tools.unpack_dict(raw_output, tools.KEY_TIMES)

        return tools.extract_note_velocities(batched_notes, velocity, times,
                                             self.profile,
                                             window=self.readout_window)

    def write(self, velocities, track):
        tag = tools.get_tag(track)
        path = os.path.join(self.save_dir, f'{tag}.{tools.TXT_EXT}')

        with open(path, 'w') as file:
            for value in np.atleast_1d(velocities):
                file.write(f'{value:.6f}\n')


class IterativeNoteTranscriber(IterativeStackedNoteTranscriber):
    """Single-slice streaming note tracker -> batched notes per frame."""

    def reset_state(self):
        self.previous_activations = np.zeros((1, self.profile.get_range_len(), 1))
        self.active_pitches = np.zeros(self.previous_activations.shape)

    def estimate(self, raw_output):
        multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)
        raw_output[self.multi_pitch_key] = tools.multi_pitch_to_stacked_multi_pitch(multi_pitch)

        onsets = tools.unpack_dict(raw_output, self.onsets_key)
        offsets = tools.unpack_dict(raw_output, self.offsets_key)

        if onsets is not None:
            raw_output[self.onsets_key] = tools.multi_pitch_to_stacked_multi_pitch(onsets)
        if offsets is not None:
            raw_output[self.offsets_key] = tools.multi_pitch_to_stacked_multi_pitch(offsets)

        stacked_notes = super().estimate(raw_output)

        return tools.notes_to_batched_notes(*tools.stacked_notes_to_notes(stacked_notes))


class StackedMultiPitchRefiner(MultiPitchWrapper):
    """Re-rasterize note estimates back into stacked multi-pitch maps
    (prediction smoothing)."""

    def __init__(self, profile, notes_key=None, estimates_key=None, save_dir=None):
        super().__init__(profile=profile, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.notes_key = tools.KEY_NOTES if notes_key is None else notes_key

    def estimate(self, raw_output):
        stacked_notes = tools.unpack_dict(raw_output, self.notes_key)
        times = tools.unpack_dict(raw_output, tools.KEY_TIMES)

        return tools.stacked_notes_to_stacked_multi_pitch(stacked_notes, times,
                                                          self.profile)


class MultiPitchRefiner(StackedMultiPitchRefiner):
    """Single-slice refiner: batched notes -> (F, T) multi-pitch."""

    def estimate(self, raw_output):
        batched_notes = tools.unpack_dict(raw_output, self.notes_key)
        pitches, intervals = tools.batched_notes_to_notes(batched_notes)

        times = tools.unpack_dict(raw_output, tools.KEY_TIMES)

        return tools.notes_to_multi_pitch(pitches, intervals, times, self.profile)


class StackedPitchListWrapper(Estimator):
    """Convert stacked multi-pitch maps to stacked pitch lists (txt writer)."""

    def __init__(self, profile, multi_pitch_key=None, estimates_key=None, save_dir=None):
        super().__init__(profile=profile, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.multi_pitch_key = tools.KEY_MULTIPITCH if multi_pitch_key is None else multi_pitch_key

    @staticmethod
    def get_default_key():
        return tools.KEY_PITCHLIST

    def estimate(self, raw_output):
        stacked_multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)
        times = tools.unpack_dict(raw_output, tools.KEY_TIMES)

        return tools.stacked_multi_pitch_to_stacked_pitch_list(
            stacked_multi_pitch, times, self.profile)

    def write(self, stacked_pitch_list, track):
        tag = tools.get_tag(track)

        for key in stacked_pitch_list.keys():
            slice_tag = f'{tag}_{key}' if len(stacked_pitch_list) > 1 else f'{tag}'
            path = os.path.join(self.save_dir, f'{slice_tag}.{tools.TXT_EXT}')

            times, pitch_list = stacked_pitch_list[key]
            tools.write_pitch_list(times, pitch_list, path)


class PitchListWrapper(StackedPitchListWrapper):
    """Convert a multi-pitch map to a (times, pitch_list) pair."""

    def estimate(self, raw_output):
        multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)
        times = tools.unpack_dict(raw_output, tools.KEY_TIMES)

        pitch_list = tools.multi_pitch_to_pitch_list(multi_pitch, self.profile)

        return times, pitch_list

    def write(self, pitch_list, track):
        stacked_pitch_list = tools.pitch_list_to_stacked_pitch_list(*pitch_list)
        super().write(stacked_pitch_list, track)


class TablatureWrapper(MultiPitchWrapper):
    """Expand tablature class indices into stacked multi-pitch maps."""

    def __init__(self, profile, tablature_key=None, estimates_key=None, save_dir=None):
        super().__init__(profile=profile, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.tablature_key = tools.KEY_TABLATURE if tablature_key is None else tablature_key

    def estimate(self, raw_output):
        tablature = tools.unpack_dict(raw_output, self.tablature_key)

        return tools.tablature_to_stacked_multi_pitch(tablature, self.profile)


class Collapser(Estimator):
    """Shared init for wrappers that collapse stacked representations."""

    def __init__(self, profile, stacked_key=None, estimates_key=None, save_dir=None):
        super().__init__(profile=profile, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.stacked_key = self.estimates_key if stacked_key is None else stacked_key


class StackedMultiPitchCollapser(Collapser, MultiPitchWrapper):
    """(S, F, T) stack -> (F, T) multi-pitch via max."""

    def estimate(self, raw_output):
        stacked_multi_pitch = tools.unpack_dict(raw_output, self.stacked_key)

        return tools.stacked_multi_pitch_to_multi_pitch(stacked_multi_pitch)


class StackedNotesCollapser(Collapser, NoteTranscriber):
    """Stacked notes -> single (N, 3) batched-notes representation."""

    def estimate(self, raw_output):
        stacked_notes = tools.unpack_dict(raw_output, self.stacked_key)

        return tools.notes_to_batched_notes(*tools.stacked_notes_to_notes(stacked_notes))


class StackedPitchListCollapser(Collapser, PitchListWrapper):
    """Stacked pitch list -> single (times, pitch_list) pair."""

    def estimate(self, raw_output):
        stacked_pitch_list = tools.unpack_dict(raw_output, self.stacked_key)

        return tools.stacked_pitch_list_to_pitch_list(stacked_pitch_list)


class StackedOnsetsWrapper(MultiPitchWrapper):
    """Edge-detect onset maps from stacked multi-pitch maps."""

    def __init__(self, profile, multi_pitch_key=None, estimates_key=None, save_dir=None):
        super().__init__(profile=profile, estimates_key=estimates_key,
                         save_dir=save_dir)

        self.multi_pitch_key = tools.KEY_MULTIPITCH if multi_pitch_key is None else multi_pitch_key

    @staticmethod
    def get_default_key():
        return tools.KEY_ONSETS

    def estimate(self, raw_output):
        stacked_multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)

        return tools.stacked_multi_pitch_to_stacked_onsets(stacked_multi_pitch)


class StackedOffsetsWrapper(StackedOnsetsWrapper):
    """Edge-detect offset maps from stacked multi-pitch maps."""

    @staticmethod
    def get_default_key():
        return tools.KEY_OFFSETS

    def estimate(self, raw_output):
        stacked_multi_pitch = tools.unpack_dict(raw_output, self.multi_pitch_key)

        return tools.stacked_multi_pitch_to_stacked_offsets(stacked_multi_pitch)
