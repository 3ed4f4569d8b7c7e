"""Evaluation layer: scoring protocols and the validation loop (host).

Counterpart of ``amt_tools_tpu/evaluate.py`` with all 19 names of its
``__all__`` (``:28-51``): an ``Evaluator`` hierarchy whose
``process_track`` unpacks estimates and ground truth, scores them, tracks
a running results dictionary and writes or logs results;
``ComboEvaluator`` merges sub-evaluators; :func:`validate` drives the
loop, per track, online, or batched by bucket. Note-level and pitch-list
metrics use the port's copy of the native matcher (:mod:`.metrics`), with
the JAX package's semitone-to-cents conversion of pitch tolerances.
"""

import json
import os
import warnings
from abc import abstractmethod
from collections import defaultdict
from copy import deepcopy

import numpy as np

from . import tools
from .inference import run_offline, run_offline_batched, run_online
from .metrics import (precision_recall_f1_overlap, multipitch_metrics,
                      f_measure, EPSILON)

__all__ = [
    'validate',
    'average_results',
    'append_results',
    'log_results',
    'write_results',
    'pattern_match',
    'Evaluator',
    'ComboEvaluator',
    'LossWrapper',
    'StackedEvaluator',
    'StackedMultipitchEvaluator',
    'MultipitchEvaluator',
    'StackedNoteEvaluator',
    'NoteEvaluator',
    'StackedPitchListEvaluator',
    'PitchListEvaluator',
    'TablatureEvaluator',
    'SoftmaxAccuracy',
    'VelocityEvaluator',
]


##################################################
# EVALUATION LOOP                                #
##################################################


def validate(model, dataset, evaluator, estimator=None, online=False,
             bucket=0, batch_size=1, device=None):
    """Validation/evaluation loop over a dataset partition.

    For each track, run offline (or mock-real-time) inference on
    ``device`` (the card unless the caller names one) and score the
    predictions. With ``bucket`` > 0 whole tracks are padded to multiples
    of ``bucket`` frames and masked, with the valid frames equal to an
    unpadded run's. With ``batch_size`` > 1 (offline and bucketed only),
    tracks of the same bucketed length share one batched forward. Returns
    the averaged results.
    """

    device = tools.resolve_device(device)
    model.to(device)

    if batch_size > 1:
        if bucket and not online:
            return _validate_batched(model, dataset, evaluator, estimator,
                                     bucket, batch_size, device)
        warnings.warn('batch_size > 1 requires bucketed offline evaluation '
                      '(bucket > 0, online=False); falling back to the '
                      'per-track loop.', category=RuntimeWarning)

    for track_id in dataset.tracks:
        track_data = dataset.get_track_data(track_id)

        if online:
            predictions = run_online(track_data, model, estimator, device)
        else:
            predictions = run_offline(track_data, model, estimator,
                                      bucket=bucket, device=device)

        evaluator.process_track(predictions, track_data, track_id)

    return evaluator.average_results()


def _validate_batched(model, dataset, evaluator, estimator, bucket,
                      batch_size, device):
    """Bucketed batched evaluation: group tracks by padded length.

    Only track IDS are grouped up front; each chunk's data is (re)loaded
    right before its forward, so host memory holds at most ``batch_size``
    tracks at a time (repeat loads hit the dataset's RAM/npz caches).
    """

    groups = defaultdict(list)
    for track_id in dataset.tracks:
        # Cheap frame-count probe: the grouping pass must not load every
        # track's full data a second time. Duck-typed datasets without the
        # probe fall back to a full load.
        if hasattr(dataset, 'get_track_frames'):
            num_frames = dataset.get_track_frames(track_id)
        else:
            track_data = dataset.get_track_data(track_id)
            num_frames = np.asarray(track_data[tools.KEY_FEATS]).shape[-1]
        padded = -(-num_frames // bucket) * bucket
        groups[padded].append(track_id)

    for padded in sorted(groups):
        track_ids = groups[padded]
        for start in range(0, len(track_ids), batch_size):
            chunk = [dataset.get_track_data(track_id)
                     for track_id in track_ids[start: start + batch_size]]
            predictions = run_offline_batched(chunk, model, estimator,
                                              bucket=bucket, device=device)
            for track_data, preds in zip(chunk, predictions):
                track_id = tools.unpack_dict(track_data, tools.KEY_TRACK)
                evaluator.process_track(preds, track_data, track_id)

    return evaluator.average_results()


##################################################
# RESULTS PLUMBING                               #
##################################################


def average_results(results):
    """Average all tracked arrays/lists in a (nested) results dictionary."""

    average = deepcopy(results)

    for key in average.keys():
        if isinstance(average[key], dict):
            average[key] = average_results(average[key])
        elif isinstance(average[key], (np.ndarray, list)):
            average[key] = float(np.mean(average[key]))

    return average


def append_results(tracked_results, new_results):
    """Merge a new results dictionary into the running results."""

    tracked_results = deepcopy(tracked_results)

    for key in new_results.keys():
        if key not in tracked_results.keys():
            tracked_results[key] = new_results[key]
        elif isinstance(new_results[key], dict):
            tracked_results[key] = append_results(tracked_results[key], new_results[key])
        else:
            tracked_results[key] = np.append(tracked_results[key], new_results[key])

    return tracked_results


def log_results(results, writer, step=0, patterns=None, tag='', prnt=False):
    """Log a (nested) results dictionary as scalars (tensorboardX-style)."""

    for key in results.keys():
        entry = results[key]

        if isinstance(entry, dict):
            log_results(entry, writer, step, patterns, tag + f'/{key}', prnt)
        elif pattern_match(key, patterns) or patterns is None:
            writer.add_scalar(f'{tag}/{key}', entry, global_step=step)

            if prnt:
                print(json.dumps({'iter': step, f'{tag}/{key}': entry}))


def write_results(results, file, patterns=None, verbose=False):
    """Write a (nested) results dictionary to an open text file."""

    for key in results.keys():
        if isinstance(results[key], dict):
            tools.write_and_print(file, f'-----{key}-----', verbose, '\n')
            write_results(results[key], file, patterns, verbose)
            tools.write_and_print(file, '', verbose, '\n')
        elif pattern_match(key, patterns) or patterns is None:
            tools.write_and_print(file, f' {key} : {results[key]}', verbose, '\n')

    tools.write_and_print(file, '', verbose, '\n')


def pattern_match(query, patterns=None):
    """Whether the query partially matches any of the patterns."""

    return any(p in query for p in patterns) if patterns is not None else False


##################################################
# EVALUATORS                                     #
##################################################


class Evaluator(object):
    """Generic evaluator: unpack key, results key, optional write-through,
    pattern-filtered logging, and running results tracking."""

    def __init__(self, unpack_key=None, results_key=None, save_dir=None,
                 patterns=None, verbose=False):
        self.unpack_key = self.get_default_key() if unpack_key is None else unpack_key
        self.results_key = self.get_default_key() if results_key is None else results_key

        self.save_dir = None
        self.set_save_dir(save_dir)

        self.patterns = None
        self.set_patterns(patterns)

        self.verbose = None
        self.set_verbose(verbose)

        self.results = None
        self.reset_results()

    def set_save_dir(self, save_dir):
        self.save_dir = save_dir

        if self.save_dir is not None:
            os.makedirs(self.save_dir, exist_ok=True)

    def set_patterns(self, patterns):
        self.patterns = patterns

    def set_verbose(self, verbose):
        self.verbose = verbose

    def reset_results(self):
        self.results = dict()

    def average_results(self):
        """Average of the currently tracked results."""

        return average_results(self.results)

    @staticmethod
    @abstractmethod
    def get_default_key():
        raise NotImplementedError

    def unpack(self, estimated, reference):
        """Pull the relevant entries out of the estimate/ground-truth dicts."""

        estimated = tools.unpack_dict(estimated, self.unpack_key)
        reference = tools.unpack_dict(reference, self.unpack_key)

        if estimated is None:
            warnings.warn(f"Entry for key '{self.unpack_key}' not found in "
                          f'estimates.', category=RuntimeWarning)
        if reference is None:
            warnings.warn(f"Entry for key '{self.unpack_key}' not found in "
                          f'ground-truth.', category=RuntimeWarning)

        return estimated, reference

    @abstractmethod
    def evaluate(self, estimated, reference):
        raise NotImplementedError

    def write(self, results, track=None):
        """Write per-track results to a text file if saving is enabled."""

        if self.save_dir is not None:
            tag = tools.get_tag(track)

            if self.verbose:
                print(f'Evaluating track: {tag}')

            results_path = os.path.join(self.save_dir, f'{tag}.{tools.TXT_EXT}')
            os.makedirs(os.path.dirname(results_path), exist_ok=True)

            with open(results_path, 'w') as results_file:
                write_results(results, results_file, self.patterns, self.verbose)

    def process_track(self, estimated, reference, track=None):
        """Score one track, append to the running results, and write."""

        results = self.evaluate(*self.unpack(estimated, reference))

        self.results = append_results(self.results, results)

        self.write(results, track)

        return results

    def finalize(self, writer, step=0):
        """Log averaged results and reset tracking."""

        average = self.average_results()

        log_results(average, writer, step, patterns=self.patterns, tag=tools.VAL)

        self.reset_results()


class ComboEvaluator(Evaluator):
    """Package multiple evaluators, merging results under their keys."""

    def __init__(self, evaluators, save_dir=None, patterns=None, verbose=False):
        self.evaluators = evaluators

        super().__init__('combo', 'combo', save_dir, patterns, verbose)

    @staticmethod
    def get_default_key():
        raise NotImplementedError('ComboEvaluator has no default key.')

    def reset_results(self):
        for evaluator in getattr(self, 'evaluators', []):
            evaluator.reset_results()

    def average_results(self):
        average = dict()

        for evaluator in self.evaluators:
            results = average_results(evaluator.results)

            if tools.query_dict(average, evaluator.results_key):
                average[evaluator.results_key].update(results)
            else:
                average[evaluator.results_key] = results

        return average

    def process_track(self, estimated, reference, track=None):
        results = dict()

        for evaluator in self.evaluators:
            new_results = evaluator.evaluate(*evaluator.unpack(estimated, reference))

            if tools.query_dict(results, evaluator.results_key):
                results[evaluator.results_key].update(new_results)
            else:
                results[evaluator.results_key] = new_results

            evaluator.results = append_results(evaluator.results, new_results)

        self.write(results, track)

        return results


class LossWrapper(Evaluator):
    """Track, write, and log loss terms."""

    @staticmethod
    def get_default_key():
        return tools.KEY_LOSS

    def unpack(self, estimated, reference=None):
        loss = tools.unpack_dict(estimated, self.unpack_key)

        if loss is None:
            warnings.warn(f"Entry for key '{self.unpack_key}' not found in "
                          f'estimates.', category=RuntimeWarning)

        return loss, None

    def evaluate(self, estimated, reference=None):
        return tools.dict_to_array(estimated) if isinstance(estimated, dict) \
            else estimated


class StackedEvaluator(Evaluator):
    """Evaluator over stacked representations with optional slice averaging."""

    def __init__(self, average_slices=False, unpack_key=None, results_key=None,
                 save_dir=None, patterns=None, verbose=False):
        super().__init__(unpack_key, results_key, save_dir, patterns, verbose)

        self.average_slices = average_slices

    @staticmethod
    def average_slice_results(_results):
        """Collapse a per-slice results dictionary by averaging."""

        results = dict()

        for key in _results.keys():
            results = append_results(results, _results[key])

        return average_results(results)


class StackedMultipitchEvaluator(StackedEvaluator):
    """Frame-level P/R/F1 on (S, F, T) activation stacks via intersection."""

    @staticmethod
    def get_default_key():
        return tools.KEY_MULTIPITCH

    def evaluate(self, estimated, reference):
        estimated = tools.to_numpy(estimated)
        reference = tools.to_numpy(reference)

        flatten_shape = estimated.shape[:-2] + tuple([-1])

        est = np.reshape(estimated, flatten_shape)
        ref = np.reshape(reference, flatten_shape)

        num_correct = np.sum(est * ref, axis=-1)
        num_predicted = np.sum(est, axis=-1)
        num_ground_truth = np.sum(ref, axis=-1)

        precision = num_correct / (num_predicted + EPSILON)
        recall = num_correct / (num_ground_truth + EPSILON)

        # Epsilon-guarded harmonic mean (matches reference hmean usage)
        p_, r_ = precision + EPSILON, recall + EPSILON
        f1 = 2 * p_ * r_ / (p_ + r_) - EPSILON

        slice_keys = list(range(len(f1)))
        results = {slc: {tools.KEY_PRECISION: precision[slc],
                         tools.KEY_RECALL: recall[slc],
                         tools.KEY_F1: f1[slc]} for slc in slice_keys}

        if self.average_slices:
            results = self.average_slice_results(results)

        return results


class MultipitchEvaluator(StackedMultipitchEvaluator):
    """Frame-level P/R/F1 on a single (F, T) activation map."""

    def __init__(self, unpack_key=None, results_key=None, save_dir=None,
                 patterns=None, verbose=False):
        super().__init__(True, unpack_key, results_key, save_dir, patterns, verbose)

    def evaluate(self, estimated, reference):
        est = tools.multi_pitch_to_stacked_multi_pitch(tools.to_numpy(estimated))
        ref = tools.multi_pitch_to_stacked_multi_pitch(tools.to_numpy(reference))

        return super().evaluate(est, ref)


class StackedNoteEvaluator(StackedEvaluator):
    """Note-level P/R/F1 per slice (onset-only, or with offsets)."""

    def __init__(self, offset_ratio=None, average_slices=False, unpack_key=None,
                 results_key=None, save_dir=None, patterns=None, verbose=False):
        super().__init__(average_slices, unpack_key, results_key, save_dir,
                         patterns, verbose)

        self.offset_ratio = offset_ratio

    @staticmethod
    def get_default_key():
        return tools.KEY_NOTES

    def evaluate(self, estimated, reference):
        results = dict()

        keys_est, keys_ref = list(estimated.keys()), list(reference.keys())

        for k in range(len(keys_ref)):
            pitches_est, intervals_est = estimated[keys_est[k]]
            pitches_ref, intervals_ref = reference[keys_ref[k]]

            pitches_ref = tools.notes_to_hz(pitches_ref)
            pitches_est = tools.notes_to_hz(pitches_est)

            p, r, f, _ = precision_recall_f1_overlap(
                ref_intervals=intervals_ref, ref_pitches=pitches_ref,
                est_intervals=intervals_est, est_pitches=pitches_est,
                offset_ratio=self.offset_ratio)

            results.update({keys_est[k]: {tools.KEY_PRECISION: p,
                                          tools.KEY_RECALL: r,
                                          tools.KEY_F1: f}})

        if self.average_slices:
            results = self.average_slice_results(results)

        return results


class NoteEvaluator(StackedNoteEvaluator):
    """Note-level P/R/F1 on single (N, 3) batched-note collections."""

    def __init__(self, offset_ratio=None, unpack_key=None, results_key=None,
                 save_dir=None, patterns=None, verbose=False):
        super().__init__(offset_ratio, True, unpack_key, results_key, save_dir,
                         patterns, verbose)

    def evaluate(self, estimated, reference):
        notes_est = tools.batched_notes_to_notes(tools.to_numpy(estimated))
        notes_ref = tools.batched_notes_to_notes(tools.to_numpy(reference))

        stacked_notes_est = tools.notes_to_stacked_notes(*notes_est)
        stacked_notes_ref = tools.notes_to_stacked_notes(*notes_ref)

        return super().evaluate(stacked_notes_est, stacked_notes_ref)


class StackedPitchListEvaluator(StackedEvaluator):
    """Frame-level multi-F0 metrics per slice, per pitch tolerance.

    Tolerances are in semitones and are converted to cents for the matcher.
    """

    def __init__(self, pitch_tolerances=None, average_slices=False,
                 unpack_key=None, results_key=None, save_dir=None,
                 patterns=None, verbose=False):
        super().__init__(average_slices, unpack_key, results_key, save_dir,
                         patterns, verbose)

        if pitch_tolerances is None:
            pitch_tolerances = [1 / 2]

        self.pitch_tolerances = pitch_tolerances

    @staticmethod
    def get_default_key():
        return tools.KEY_PITCHLIST

    def evaluate(self, estimated, reference):
        keys_est, keys_ref = list(estimated.keys()), list(reference.keys())

        results = dict()

        for k in range(len(keys_ref)):
            times_est, pitches_est = estimated[keys_est[k]]
            times_ref, pitches_ref = reference[keys_ref[k]]

            pitches_ref = tools.pitch_list_to_hz(pitches_ref)
            pitches_est = tools.pitch_list_to_hz(pitches_est)

            slice_results = dict()
            for tol in self.pitch_tolerances:
                frame_metrics = multipitch_metrics(ref_time=times_ref,
                                                   ref_freqs=pitches_ref,
                                                   est_time=times_est,
                                                   est_freqs=pitches_est,
                                                   window=100.0 * tol)

                p, r = frame_metrics['Precision'], frame_metrics['Recall']
                f = f_measure(p, r)

                slice_results[f'{tol}'] = {tools.KEY_PRECISION: p,
                                           tools.KEY_RECALL: r,
                                           tools.KEY_F1: f}

            results.update({keys_est[k]: slice_results})

        if self.average_slices:
            results = self.average_slice_results(results)

        return results


class PitchListEvaluator(StackedPitchListEvaluator):
    """Frame-level multi-F0 metrics on single (times, pitch_list) pairs."""

    def __init__(self, pitch_tolerances=None, unpack_key=None, results_key=None,
                 save_dir=None, patterns=None, verbose=False):
        super().__init__(pitch_tolerances, True, unpack_key, results_key,
                         save_dir, patterns, verbose)

    def evaluate(self, estimated, reference):
        stacked_est = tools.pitch_list_to_stacked_pitch_list(*estimated)
        stacked_ref = tools.pitch_list_to_stacked_pitch_list(*reference)

        return super().evaluate(stacked_est, stacked_ref)


class TablatureEvaluator(Evaluator):
    """Tablature P/R/F1 over string/fret activations + TDR.

    TDR (tablature disambiguation rate) = correct string/fret predictions
    divided by correct pitch predictions.
    """

    def __init__(self, profile, unpack_key=None, results_key=None,
                 save_dir=None, patterns=None, verbose=False):
        super().__init__(unpack_key, results_key, save_dir, patterns, verbose)

        self.profile = profile

    @staticmethod
    def get_default_key():
        return tools.KEY_TABLATURE

    def evaluate(self, estimated, reference):
        estimated = tools.to_numpy(estimated).astype(int)
        reference = tools.to_numpy(reference).astype(int)

        # String/fret agreement straight off the (S, T) class ids: a
        # (string, frame) cell counts when both are active and the fret
        # matches (intersecting one-hot activations gives the same count)
        est_active = estimated != -1
        ref_active = reference != -1

        num_predicted = np.sum(est_active)
        num_ground_truth = np.sum(ref_active)
        num_correct_tablature = np.sum((estimated == reference) & ref_active)

        precision = num_correct_tablature / (num_predicted + EPSILON)
        recall = num_correct_tablature / (num_ground_truth + EPSILON)
        f1 = f_measure(precision, recall)

        # Pitch agreement ignores the string: per frame, the multisets of
        # sounded pitches intersect. Count via per-frame pitch histograms
        # (bincount over pitch x frame) — same count as intersecting
        # collapsed binary pitch maps for the 0/1 occupancy these class-id
        # tablatures produce.
        tuning = np.asarray(self.profile.get_midi_tuning())[:, None]
        num_pitches = self.profile.get_range_len()
        num_frames = estimated.shape[-1]
        frame_idx = np.broadcast_to(np.arange(num_frames), estimated.shape)

        def pitch_map(tablature, active):
            rows = (tablature + tuning - self.profile.low)[active]
            flat = rows * num_frames + frame_idx[active]
            counts = np.bincount(flat, minlength=num_pitches * num_frames)
            return counts.reshape(num_pitches, num_frames) > 0

        num_correct_multi_pitch = np.sum(pitch_map(estimated, est_active) &
                                         pitch_map(reference, ref_active))

        tdr = num_correct_tablature / (num_correct_multi_pitch + EPSILON)

        return {tools.KEY_PRECISION: precision,
                tools.KEY_RECALL: recall,
                tools.KEY_F1: f1,
                tools.KEY_TDR: tdr}


class SoftmaxAccuracy(Evaluator):
    """Per-class accuracy across softmax groups (e.g. strings)."""

    @staticmethod
    def get_default_key():
        return tools.KEY_TABLATURE

    def evaluate(self, estimated, reference):
        estimated = tools.to_numpy(estimated)
        reference = tools.to_numpy(reference)

        num_correct = np.sum(estimated == reference)
        accuracy = num_correct / reference.size

        return {tools.KEY_ACCURACY: accuracy}


class VelocityEvaluator(Evaluator):
    """Velocity regression quality at ground-truth note locations.

    Paired with ``OnsetsFrames2(estimate_velocity=True)`` (not ported yet;
    the evaluator scores any (O, T) velocity maps). Compares the estimated
    (O, T) velocity map against the reference map on cells where the
    reference is active: mean absolute error (in normalized [0, 1]
    velocity) and the fraction within ``tolerance`` (default 0.1, i.e. ~13
    MIDI velocity steps).

    Also reports ``mae_rescaled`` / ``within_tolerance_rescaled`` after a
    per-track least-squares linear fit of the estimates onto the reference —
    the normalization ``mir_eval.transcription_velocity`` applies before
    scoring (per-track loudness normalization makes absolute velocity
    recoverable only up to a per-track gain, so the field's standard metric
    removes that gain before applying the tolerance).
    """

    def __init__(self, unpack_key=None, results_key=None, save_dir=None,
                 patterns=None, verbose=False, tolerance=0.1):
        super().__init__(unpack_key, results_key, save_dir, patterns, verbose)
        self.tolerance = tolerance

    @staticmethod
    def get_default_key():
        return tools.KEY_VELOCITY

    def evaluate(self, estimated, reference):
        if estimated is None or reference is None:
            # Missing maps contribute nothing (vs. a fake perfect score that
            # would inflate the averaged results)
            return {}

        estimated = tools.to_numpy(estimated)
        reference = tools.to_numpy(reference)

        active = reference > 0

        if not np.any(active):
            # Nothing to score on a silent track — contribute nothing
            return {}

        est, ref = estimated[active], reference[active]
        errors = np.abs(est - ref)

        # Per-track LS rescale (slope + offset), as mir_eval's
        # transcription_velocity metrics do before applying the tolerance
        design = np.stack([est, np.ones_like(est)], axis=1)
        coef, *_ = np.linalg.lstsq(design, ref, rcond=None)
        rescaled_errors = np.abs(design @ coef - ref)

        return {'mae': float(np.mean(errors)),
                'within_tolerance': float(np.mean(errors <= self.tolerance)),
                'mae_rescaled': float(np.mean(rescaled_errors)),
                'within_tolerance_rescaled':
                    float(np.mean(rescaled_errors <= self.tolerance))}
