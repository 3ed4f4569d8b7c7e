"""Offline transcription of an audio file: WAV in, notes out.

The port's twin of ``examples/inference/transcribe_file.py``.

Usage::

    python transcribe_file.py input.wav [checkpoint_dir] [output.txt] [device]

Loads the audio, extracts Mel features, runs Onsets & Frames (restoring the
latest checkpoint of ``train()`` from ``checkpoint_dir`` if given, else
seeded random weights for a smoke run), decodes notes, and writes them as
``onset offset pitch`` lines. The features and the model run on the card
(kernels A and B) unless ``device`` is ``cpu``.
"""

import os
import sys

# Runnable without installation: resolve the repo root
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

import torch

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2
from amt_tools_tpu_torch.transcribe import ComboEstimator, NoteTranscriber
from amt_tools_tpu_torch.inference import run_offline
from amt_tools_tpu_torch.train import latest_checkpoint, load_checkpoint


def main(wav_path, checkpoint_dir=None, out_path='notes.txt', device=None):
    sample_rate, hop_length = 16000, 512
    device = tools.resolve_device(device)

    profile = tools.PianoProfile()
    data_proc = MelSpec(sample_rate=sample_rate, hop_length=hop_length,
                        n_mels=229)

    print(f'Loading {wav_path}...')
    audio, _ = tools.load_normalize_audio(wav_path, fs=sample_rate, norm=-1)

    feats = data_proc.process_audio(audio, device=device)
    times = data_proc.get_times(audio)

    # Seeded weights, then restore a checkpoint if given
    model = OnsetsFrames2(dim_in=229, profile=profile, model_complexity=3,
                          generator=torch.Generator().manual_seed(0))
    model.to(device)

    if checkpoint_dir is not None:
        path, iteration = latest_checkpoint(checkpoint_dir)
        if path is None:
            raise FileNotFoundError(f'No checkpoint under {checkpoint_dir}')
        print(f'Restoring checkpoint at iteration {iteration}...')
        # The optimizer state comes along; train()'s recipes use Adam
        load_checkpoint(path, model, torch.optim.Adam(model.parameters()))

    estimator = ComboEstimator([NoteTranscriber(profile=profile)])

    track = {tools.KEY_FEATS: feats, tools.KEY_TIMES: times,
             tools.KEY_TRACK: 'input'}

    print('Transcribing...')
    predictions = run_offline(track, model, estimator, device=device)

    batched_notes = predictions[tools.KEY_NOTES]
    pitches, intervals = tools.batched_notes_to_notes(batched_notes)

    tools.write_notes(pitches, intervals, out_path)
    print(f'{len(pitches)} notes written to {out_path}')

    return pitches, intervals


if __name__ == '__main__':
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(1)
    main(*sys.argv[1:5])
