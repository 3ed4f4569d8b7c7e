"""Production batch serving: audio clips in, note lists out.

The port's twin of ``examples/inference/serve_batch.py``, demonstrating
:class:`amt_tools_tpu_torch.serving.TranscriptionPipeline`: feature
extraction (kernel A), the model forward (kernel B in its language models),
activation thresholding and the full note decode run on the card, and the
host receives fixed-capacity compact note buffers. Dispatch of batch n+1
overlaps finalization of batch n (the dispatch returns before the card is
done).

Run:  python serve_batch.py [checkpoint=<train() log_dir>] [batch_size=16]
                            [clip_seconds=20] [data_parallel=false]

With ``data_parallel=true`` run one process per card under ``torchrun``;
each serves its clips of every batch. Without a checkpoint the model serves
with activity-calibrated random weights (pipeline demonstration, not a
useful transcription).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

import numpy as np

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.config import Experiment

ex = Experiment('ServeBatch_OF2_MelSpec')


@ex.config
def config():
    # Number of clips per dispatched batch
    batch_size = 16

    # Seconds of audio per clip
    clip_seconds = 20

    # Checkpoint directory (from train()) to serve; empty = random weights
    # with activity-calibrated output biases
    checkpoint = ''

    # Shard clips across the ranks torchrun starts (batch must divide their
    # count)
    data_parallel = False

    # Maximum notes decoded per clip on device
    capacity = 1024

    # Serve the acoustic conv stacks as int8 contractions (ops/qconv.py):
    # 'static' = calibrated per-layer activation scales, true =
    # calibration-free dynamic scales, false = bf16 only
    quant = False

    # Where the pipeline runs: None -> the card, 'cpu' -> the plain versions
    device = None


@ex.automain
def serve(batch_size, clip_seconds, checkpoint, data_parallel, capacity,
          quant, device):
    import torch

    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.serving import TranscriptionPipeline
    from amt_tools_tpu_torch.datasets import render_notes, random_notes

    sample_rate, hop = 16000, 512
    device = tools.resolve_device(device)

    profile = tools.PianoProfile()
    data_proc = MelSpec(sample_rate=sample_rate, hop_length=hop, n_mels=229)
    model = OnsetsFrames2(dim_in=229, profile=profile, model_complexity=3,
                          dtype=torch.bfloat16, quant_acoustic=quant,
                          generator=torch.Generator().manual_seed(0))

    # --- parameters: trained checkpoint or calibrated random init ---
    rng = np.random.RandomState(0)

    def probe_batch():
        # Built lazily: only the calibration paths below consume it
        return np.stack([render_notes(*random_notes(profile, clip_seconds,
                                                    30, rng),
                                      sample_rate, clip_seconds, seed=b)
                         for b in range(2)])

    if checkpoint:
        from amt_tools_tpu_torch.train import (latest_checkpoint,
                                               load_checkpoint)

        path, iteration = latest_checkpoint(checkpoint)
        if path is None:
            raise FileNotFoundError(f'No checkpoint under {checkpoint}')

        # The optimizer state comes along: train()'s recipes use Adam (a
        # checkpoint of another optimizer needs that optimizer here)
        model.to(device)
        load_checkpoint(path, model, torch.optim.Adam(model.parameters()))
        print(f'serving checkpoint at iteration {iteration}: {path}')
    if quant == 'static' or not checkpoint:
        probe = probe_batch()

    if quant == 'static':
        # Static int8 needs calibrated activation scales before any forward
        # is interpreted (serve on representative-loudness audio)
        from amt_tools_tpu_torch.serving import calibrate_quant_stats
        calibrate_quant_stats(model, data_proc, probe, device=device)

    if not checkpoint:
        # Random weights stay silent (sparse-activity prior); calibrate the
        # output biases to trained-model-like firing rates for the demo
        from amt_tools_tpu_torch.serving import calibrate_activity
        calibrate_activity(model, data_proc, probe, device=device)

    mesh = None
    if data_parallel:
        from amt_tools_tpu_torch.parallel import get_mesh
        mesh = get_mesh(device=device)
        print(f'data-parallel serving over {mesh.size()} ranks')

    pipeline = TranscriptionPipeline(model, data_proc, capacity=capacity,
                                     device=device, mesh=mesh)

    # --- synthesize a stream of batches (stand-in for real traffic) ---
    def make_batch(seed):
        clips = []
        r = np.random.RandomState(seed)
        for b in range(batch_size):
            pitches, intervals = random_notes(profile, clip_seconds, 30, r)
            clips.append(render_notes(pitches, intervals, sample_rate,
                                      clip_seconds, seed=seed * 997 + b))
        return np.stack(clips)

    batches = [make_batch(s) for s in range(4)]

    # Warm-up (cuDNN's algorithm choice, the kernels' first launch)
    pipeline(batches[0])

    # Steady-state serving loop: overlap dispatch n+1 with finalize n
    start = time.perf_counter()
    pending = pipeline.dispatch(batches[0])
    all_notes = []
    for nxt in batches[1:]:
        upcoming = pipeline.dispatch(nxt)
        all_notes.append(pipeline.finalize(pending))
        pending = upcoming
    all_notes.append(pipeline.finalize(pending))
    elapsed = time.perf_counter() - start

    total_notes = sum(len(p) for batch in all_notes for (p, _) in batch)
    audio_seconds = len(batches) * batch_size * clip_seconds
    print(f'{len(batches)} batches x {batch_size} clips x {clip_seconds}s '
          f'in {elapsed:.2f}s -> {audio_seconds / elapsed:.0f}x real time, '
          f'{total_notes} notes decoded on device')

    # Notes arrive as (pitches, (onset, offset) intervals) per clip
    pitches, intervals = all_notes[0][0]
    for p, (on, off) in list(zip(pitches, intervals))[:5]:
        print(f'  pitch {p:5.1f}  {on:7.3f}s -> {off:7.3f}s')

    return all_notes
