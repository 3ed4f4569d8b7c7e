"""Freeze the serving pipeline into a deployment artifact and smoke it.

The port's twin of ``examples/inference/export_artifact.py``, demonstrating
:mod:`amt_tools_tpu_torch.export`: one ``torch.export`` call captures audio
-> features -> forward -> threshold -> note decode as one program with the
weights inside, which kernels A and B run as custom ops on the card. The
loader side needs torch and this package (the ops), not the model code.

Run:  python export_artifact.py [checkpoint=<train() log_dir>]
                                [out=serving.amtx] [clip_seconds=20]
                                [quant=false] [capacity=1024]

Without a checkpoint the artifact freezes activity-calibrated random
weights (deployment-flow demonstration, not a useful transcription).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..', '..'))

import numpy as np

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.config import Experiment

ex = Experiment('ExportArtifact_OF2_MelSpec')


@ex.config
def config():
    # Checkpoint directory (from train()) to freeze; empty = random weights
    # with activity-calibrated output biases
    checkpoint = ''

    # Artifact path
    out = 'serving.amtx'

    # Seconds of audio per clip (static: frozen into the artifact)
    clip_seconds = 20

    # Serve the acoustic stacks as int8 contractions (ops/qconv.py):
    # 'static' = calibrated activation scales, true = dynamic scales
    # (calibration-free), false = bf16
    quant = False

    # Maximum notes decoded per clip on device
    capacity = 1024

    # Where the pipeline runs and the artifact is exported for: None -> the
    # card, 'cpu' -> the plain versions
    device = None


@ex.automain
def export(checkpoint, out, clip_seconds, quant, capacity, device):
    import torch

    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.serving import (TranscriptionPipeline,
                                             calibrate_activity)
    from amt_tools_tpu_torch.export import save_serving, load_serving
    from amt_tools_tpu_torch.datasets import render_notes, random_notes

    sample_rate, hop = 16000, 512
    device = tools.resolve_device(device)

    profile = tools.PianoProfile()
    data_proc = MelSpec(sample_rate=sample_rate, hop_length=hop, n_mels=229)
    model = OnsetsFrames2(dim_in=229, profile=profile, model_complexity=3,
                          dtype=torch.bfloat16, quant_acoustic=quant,
                          generator=torch.Generator().manual_seed(0))

    num_samples = int(sample_rate * clip_seconds)

    def probe_batch(seed, count=2):
        r = np.random.RandomState(seed)
        return np.stack([render_notes(*random_notes(profile, clip_seconds,
                                                    30, r),
                                      sample_rate, clip_seconds, seed=seed + b)
                         for b in range(count)])

    if checkpoint:
        from amt_tools_tpu_torch.train import (latest_checkpoint,
                                               load_checkpoint)

        path, iteration = latest_checkpoint(checkpoint)
        if path is None:
            raise FileNotFoundError(f'No checkpoint under {checkpoint}')
        model.to(device)
        load_checkpoint(path, model, torch.optim.Adam(model.parameters()))
        print(f'freezing checkpoint at iteration {iteration}: {path}')
    if quant == 'static':
        # Calibrated scales must exist before export freezes the graph
        from amt_tools_tpu_torch.serving import calibrate_quant_stats
        calibrate_quant_stats(model, data_proc, probe_batch(7), device=device)

    if not checkpoint:
        calibrate_activity(model, data_proc, probe_batch(0), device=device)

    pipeline = TranscriptionPipeline(model, data_proc, capacity=capacity,
                                     device=device)

    # batch_size matters only when a symbolic batch does not trace (the
    # int8 layers' chunks): pin it to the smoke batch below so the fallback
    # artifact still serves this script's probe
    meta = save_serving(out, pipeline, num_samples, batch_size=2)
    size_mb = os.path.getsize(out) / 1e6
    print(f'wrote {out}: {size_mb:.1f} MB, {meta}')

    # --- deployment-side smoke: reload and compare against the live run
    artifact = load_serving(out)
    audio = probe_batch(7)

    frozen = artifact(audio)
    live = pipeline(audio)

    agreeing = []
    for clip, ((p_f, i_f), (p_l, i_l)) in enumerate(zip(frozen, live)):
        set_f = {(p, round(on, 4), round(off, 4))
                 for p, (on, off) in zip(p_f, i_f)}
        set_l = {(p, round(on, 4), round(off, 4))
                 for p, (on, off) in zip(p_l, i_l)}
        common = len(set_f & set_l)
        agreeing.append((len(set_f), len(set_l), common))
        print(f'clip {clip}: artifact {len(set_f)} notes / live '
              f'{len(set_l)}, agreeing {common}')

    return agreeing
