"""The correctness check's control for a cell on the ``generate`` driver,
and where its features' gaps lie (not part of a benchmark run).

    python3 benchmark/control_generate.py --workload mt3-serve-bf16 --seeds 1,2,3 [--seconds 1]

Each seed sets the cell up as the benchmark does, serves for ``seconds``
and runs the driver's check on the batch it kept. On the same clips and
the same served tokens it then computes the control: the plain reference
one precision down in the port's place (bf16 frames for the features, and
float8 products for its teacher-forced logits over the served tokens, since
a reference with no cache cannot generate 1,024 tokens for 960 rows), read
by the check's own measures. Beside both it prints where the served
features' largest raw gap lies (segment, mel bin, frame, the reference's
and the served level, the frame's loudest bin) and the largest gap by the
reference's level below its frame's loudest bin, in bands of 20 dB of
magnitude. One JSON line a seed. The command exits with 1 if the program
reads ``correct`` false or the control reads it true.

``benchmark/control.py`` runs the control of the ``serve`` and ``train``
cells; it has no stand-ins for ``generate``.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent

CONTROL = {'bfloat16': 'fp8', 'float32': 'tf32'}

# Bands of the reference's level below its frame's loudest mel bin, in
# natural log: 20 dB of magnitude each
BAND = math.log(10.0)


def where(served, reference):
    """Where the largest raw gap of (rows, 1, n_mels, T) features lies, and
    the largest gap in each band below the frame's loudest bin."""

    gap = (served - reference).abs()
    at = [int(i) for i in torch.unravel_index(gap.argmax(), gap.shape)]
    peak = reference.amax(dim=-2, keepdim=True)
    below = ((peak - reference) / BAND).floor().clamp_max(5)
    bands = {f'{20 * int(b)}-{20 * int(b) + 20}dB' if b < 5 else '100dB+':
             float(gap[below == b].max()) for b in below.unique().tolist()}

    return {'gap': float(gap.max()), 'segment': at[0], 'bin': at[2],
            'frame': at[3], 'reference': float(reference[tuple(at)]),
            'served': float(served[tuple(at)]),
            'frame_peak': float(peak[at[0], 0, 0, at[3]]),
            'by_level_below_peak': bands}


def one_seed(cell, seed, seconds):
    from benchmark import harness
    from benchmark.drivers import generate, serve
    from benchmark.reference import plain

    ctx = harness.Context(cell, seed, False, 'cuda',
                          started=time.perf_counter())
    bench = ctx.driver.Bench(ctx)
    bench.setup()
    bench.window(seconds)
    index, captured = bench.kept
    audio = bench.pool[index % len(bench.pool)]
    clips, segments = captured['clips'], captured['segments']
    picked = captured['picked']
    tokens = captured['tokens']
    rows = (torch.as_tensor(clips, device=tokens.device)[:, None] *
            segments + torch.arange(segments, device=tokens.device))
    served_tokens = tokens[rows.flatten()[torch.as_tensor(
        picked, device=tokens.device)]]
    feats = captured['features'].float()
    reference, config, params = ctx.reference, ctx.config, bench.params
    program = {name: (value, limit) for name, value, limit in bench.check()}
    torch.cuda.empty_cache()

    low = CONTROL[config['serve_dtype']]
    with torch.no_grad(), plain.exact_float32():
        clip_audio = audio[torch.as_tensor(clips, device=audio.device)]
        exact = reference.features(clip_audio, config)
        rough = reference.features(clip_audio, config, 'bf16')
        index = torch.as_tensor(picked, device=exact.device)
        want = reference.forward(params, exact[index], served_tokens, config)
        got = reference.forward(params, rough[index], served_tokens, config,
                                low)
    limits = ctx.workload['limits']
    control = {
        'features_err': generate.features_error(rough, exact),
        'logit_err': serve.logit_error({'logits': got}, {'logits': want}),
        'tokens_bad': int((got.argmax(-1) != served_tokens).sum())}
    control_correct = all(value <= limits[name]
                          for name, value in control.items())

    return {'seed': seed,
            'program': {name: value for name, (value, _) in program.items()},
            'program_correct': all(value <= limit
                                   for value, limit in program.values()),
            'control': control, 'control_correct': control_correct,
            'limits': {name: limits[name] for name in program},
            'features_where': where(feats, exact),
            'control_features_where': where(rough, exact)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--seconds', type=float, default=1.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))

    if not torch.cuda.is_available():
        print('control_generate: no CUDA card', file=sys.stderr)
        return 2
    failed = False
    for seed in [int(s) for s in args.seeds.split(',')]:
        line = one_seed(args.workload, seed, args.seconds)
        failed |= not line['program_correct'] or line['control_correct']
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()

    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
