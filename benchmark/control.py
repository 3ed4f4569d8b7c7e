"""The correctness check's control and the faults it must catch, each put
in the port's place for a whole run of a cell at its own sizes (not part
of a benchmark run).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --stand-ins control,half_batch [--seconds 2]

``control`` is the plain reference in the port's place, computed in the
precision below the configuration's: a bf16 serving path's features in
bf16 and its model's products in float8 (e4m3, one scale a tensor); a
float32 training step's products in TF32. The other stand-ins are the
port with one fault planted where its answer is produced:
``half_batch`` (half of each batch left out; in training the mean taken
over the rest), ``answer_altered`` (each served note a semitone up, or
each step's loss 1% high) and, in training, ``state_unchanged`` (the
optimizer's step does nothing). ``program`` is the port as it is, for
the sound runs' readings in the same process.

Each seed drives :func:`harness.run` as the benchmark does, with the
stand-in under it, and prints the run's ``correct`` and the numbers its
check compared beside their limits, one JSON line a seed. The command
exits with 1 if a run of ``program`` reads ``correct`` false or a run of
another stand-in reads it true.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent

CONTROL = {'bfloat16': 'fp8', 'float32': 'tf32'}

# Clips a pass of the serving control's reference, to bound its memory
CHUNK = 64


# Serving stand-ins: each takes the port's pipeline and what it was built
# from, and returns the pipeline that serves in its place


def serve_control(pipeline, config, params, reference, capacity):
    from benchmark.reference import plain

    low = CONTROL[config['serve_dtype']]
    dtype = getattr(torch, config['serve_dtype'])

    def process(audio):
        with plain.exact_float32():
            return torch.cat([reference.features(part, config, 'bf16')
                              for part in audio.split(CHUNK)])

    def forward(feats):
        with plain.exact_float32():
            parts = [reference.forward(params, part, config, low)
                     for part in feats.split(CHUNK)]
        return {key: torch.cat([part[key] for part in parts]).to(dtype)
                for key in parts[0]}

    pipeline.data_proc.process = process
    pipeline.model.pre_proc = lambda batch: batch
    pipeline.model.forward = forward

    return pipeline


def half_batch_served(pipeline, *built):
    dispatch = pipeline.dispatch
    pipeline.dispatch = lambda audio: dispatch(audio[:audio.shape[0] // 2])

    return pipeline


def note_altered(pipeline, *built):
    finalize = pipeline.finalize

    def altered(handle):
        clips = finalize(handle)
        for c, clip in enumerate(clips):
            if isinstance(clip, dict):  # tablature: {string: notes}
                for string, (pitches, intervals) in clip.items():
                    clip[string] = (pitches + 1, intervals)
            else:
                clips[c] = (clip[0] + 1, clip[1])
        return clips

    pipeline.finalize = altered

    return pipeline


# Training stand-ins: each takes the port's (model, optimizer, step) and
# what they were built from, and returns the triple that trains in their
# place


class Leaves(torch.nn.Module):
    """The reference's training loss over its leaves, as a module whose
    parameters carry the port's names."""

    def __init__(self, leaves, loss):
        super().__init__()
        self.leaves = leaves
        self.loss = loss

    def named_parameters(self, *args, **kwargs):
        return iter(self.leaves.items())

    def parameters(self, *args, **kwargs):
        return iter(self.leaves.values())

    def forward(self, batch, generator):
        return self.loss(batch, generator)


def train_control(built, config, params, reference, optimizer):
    from benchmark.reference import plain

    low = CONTROL[config['train_dtype']]
    names = [name for name, _ in built[0].named_parameters()]
    leaves = {name: params[name].clone().requires_grad_(True)
              for name in names}
    values = dict(params, **leaves)
    model = Leaves(leaves, lambda batch, generator: reference.loss(
        values, batch, config, low, generator))
    opt = getattr(torch.optim, optimizer['name'])(list(leaves.values()),
                                                  lr=optimizer['lr'])

    def step(batch, generator):
        with plain.exact_float32():
            loss = model(batch, generator)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return {'loss_total': loss.detach()}

    return model, opt, step


def state_unchanged(built, *args):
    model, optimizer, step = built
    optimizer.step = lambda *args, **kwargs: None

    return model, optimizer, step


def half_batch_trained(built, *args):
    model, optimizer, step = built

    def halved(batch, generator):
        return step({k: v[:v.shape[0] // 2] for k, v in batch.items()},
                    generator)

    return model, optimizer, halved


def loss_altered(built, *args):
    model, optimizer, step = built

    def altered(batch, generator):
        return {k: v * 1.01 for k, v in step(batch, generator).items()}

    return model, optimizer, altered


def unchanged(built, *args):
    return built


STAND_INS = {'serve': {'program': unchanged,
                       'control': serve_control,
                       'half_batch': half_batch_served,
                       'answer_altered': note_altered},
             'train': {'program': unchanged,
                       'control': train_control,
                       'half_batch': half_batch_trained,
                       'answer_altered': loss_altered,
                       'state_unchanged': state_unchanged}}


@contextlib.contextmanager
def standing_in(cell, name, root=None):
    """Within the block, the cell's program builds ``name``'s stand-in in
    place of its serving pipeline or train step."""

    from benchmark import harness

    root = root or harness.HERE
    workload = harness.load_json('workloads', cell, root)
    config = harness.load_json('configs', workload['config'], root)
    program = harness.load_code('programs', config['family'], root)
    reference = harness.load_code('reference', workload['config'], root)
    plant = STAND_INS[workload['driver']][name]
    entry = 'serving' if workload['driver'] == 'serve' else 'training'
    original = getattr(program, entry)

    def built(config, params, device, option):
        return plant(original(config, params, device, option), config,
                     params, reference, option)

    setattr(program, entry, built)
    try:
        yield
    finally:
        setattr(program, entry, original)


def run(cell, seed, seconds, device, name, root=None):
    """One run of ``cell`` with ``name``'s stand-in -> (result, checks)."""

    from benchmark import harness

    with standing_in(cell, name, root):
        return harness.run(harness.load_spec(), cell, seed, seconds, 0,
                           device, time.perf_counter(),
                           root=root or harness.HERE)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--stand-ins', required=True,
                        help='comma-separated, of: ' + ', '.join(sorted(
                            {name for table in STAND_INS.values()
                             for name in table})))
    parser.add_argument('--seconds', type=float, default=2.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))

    if not torch.cuda.is_available():
        print('control: no CUDA card', file=sys.stderr)
        return 2
    unexpected = 0
    for name in args.stand_ins.split(','):
        for seed in (int(s) for s in args.seeds.split(',')):
            result, checks = run(args.workload, seed, args.seconds, 'cuda',
                                 name)
            unexpected += result['correct'] != (name == 'program')
            for check, value, limit in checks:
                print(f'check {check}: {value!r} (limit {limit!r})',
                      file=sys.stderr)
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'stand_in': name, 'correct': result['correct'],
                              'failed': result['failed'],
                              'checks': result['checks']}), flush=True)
            torch.cuda.empty_cache()

    return 1 if unexpected else 0


if __name__ == '__main__':
    sys.exit(main())
