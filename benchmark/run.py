"""Run one cell of the benchmark of ``amt_tools_tpu_torch`` on the card.

From the root of a checkout, on a machine with the cards the cell needs::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's JSON result; the last lines
of standard error are the numbers the correctness check compared, each
beside its limit. The run exits with 2, printing no result, without a CUDA
card (or with fewer than the cell asks for) and for an unknown cell, and
with 3 if the process holds JAX, its libraries or the JAX package once the
window has closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / 'benchmark' / '.cache'


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)

    return parser.parse_args(argv)


def fail(message, code):
    print(f'benchmark: {message}', file=sys.stderr, flush=True)

    return code


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, str(REPO))
    # Fixed caches inside the checkout, for any library that compiles
    os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')

    from benchmark import harness

    found = harness.forbidden_modules()
    if found:
        return fail(f'the process holds {found} before the run', 3)

    import torch

    if not torch.cuda.is_available():
        return fail('no CUDA card: this benchmark measures the card only', 2)
    try:
        workload = harness.load_json('workloads', args.workload)
    except (LookupError, ValueError) as error:
        return fail(str(error), 2)
    if torch.cuda.device_count() < workload['chips']:
        return fail(f'{args.workload} needs {workload["chips"]} cards, the '
                    f'machine has {torch.cuda.device_count()}', 2)

    spec = harness.load_spec(REPO / 'BENCHMARK.json')
    result, checks = harness.run(spec, args.workload, args.seed, args.seconds,
                                 args.trace, 'cuda', STARTED)

    found = harness.forbidden_modules()
    if found:
        return fail(f'the process holds {found} after the window', 3)

    for name, value, limit in checks:
        print(f'check {name}: {value!r} (limit {limit!r})', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

    return 0


if __name__ == '__main__':
    sys.exit(main())
