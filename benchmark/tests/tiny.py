"""Throwaway cells at a size the CPU runs in seconds, written by the tests
into a directory of their own: the benchmark finds them there by name
beside its own files, as a later change would add them."""

import json

from benchmark import harness

# name -> (real file, changes)
CONFIGS = {'of2tiny': ('of2', {'model_complexity': 2, 'lstm_units': 128}),
           'tabtiny': ('tabcnn', {})}
TRAFFIC = {'piano-tiny': ('piano-128x60s', {'batch': 3, 'pool': 2,
                                            'clip_seconds': 1.5}),
           'guitar-tiny': ('guitar-64x60s', {'batch': 2, 'pool': 2,
                                             'clip_seconds': 1.5}),
           'piano-train-tiny': ('piano-train-8x625', {'batch': 2, 'pool': 3,
                                                      'frames': 40}),
           'guitar-train-tiny': ('guitar-train-30x200', {'batch': 2,
                                                         'pool': 3,
                                                         'frames': 30})}
SERVE = {'trace_items': 2}
CELLS = {'of2-serve-tiny': ('of2-serve-bf16', dict(SERVE, config='of2tiny',
                                                   traffic='piano-tiny')),
         'tab-serve-tiny': ('tabcnn-serve-bf16', dict(SERVE, config='tabtiny',
                                                      traffic='guitar-tiny')),
         'of2-train-tiny': ('of2-train-f32', {'config': 'of2tiny',
                                              'traffic': 'piano-train-tiny',
                                              'trace_items': 2}),
         'tab-train-tiny': ('tabcnn-train-f32', {'config': 'tabtiny',
                                                 'traffic': 'guitar-train-tiny',
                                                 'trace_items': 2})}
REFERENCES = {'of2tiny': 'of2', 'tabtiny': 'tabcnn'}


def write(root, kind, name, value):
    path = root / kind / name
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(value, str):
        path.write_text(value)
    else:
        path.write_text(json.dumps(value))


def build(root):
    """Write the tiny cells under ``root``; returns ``root``."""

    for kind, table in (('configs', CONFIGS), ('traffic', TRAFFIC),
                        ('workloads', CELLS)):
        for name, (real, changes) in table.items():
            value = dict(harness.load_json(kind, real), **changes)
            if kind == 'configs':
                value['name'] = name
            write(root, kind, f'{name}.json', value)
    for name, real in REFERENCES.items():
        write(root, 'reference', f'{name}.py',
              f'from benchmark.reference.{real} import *  # noqa: F401,F403\n')

    return root
