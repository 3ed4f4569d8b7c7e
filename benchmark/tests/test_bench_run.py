"""Whole runs at a small size on the CPU: the line a run prints, the
command's refusals without a card, the faults the check must catch, the
control it must fail, and the import check. One test, marked for the card,
runs a cell of the benchmark there."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

REPO = harness.HERE.parent
SPEC = harness.load_spec()

# The tiny cells' limits, read on a CPU at their size: the port's
# readings below them, the control's above at least one
TINY_LIMITS = {
    'serve': {'features_err': 1e-3, 'logit_err': 0.05, 'notes_bad': 0},
    'train': {'loss_gap': 1e-5, 'grad_gap': 5e-4, 'update_gap': 1e-4}}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    path = tiny.build(tmp_path_factory.mktemp('cells'))
    for name, (_, changes) in tiny.CELLS.items():
        workload = harness.load_json('workloads', name, path)
        workload['limits'] = TINY_LIMITS[workload['driver']]
        tiny.write(path, 'workloads', f'{name}.json', workload)

    return path


def run(root, cell, trace=0, seed=2 ** 31 + 5):
    torch.manual_seed(0)
    result, checks = harness.run(SPEC, cell, seed, 0.5, trace, 'cpu',
                                 time.perf_counter(), root=root)
    json.dumps(result)  # the line is JSON

    return result, checks


@pytest.mark.parametrize('cell', list(tiny.CELLS))
@pytest.mark.parametrize('trace', [0, 1])
def test_a_cpu_run_is_correct_and_carries_no_device_metric(root, cell, trace):
    result, checks = run(root, cell, trace)
    assert list(result) == ['correct', 'attempted', 'failed', 'metrics',
                            'device', 'checks']
    assert result['correct'] is True, result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    assert result['metrics'] == {}
    assert result['device'] == {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                                'memory_peak_bytes': 0}
    assert [name for name, _, _ in checks] == list(result['checks'])


def test_the_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    done = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'of2-serve-bf16',
         '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, BENCH_RUN='x'))
    assert done.returncode == 2 and done.stdout == ''
    assert 'no CUDA card' in done.stderr


def test_the_command_refuses_a_checkout_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: no
    result (here already for want of a card; on the card for want of the
    port)."""

    import shutil

    shutil.copy(REPO / 'BENCHMARK.json', tmp_path)
    shutil.copytree(harness.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', '.cache'))
    done = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'of2-serve-bf16',
         '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ''


def test_a_run_loads_no_jax(root):
    """The benchmark and the port's CPU path, in a process of their own,
    leave no JAX, JAX library or JAX package among the modules."""

    code = ('import sys, time, json; sys.path.insert(0, %r)\n'
            'from benchmark import harness\n'
            'harness.run(harness.load_spec(), "tab-serve-tiny", 1, 0.2, 0, '
            '"cpu", time.perf_counter(), root=%r)\n'
            'print(json.dumps(harness.forbidden_modules()))\n'
            % (str(REPO), str(root)))
    done = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


# The faults the check must catch, planted in the port's objects, and the
# control in the port's place


@pytest.mark.parametrize('fault', ['half_batch', 'answer_altered'])
@pytest.mark.parametrize('cell', ['of2-serve-tiny', 'tab-serve-tiny'])
def test_a_serving_fault_makes_the_run_incorrect(root, cell, fault):
    result, _ = control.run(cell, 2 ** 31 + 5, 0.5, 'cpu', fault, root)
    assert result['correct'] is False


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch',
                                   'answer_altered'])
@pytest.mark.parametrize('cell', ['of2-train-tiny', 'tab-train-tiny'])
def test_a_training_fault_makes_the_run_incorrect(root, cell, fault):
    result, _ = control.run(cell, 2 ** 31 + 5, 0.5, 'cpu', fault, root)
    assert result['correct'] is False


@pytest.mark.parametrize('cell', list(tiny.CELLS))
def test_the_control_fails_the_check(root, cell):
    """The reference in the precision below the configuration's, in the
    port's place, makes a whole run read ``correct`` false, by reading
    above at least one limit."""

    torch.manual_seed(0)
    result, checks = control.run(cell, 2 ** 31 + 5, 0.5, 'cpu', 'control',
                                 root)
    assert result['correct'] is False
    assert result['failed'] == 0
    assert any(value > limit for _, value, limit in checks), checks


def test_a_stand_in_leaves_the_program_as_it_was(root):
    program = harness.load_code('programs', 'tabcnn')
    entries = program.serving, program.training
    with control.standing_in('tab-train-tiny', 'control', root):
        assert program.training is not entries[1]
    assert (program.serving, program.training) == entries


@pytest.mark.cuda
@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_a_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    done = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', cell, '--seed',
         '2147483659', '--seconds', '3', '--trace', '0'], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result['correct'] is True, result['checks']
    assert result['device']['platform'] == 'gpu'
