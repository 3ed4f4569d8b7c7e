"""The benchmark's files: found by name, refused by unknown name, and held
to the contract's shape; a cell added as files alone runs."""

import ast
import json
import re
import time

import pytest

from benchmark import harness
from benchmark.tests import tiny

REPO = harness.HERE.parent
SPEC = harness.load_spec()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_spec_has_the_contract_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert SPEC['command'][1] == 'benchmark/run.py'
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize('kind', ['configs', 'workloads', 'end_to_end',
                                  'per_layer'])
def test_names_and_units(kind):
    entries = SPEC[kind]
    names = [entry['name'] for entry in entries]
    assert len(set(names)) == len(names)
    for entry in entries:
        assert NAME.match(entry['name'])
        if 'unit' in entry:
            assert UNIT.match(entry['unit'])
            assert entry['better'] in ('lower', 'higher')
        for text in (entry.get('why'), entry.get('layer')):
            assert text is None or (1 <= len(text) <= 200 and
                                    '\n' not in text and '\t' not in text)


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_every_cell_loads_by_name(cell):
    entry = next(w for w in SPEC['workloads'] if w['name'] == cell)
    ctx = harness.Context(cell, 1, False, 'cpu')
    assert ctx.workload['config'] == entry['config']
    assert ctx.workload['traffic'] == entry['traffic']
    assert ctx.workload['chips'] == entry['chips'] == 1
    assert ctx.workload['why'] == entry['why']
    assert ctx.config['name'] == entry['config']
    assert set(ctx.workload['limits']) == {
        'serve': {'features_err', 'logit_err', 'notes_bad'},
        'train': {'loss_gap', 'grad_gap', 'update_gap'}}[
            ctx.workload['driver']]
    for metric in harness.cell_metrics(SPEC, cell, 0):
        assert metric['name'] in ('setup_s', 'audio_s_per_s', 'steps_per_s')
    assert any(m['name'] == 'setup_s'
               for m in harness.cell_metrics(SPEC, cell, 0))
    assert len(harness.cell_metrics(SPEC, cell, 0)) >= 2
    assert harness.cell_metrics(SPEC, cell, 1)


@pytest.mark.parametrize('config', SPEC['configs'], ids=lambda c: c['name'])
def test_every_config_file_is_its_own_and_used(config):
    path = REPO / config['file']
    assert path.is_file() and path.parent == harness.HERE / 'configs'
    assert json.loads(path.read_text())['reduced'] == config['reduced'] == []
    assert any(w['config'] == config['name'] for w in SPEC['workloads'])
    assert (harness.HERE / 'reference' / f'{config["name"]}.py').is_file()


@pytest.mark.parametrize('metric', SPEC['end_to_end'] + SPEC['per_layer'],
                         ids=lambda m: m['name'])
def test_every_metric_has_its_reader(metric):
    module = harness.load_code('metrics', metric['name'])
    assert callable(module.read)
    if metric in SPEC['per_layer']:
        moved = next(m for m in SPEC['end_to_end']
                     if m['name'] == metric['moves'])
        # Every cell that reports the metric reports what it moves
        for cell in metric['workloads']:
            assert cell in moved.get('workloads', [cell])
        if metric['unit'] == '%' and ('roofline' in metric['name'] or
                                      'mfu' in metric['name']):
            assert metric['better'] == 'higher'
    else:
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.0 < metric['bound'] <= 0.25


@pytest.mark.parametrize('kind,name', [('workloads', 'no-such-cell'),
                                       ('configs', 'no-such-config'),
                                       ('traffic', 'no-such-mix'),
                                       ('metrics', 'no.such.metric'),
                                       ('drivers', 'no_such_driver')])
def test_an_unknown_name_is_refused(kind, name):
    with pytest.raises(LookupError):
        if kind in ('metrics', 'drivers'):
            harness.load_code(kind, name)
        else:
            harness.load_json(kind, name)


@pytest.mark.parametrize('name', ['../BENCHMARK', 'a b', '', 'x/y', '-a'])
def test_a_malformed_name_is_refused(name):
    with pytest.raises(ValueError):
        harness.load_json('workloads', name)


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    new file in a directory of its own, with nothing of the benchmark
    edited: the cell runs, and the metric is found and read."""

    tiny.build(tmp_path)
    tiny.write(tmp_path, 'metrics', 'throwaway.clips.py',
               'def read(record):\n    return float(record.work["clips"])\n')
    spec = dict(SPEC, per_layer=SPEC['per_layer'] + [
        {'name': 'throwaway.clips', 'unit': 'clips', 'better': 'higher',
         'source': 'program_counter', 'layer': 'serving',
         'moves': 'audio_s_per_s', 'workloads': ['of2-serve-tiny']}])

    result, _ = harness.run(spec, 'of2-serve-tiny', 3, 0.5, 0, 'cpu',
                            time.perf_counter(), root=tmp_path)
    assert result['correct'] and result['attempted'] > 0

    metric = harness.load_code('metrics', 'throwaway.clips', tmp_path)
    record = harness.Record(harness.Context('of2-serve-tiny', 3, False, 'cpu',
                                            tmp_path),
                            1.0, {'clips': 7}, 7, 0, {})
    assert metric.read(record) == 7.0
    assert [m['name'] for m in harness.cell_metrics(
        spec, 'of2-serve-tiny', 1)] == ['throwaway.clips']


def imported(path):
    """Top-level names of the absolute imports of a source file."""

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split('.')[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add((node.module or '').split('.')[0])

    return names


@pytest.mark.parametrize('path', sorted(harness.HERE.rglob('*.py')),
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    """By whole top-level names: the port, ``amt_tools_tpu_torch``, shares
    the JAX package's prefix and is allowed; the references import nothing
    of it either."""

    names = imported(path)
    assert not names & set(harness.FORBIDDEN)
    if path.parent.name == 'reference':
        assert 'amt_tools_tpu_torch' not in names


def test_the_forbidden_check_compares_whole_top_level_names():
    modules = ['jax.numpy', 'flax.linen', 'amt_tools_tpu_torch.ops.decode',
               'amt_tools_tpu_torchx', 'jaxtyping', 'optax', 'amt_tools_tpu',
               'torch']
    assert harness.forbidden_modules(modules) == ['amt_tools_tpu', 'flax',
                                                  'jax', 'optax']
    assert harness.forbidden_modules(['amt_tools_tpu_torch']) == []
