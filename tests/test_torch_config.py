"""The port's ``config.Experiment`` against the JAX package's.

Mirrors ``tests/test_config_examples.py::test_experiment_config_capture``
and ``::test_experiment_run_tracking``; the run directories both write
(``config.json``, ``metrics.json``, the captured console) must be equal,
file for file.
"""

import json
import os

import pytest

from amt_tools_tpu.config import Experiment as JaxExperiment

from amt_tools_tpu_torch.config import Experiment


@pytest.mark.parametrize('cls', [Experiment, JaxExperiment],
                         ids=['port', 'jax'])
def test_experiment_config_capture(tmp_path, cls):
    ex = cls('test_ex', root_dir=str(tmp_path))

    @ex.config
    def config():
        learning_rate = 1e-3
        batch_size = 8
        name = 'hello'

    resolved = ex.resolve_config()
    assert resolved == {'learning_rate': 1e-3, 'batch_size': 8,
                        'name': 'hello'}

    # Overrides parse as JSON with string fallback
    resolved = ex.resolve_config(['learning_rate=0.01', 'name=world',
                                  'batch_size=[1, 2]'])
    assert resolved == {'learning_rate': 0.01, 'batch_size': [1, 2],
                        'name': 'world'}

    with pytest.raises(KeyError):
        ex.resolve_config(['unknown=1'])
    with pytest.raises(ValueError):
        ex.resolve_config(['learning_rate'])


def _run(cls, root):
    ex = cls('test_run', root_dir=str(root))

    @ex.config
    def config():
        value = 42
        ratio = 0.5
        opaque = object()

    captured = {}

    def main(value, ratio, root_dir):
        captured['value'] = value
        captured['root_dir'] = root_dir
        print('hello from main')
        ex.log_scalar('metric', 1.5, step=3)
        ex.log_scalar('metric', ratio, step=4)
        ex.log_scalar('results', {'f1': 0.25, 'note': 'x'}, step=0)
        ex.log_scalar('opaque', object, step=1)

    ex._main_fn = main
    ex.run(['value=7'])
    ex.run()

    return captured


def test_experiment_run_tracking(tmp_path):
    port = _run(Experiment, tmp_path / 'port')
    jax = _run(JaxExperiment, tmp_path / 'jax')

    assert port['value'] == jax['value'] == 42
    for run in ('1', '2'):
        for name in ('config.json', 'metrics.json', 'cout.txt'):
            with open(tmp_path / 'port' / run / name) as mine, \
                    open(tmp_path / 'jax' / run / name) as theirs:
                assert mine.read() == theirs.read(), (run, name)
        with open(tmp_path / 'port' / run / 'run.json') as handle:
            assert json.load(handle)['experiment'] == 'test_run'

    with open(tmp_path / 'port' / '1' / 'config.json') as handle:
        assert json.load(handle) == {'value': 7, 'ratio': 0.5}
    # One Experiment keeps its metrics across runs, as JAX's does
    with open(tmp_path / 'port' / '2' / 'metrics.json') as handle:
        metrics = json.load(handle)
    assert metrics['metric'] == {'steps': [3, 4, 3, 4],
                                 'values': [1.5, 0.5, 1.5, 0.5]}
    assert 'hello from main' in open(
        os.path.join(port['root_dir'], 'cout.txt')).read()
