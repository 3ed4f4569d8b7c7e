"""The port's example scripts (``amt_tools_tpu_torch/examples``) on the CPU.

Mirrors ``tests/test_config_examples.py``: every script imports without
running, its config resolves to its JAX twin's (the paper hyperparameters
included) plus the port's ``device`` key, and ``transcribe_file`` runs on a
written WAV with ``device='cpu'``. The paper scripts run end to end on the
CPU: the synthetic recipes on a few short tracks, ``of_1`` and ``of_2`` on
the miniature MAPS and MAESTRO corpora of ``tests/fixtures/corpora.py``,
and ``tabcnn`` on the miniature GuitarSet (marked ``slow``: its 2 folds
compute the CQT of 720 tracks on the CPU, minutes, as
``tests/test_paper_scripts.py`` takes). No module of the port, its
examples included, nor ``chip_smoke.py``, imports JAX, Flax, Optax or the
JAX package.
"""

import ast
import glob
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import optax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                'fixtures'))

from corpora import (make_guitarset_corpus, make_maestro_corpus,
                     make_maps_corpus)

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.train import warmup_cosine_schedule

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'amt_tools_tpu_torch' / 'examples'
SCRIPTS = ['papers/of_1.py', 'papers/of_2.py', 'papers/tabcnn.py',
           'papers/synthetic_demo.py', 'papers/synthetic_tabcnn.py',
           'inference/transcribe_file.py', 'inference/serve_batch.py',
           'inference/export_artifact.py', 'inference/microphone.py']
CONFIGURED = [s for s in SCRIPTS if s.split('/')[1] not in
              ('transcribe_file.py', 'microphone.py')]


def _load_script(path):
    """Import a script module without triggering automain."""

    spec = importlib.util.spec_from_file_location(
        'example_' + Path(path).stem, str(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    return module


def test_every_script_is_ported():
    assert sorted(str(p.relative_to(PORT)) for p in PORT.rglob('*.py')) == \
        sorted(SCRIPTS)


@pytest.mark.parametrize('script', CONFIGURED)
def test_configs_resolve_to_the_jax_twins(script):
    """The same keys and defaults as the JAX script, and the port's
    ``device`` (None: the card)."""

    port = _load_script(PORT / script).ex.resolve_config()
    jax = _load_script(REPO / 'examples' / script).ex.resolve_config()

    assert port.pop('device') is None
    assert port == jax


@pytest.mark.parametrize('script', ['tabcnn.py', 'of_1.py', 'of_2.py'])
def test_example_scripts_configs_resolve(script):
    """The paper hyperparameters JAX's test checks."""

    config = _load_script(PORT / 'papers' / script).ex.resolve_config()

    if script == 'tabcnn.py':
        assert config['sample_rate'] == 22050
        assert config['num_frames'] == 200
        assert config['batch_size'] == 30
        assert config['iterations'] == 2500
    else:
        assert config['sample_rate'] == 16000
        assert config['num_frames'] == 625
        assert config['batch_size'] == 8
        assert config['learning_rate'] == 6e-4


def test_serve_batch_script_config_resolves():
    module = _load_script(PORT / 'inference' / 'serve_batch.py')

    config = module.ex.resolve_config()
    assert config['batch_size'] == 16
    assert config['clip_seconds'] == 20
    assert config['capacity'] == 1024
    assert config['data_parallel'] is False

    overridden = module.ex.resolve_config(['batch_size=4',
                                           'data_parallel=true',
                                           'device=cpu'])
    assert overridden['batch_size'] == 4
    assert overridden['data_parallel'] is True
    assert overridden['device'] == 'cpu'


def test_transcribe_file_script(tmp_path):
    fs = 16000
    t = np.arange(fs) / fs
    audio = (0.4 * np.sin(2 * np.pi * 261.63 * t)).astype(np.float32)
    wav_path = str(tmp_path / 'clip.wav')
    tools.write_wav(wav_path, audio, fs)

    module = _load_script(PORT / 'inference' / 'transcribe_file.py')

    out_path = str(tmp_path / 'notes.txt')
    pitches, intervals = module.main(wav_path, None, out_path, 'cpu')

    assert os.path.exists(out_path)
    assert len(pitches) == len(intervals)


def test_transcribe_file_restores_a_checkpoint(tmp_path):
    """A checkpoint of ``train()`` restores into the script's model."""

    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.train import save_checkpoint

    model = OnsetsFrames2(dim_in=229, profile=tools.PianoProfile(),
                          model_complexity=3,
                          generator=torch.Generator().manual_seed(9))
    optimizer = torch.optim.Adam(model.parameters())
    os.makedirs(tmp_path / 'ckpt')
    save_checkpoint(str(tmp_path / 'ckpt'), 3, model, optimizer, 0, 0, None)
    wav_path = str(tmp_path / 'clip.wav')
    tools.write_wav(wav_path, np.zeros(8000, np.float32), 16000)

    module = _load_script(PORT / 'inference' / 'transcribe_file.py')
    module.main(wav_path, str(tmp_path / 'ckpt'), str(tmp_path / 'n.txt'),
                'cpu')


def test_serve_and_export_scripts_run_on_the_cpu(tmp_path):
    serve = _load_script(PORT / 'inference' / 'serve_batch.py')
    serve.ex.root_dir = str(tmp_path / 'serve')
    notes = serve.ex.run(['batch_size=2', 'clip_seconds=1', 'device=cpu'])
    assert len(notes) == 4 and all(len(batch) == 2 for batch in notes)

    export = _load_script(PORT / 'inference' / 'export_artifact.py')
    export.ex.root_dir = str(tmp_path / 'export')
    agreeing = export.ex.run([f'out={tmp_path}/a.amtx', 'clip_seconds=1',
                              'device=cpu'])
    assert all(frozen == live == common for frozen, live, common
               in agreeing)


def test_microphone_script_raises_without_sounddevice(monkeypatch):
    from amt_tools_tpu_torch.features import stream

    module = _load_script(PORT / 'inference' / 'microphone.py')
    monkeypatch.setattr(stream, '_HAVE_SOUNDDEVICE', False)

    with pytest.raises(RuntimeError, match='sounddevice'):
        module.main('cpu')


@pytest.mark.parametrize('warmup, decay', [(60, 400), (1, 2), (3, 10)])
def test_warmup_cosine_schedule_matches_optax(warmup, decay):
    ours = warmup_cosine_schedule(warmup, decay)
    theirs = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1.0, warmup_steps=warmup,
        decay_steps=decay)

    for step in range(decay + 3):
        assert ours(step) == pytest.approx(float(theirs(step)), abs=1e-6)


def _run_paper(script, root, overrides, monkeypatch):
    module = _load_script(PORT / 'papers' / script)
    module.ex.root_dir = str(root / 'experiments')
    monkeypatch.setattr(tools, 'DEFAULT_FEATURES_GT_DIR',
                        str(root / 'generated'))
    module.ex.run(overrides + ['device=cpu'])

    run = root / 'experiments' / '1'
    assert glob.glob(str(run / 'models' / '**' / '*.ckpt'), recursive=True)
    assert glob.glob(str(run / 'results' / '*'))

    return run


SYNTHETIC = ['iterations=2', 'checkpoints=1', 'batch_size=2',
             'num_frames=32', 'num_train_tracks=2', 'num_test_tracks=1',
             'track_duration=2.0']


@pytest.mark.parametrize('script', ['synthetic_demo.py',
                                    'synthetic_tabcnn.py'])
def test_synthetic_recipes_run(script, tmp_path, monkeypatch):
    run = _run_paper(script, tmp_path, SYNTHETIC, monkeypatch)

    assert 'Final Results' in (run / 'metrics.json').read_text()


def test_synthetic_demo_passes_fused_lms(tmp_path, monkeypatch):
    """``fused_lms`` reaches the model as in the JAX script: the velocity
    model trains its three language models as one grouped BiLSTM, and V1
    refuses the flag."""

    run = _run_paper('synthetic_demo.py', tmp_path,
                     SYNTHETIC + ['estimate_velocity=True', 'fused_lms=True'],
                     monkeypatch)
    assert 'Final Results' in (run / 'metrics.json').read_text()

    with pytest.raises(ValueError, match='fused_lms'):
        _run_paper('synthetic_demo.py', tmp_path / 'v1',
                   SYNTHETIC + ['fused_lms=True'], monkeypatch)


@pytest.fixture(scope='module')
def corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp('corpora')
    make_maps_corpus(str(base / 'MAPS'))
    make_maestro_corpus(str(base / 'MAESTRO_V3'))

    return base


def test_of_1_script(corpora, tmp_path, monkeypatch):
    _run_paper('of_1.py', tmp_path,
               ['iterations=2', 'checkpoints=1', 'batch_size=2',
                'num_frames=75', f'maps_base_dir={corpora}/MAPS'],
               monkeypatch)


def test_of_2_script(corpora, tmp_path, monkeypatch):
    run = _run_paper('of_2.py', tmp_path,
                     ['iterations=2', 'checkpoints=1', 'batch_size=2',
                      'num_frames=75',
                      f'maestro_base_dir={corpora}/MAESTRO_V3',
                      f'maps_base_dir={corpora}/MAPS'], monkeypatch)

    metrics = (run / 'metrics.json').read_text()
    assert 'MAESTRO Results' in metrics and 'MAPS Results' in metrics


@pytest.mark.slow
def test_tabcnn_script(tmp_path, monkeypatch):
    base = tmp_path / 'corpora'
    make_guitarset_corpus(str(base / 'GuitarSet'))

    run = _run_paper('tabcnn.py', tmp_path,
                     ['iterations=2', 'checkpoints=1', 'batch_size=10',
                      'num_frames=25', 'folds=2',
                      f'gset_base_dir={base}/GuitarSet'], monkeypatch)

    assert 'Overall Results' in (run / 'metrics.json').read_text()


def test_no_module_of_the_port_nor_chip_smoke_imports_jax():
    """Every import statement, also inside functions, of the package, its
    examples and ``chip_smoke.py``; and importing each example script
    loads none of them."""

    banned = {'jax', 'flax', 'optax', 'amt_tools_tpu'}
    sources = sorted((REPO / 'amt_tools_tpu_torch').rglob('*.py'))
    sources.append(REPO / 'chip_smoke.py')
    assert any('examples' in str(p) for p in sources)

    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split('.')[0] not in banned, f'{path}: {name}'

    code = ('import importlib.util, sys\n'
            'for path in sys.argv[1:]:\n'
            '    spec = importlib.util.spec_from_file_location("m", path)\n'
            '    spec.loader.exec_module(importlib.util.module_from_spec('
            'spec))\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            f'{sorted(banned)!r}))\n')
    out = subprocess.run([sys.executable, '-c', code] +
                         [str(PORT / s) for s in SCRIPTS],
                         capture_output=True, text=True, check=True,
                         cwd=REPO).stdout
    assert out.strip() == '[]'
