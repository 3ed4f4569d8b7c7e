"""The port's public surface against the JAX package's, read with ``ast``
(neither package is imported).

For every module of ``amt_tools_tpu/``, the public top-level names (defs,
classes and assigned constants, not imports) that the port's module of the
same path lacks must be exactly the names the port leaves out by design,
each recorded with its reason in ROADMAP.md section 3 ("Not faults"). A
name the JAX package has and the port lacks, beyond those, fails here.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = ROOT / 'amt_tools_tpu'
PORT = ROOT / 'amt_tools_tpu_torch'

# module -> {name: reason}; a module absent from the port entirely is
# listed with every public name it has
ABSENT_BY_DESIGN = {
    'train.py': {
        'TrainState': "the functional state becomes the model and the "
                      "optimizer",
        'init_state': "the same: the model's constructor and the "
                      "optimizer's make the state",
    },
    'tools/utils.py': {
        'dict_to_jax': 'the port has it as dict_to_tensor (and '
                       'dict_to_device), with a torch device',
    },
    'ops/spectral.py': {
        'cqt_mag': 'became cqt_kernel.cqt_mag_plain, kernel C\'s plain '
                   'version',
    },
    'ops/pallas_stft.py': {
        name: 'a Pallas wrapper or its tile constant: the Hopper kernel is '
              'ops/stft_kernel.py (kernel A)'
        for name in ('stft_power_pallas', 'pallas_stft_supported',
                     'split_bank_bf16', 'DEFAULT_BIN_TILE',
                     'DEFAULT_CLIP_BLOCK')},
    'ops/pallas_lstm.py': {
        name: 'a Pallas wrapper or its tile constant: the Hopper kernels '
              'are ops/lstm_kernel.py (kernels B, E, F)'
        for name in ('lstm_scan_pallas', 'lstm_scan_pallas_grad',
                     'pallas_lstm_supported', 'DEFAULT_BLOCK_T')},
    'ops/pallas_cqt.py': {
        name: 'a Pallas wrapper: the Hopper kernels are ops/cqt_kernel.py '
              '(kernels C, D)'
        for name in ('cqt_mag_pallas', 'cqt_mag_pallas_grouped',
                     'pallas_cqt_supported')},
}


def _public_names(path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)

    return {name for name in names if not name.startswith('_')}


def _missing():
    missing = {}
    for path in sorted(JAX_PACKAGE.rglob('*.py')):
        module = path.relative_to(JAX_PACKAGE).as_posix()
        port = PORT / module
        lacking = _public_names(path) - (_public_names(port) if port.exists()
                                         else set())
        if lacking:
            missing[module] = lacking

    return missing


def test_the_port_lacks_only_the_names_absent_by_design():
    missing = _missing()
    expected = {module: set(names)
                for module, names in ABSENT_BY_DESIGN.items()}

    assert missing == expected


@pytest.mark.parametrize('module,names', [
    ('ops/lstm.py', ['GroupedBiLSTM']),
    ('models/onsetsframes.py', ['GroupedAcousticModel',
                                'fuse_acoustic_variables',
                                'unfuse_acoustic_variables',
                                'fuse_lm_variables', 'unfuse_lm_variables']),
    ('models/common.py', ['OutputLayer']),
    ('ops/decode.py', ['pack_bits', 'unpack_bits']),
    ('tools/instrument.py', ['hz_to_midi', 'midi_to_note']),
])
def test_the_fused_layouts_and_last_names_are_present(module, names):
    assert set(names) <= _public_names(PORT / module)


def test_every_tools_name_is_present():
    """The 47 helpers of ``tools/utils.py`` and the 11 constants the port
    had lacked (with the two instrument names, the 60 ``tools`` names)."""

    for module in ('tools/utils.py', 'tools/constants.py',
                   'tools/instrument.py'):
        lacking = (_public_names(JAX_PACKAGE / module) -
                   _public_names(PORT / module))
        assert lacking == set(ABSENT_BY_DESIGN.get(module, {})), module


def test_the_port_imports_no_jax():
    """No module of the port imports ``jax``, ``flax``, ``optax`` or the
    JAX package (exact module names: ``amt_tools_tpu_torch`` shares the
    prefix)."""

    banned = {'jax', 'flax', 'optax', 'amt_tools_tpu'}
    for path in list(PORT.rglob('*.py')) + [ROOT / 'chip_smoke.py']:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = {alias.name.split('.')[0] for alias in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split('.')[0]}
            else:
                continue
            assert not roots & banned, (path, roots)
