"""The port's serving pipeline, end to end, vs the JAX package's, on the CPU.

The same Flax variables (random init, then the JAX ``calibrate_activity``)
serve both pipelines in float32 on the same synthetic audio. The JAX
pipeline computes its features with an FFT and the port with a DFT-bank
matmul (features within 4e-4), so logits agree within ``LOGIT_ATOL`` and
the thresholded maps may differ only at cells whose JAX logit lies within
``LOGIT_ATOL`` of the threshold (logit 0). In every pitch row where the
maps agree the notes must be identical.

Also: the port imports neither JAX nor the JAX package, a pipeline built
without a device raises when no CUDA device exists, and overflowing clips
re-decode to the same notes a large capacity gives.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.features import MelSpec as JaxMelSpec
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.serving import TranscriptionPipeline as JaxPipeline
from amt_tools_tpu.serving import calibrate_activity as jax_calibrate

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.datasets import random_notes, render_notes
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2
from amt_tools_tpu_torch.ops import decode
from amt_tools_tpu_torch.serving import (TranscriptionPipeline,
                                         calibrate_activity)
from amt_tools_tpu_torch.weights import from_flax

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOGIT_ATOL = 2e-3
N_MELS = 48
SECONDS = 3.0


@pytest.fixture(scope='module')
def served():
    """Audio, calibrated Flax variables, and both pipelines' outputs."""

    profile = jtools.PianoProfile()
    rng = np.random.RandomState(0)
    clips = []
    for b in range(2):
        pitches, intervals = random_notes(tools.PianoProfile(), SECONDS, 12, rng)
        clips.append(render_notes(pitches, intervals, 16000, SECONDS, seed=b))
    audio = np.stack(clips)

    jax_mel = JaxMelSpec(n_mels=N_MELS)
    jax_model = JaxOnsetsFrames2(dim_in=N_MELS, profile=profile,
                                 model_complexity=2)
    feats = jax_model.pre_proc(
        {jtools.KEY_FEATS: jax_mel.process_jax(jnp.asarray(audio))})
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                        feats[jtools.KEY_FEATS])
    variables = jax_calibrate(jax_model, variables, jax_mel, jnp.asarray(audio))
    raw = jax_model.apply(variables, feats[jtools.KEY_FEATS])

    jax_pipe = JaxPipeline(jax_model, variables, jax_mel, capacity=256)
    jax_notes = jax_pipe(audio)

    return audio, variables, raw, jax_notes


def _port_model(variables):
    model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                          model_complexity=2)
    model.load_state_dict(from_flax(variables))
    return model


def _maps(logits):
    """Thresholded (B, 88, T) map of (B, T, 88) float32 logits."""

    logits = torch.from_numpy(np.swapaxes(logits, -1, -2))
    return decode.threshold(decode.sigmoid(logits)).numpy() > 0


def test_notes_match_jax_pipeline(served):
    audio, variables, jax_raw, jax_notes = served

    model = _port_model(variables)
    pipe = TranscriptionPipeline(model, MelSpec(n_mels=N_MELS), capacity=256,
                                 device='cpu')

    # Overlapped protocol: dispatch the next batch before finalizing
    first = pipe.dispatch(audio)
    second = pipe.dispatch(torch.from_numpy(audio))
    notes = pipe.finalize(first)
    assert [len(p) for p, _ in pipe.finalize(second)] == \
        [len(p) for p, _ in notes]

    with torch.no_grad():
        feats = MelSpec(n_mels=N_MELS).process(torch.from_numpy(audio))
        port_raw = model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])

    total = 0
    # (B, 88): the pitch rows whose thresholded maps differ
    rows = np.zeros((audio.shape[0], 88), dtype=bool)
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
        ref = np.asarray(jax_raw[key])
        got = port_raw[key].numpy()
        np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)

        differ = _maps(got) != _maps(ref)
        assert (np.abs(np.swapaxes(ref, -1, -2)[differ]) <= LOGIT_ATOL).all()
        total += differ.sum()
        rows |= differ.any(-1)

    assert total <= 2

    # The decode works row by row, so outside the rows whose maps differ
    # every clip's notes must be identical
    low = tools.PianoProfile().low
    for b, ((p_got, i_got), (p_ref, i_ref)) in enumerate(zip(notes,
                                                             jax_notes)):
        keep_got = ~rows[b][p_got.astype(int) - low]
        keep_ref = ~rows[b][p_ref.astype(int) - low]
        np.testing.assert_array_equal(p_got[keep_got], p_ref[keep_ref])
        np.testing.assert_array_equal(i_got[keep_got], i_ref[keep_ref])
        assert keep_ref.sum() > 0, f'clip {b}: no notes compared'


def test_calibrate_activity_matches_jax(served):
    audio, variables, _, _ = served

    # The variables already carry JAX's calibration, so the port's shifts
    # are the quantiles of the calibrated logits, which JAX computes here
    model = _port_model(variables)
    jax_mel = JaxMelSpec(n_mels=N_MELS)
    jax_model = JaxOnsetsFrames2(dim_in=N_MELS, profile=jtools.PianoProfile(),
                                 model_complexity=2)
    feats = jax_model.pre_proc(
        {jtools.KEY_FEATS: jax_mel.process_jax(jnp.asarray(audio))})
    raw = jax_model.apply(variables, feats[jtools.KEY_FEATS])

    before = {head: getattr(model, head).Dense_0.bias.detach().clone()
              for head in ('adjoin_out', 'onset_out')}
    shifts = calibrate_activity(model, MelSpec(n_mels=N_MELS), audio,
                                device='cpu')

    for key, head, rate in ((tools.KEY_MULTIPITCH, 'adjoin_out', 0.03),
                            (tools.KEY_ONSETS, 'onset_out', 0.001)):
        ref = float(jnp.quantile(raw[key], 1.0 - rate))
        assert abs(shifts[head] - ref) <= LOGIT_ATOL
        np.testing.assert_allclose(
            getattr(model, head).Dense_0.bias.detach().numpy(),
            (before[head] - shifts[head]).numpy(), rtol=0, atol=1e-7)


def test_overflow_redecodes_to_full_notes(served):
    audio, variables, _, _ = served

    big = TranscriptionPipeline(_port_model(variables), MelSpec(n_mels=N_MELS),
                                capacity=512, device='cpu')
    small = TranscriptionPipeline(_port_model(variables),
                                  MelSpec(n_mels=N_MELS), capacity=1,
                                  device='cpu')

    expected = big(audio)
    assert min(len(p) for p, _ in expected) > 1
    for (p_small, i_small), (p_big, i_big) in zip(small(audio), expected):
        np.testing.assert_array_equal(p_small, p_big)
        np.testing.assert_array_equal(i_small, i_big)


def test_building_a_pipeline_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    model = OnsetsFrames2(dim_in=16, profile=tools.PianoProfile(),
                          model_complexity=2)
    TranscriptionPipeline(model, MelSpec(n_mels=16), device='cpu')

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_pipeline_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the default device is valid')

    model = OnsetsFrames2(dim_in=16, profile=tools.PianoProfile(),
                          model_complexity=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TranscriptionPipeline(model, MelSpec(n_mels=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_activity(model, MelSpec(n_mels=16), np.zeros((1, 4000)))


_IMPORT_CHECK = r'''
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import amt_tools_tpu_torch
for info in pkgutil.walk_packages(amt_tools_tpu_torch.__path__,
                                  'amt_tools_tpu_torch.'):
    importlib.import_module(info.name)
import chip_smoke
banned = ('jax', 'flax', 'optax', 'ml_dtypes', 'amt_tools_tpu')
leaked = sorted(name for name in sys.modules
                if name in banned or name.startswith(tuple(b + '.' for b in banned)))
print('LEAKED', leaked)
'''


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, '-c', _IMPORT_CHECK, str(REPO)],
                         capture_output=True, text=True, check=True,
                         cwd=REPO)
    assert 'LEAKED []' in out.stdout, out.stdout + out.stderr


def test_no_import_statement_names_jax():
    """Also imports inside functions, which a run may never reach."""

    banned = {'jax', 'flax', 'optax', 'ml_dtypes', 'amt_tools_tpu'}
    sources = sorted((REPO / 'amt_tools_tpu_torch').rglob('*.py'))
    sources.append(REPO / 'chip_smoke.py')

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
