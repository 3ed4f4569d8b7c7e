"""The port's deployment artifacts against the live port and the JAX package.

Mirrors ``tests/test_export.py`` on the CPU: the same Flax variables
(random init, then JAX's ``calibrate_activity``) serve the JAX pipeline and,
through ``weights.from_flax``, the port's. The port's artifact must equal
the live port pipeline bit for bit (notes and buffers: the program runs the
same ops and the same kernels' ops); against JAX's artifact its notes are
held to PARITY.md's rule (``tests/test_torch_pipeline.py``): the thresholded
maps may differ only where the JAX logit lies within ``LOGIT_ATOL`` of the
threshold, and outside those pitch rows every note is equal. The streaming
artifact equals the live port model bit for bit and JAX's streaming
artifact within 1e-5 in float32, maps and carries.
"""

import io
import json
import warnings
import zipfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from amt_tools_tpu import tools as jtools
from amt_tools_tpu.export import export_serving as jax_export_serving
from amt_tools_tpu.export import export_streaming as jax_export_streaming
from amt_tools_tpu.export import load_serving as jax_load_serving
from amt_tools_tpu.export import load_streaming as jax_load_streaming
from amt_tools_tpu.features import MelSpec as JaxMelSpec
from amt_tools_tpu.models import OnsetsFrames2 as JaxOnsetsFrames2
from amt_tools_tpu.models import OnsetsFramesOnline as JaxOnsetsFramesOnline
from amt_tools_tpu.serving import TranscriptionPipeline as JaxPipeline
from amt_tools_tpu.serving import calibrate_activity as jax_calibrate

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.datasets import random_notes, render_notes
from amt_tools_tpu_torch.export import (export_serving, export_streaming,
                                        load_serving, load_streaming,
                                        save_serving)
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2, OnsetsFramesOnline
from amt_tools_tpu_torch.ops import decode
from amt_tools_tpu_torch.serving import (TranscriptionPipeline,
                                         calibrate_quant_stats)
from amt_tools_tpu_torch.weights import from_flax

torch.set_num_threads(1)

SAMPLE_RATE, CLIP_SECONDS, N_MELS = 16000, 3.0, 72
LOGIT_ATOL = 2e-3   # PARITY.md: float32 logits, port vs JAX
STREAM_TOL = 1e-5   # float32 streaming maps and carries, port vs JAX


@pytest.fixture(scope='module')
def served():
    """Audio, the calibrated Flax variables, JAX's logits and its
    artifact's notes, and the port's live pipeline on those variables."""

    profile = jtools.PianoProfile()
    rng = np.random.RandomState(0)
    clips = []
    for b in range(4):
        pitches, intervals = random_notes(tools.PianoProfile(), CLIP_SECONDS,
                                          40, rng)
        clips.append(render_notes(pitches, intervals, SAMPLE_RATE,
                                  CLIP_SECONDS, seed=b))
    audio = np.stack(clips)

    jax_mel = JaxMelSpec(n_mels=N_MELS)
    jax_model = JaxOnsetsFrames2(dim_in=N_MELS, profile=profile,
                                 model_complexity=2)
    feats = jax_model.pre_proc(
        {jtools.KEY_FEATS: jax_mel.process_jax(jnp.asarray(audio))})
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                        feats[jtools.KEY_FEATS])
    variables = jax_calibrate(jax_model, variables, jax_mel,
                              jnp.asarray(audio))
    raw = jax_model.apply(variables, feats[jtools.KEY_FEATS])

    jax_pipe = JaxPipeline(jax_model, variables, jax_mel, capacity=256)
    jax_artifact = jax_load_serving(jax_export_serving(
        jax_pipe, audio.shape[-1], batch_size=4))
    jax_notes = jax_artifact(audio)

    pipeline = TranscriptionPipeline(_port_model(variables),
                                     MelSpec(n_mels=N_MELS), capacity=256,
                                     device='cpu')

    return audio, variables, raw, jax_notes, pipeline


@pytest.fixture(scope='module')
def artifact_bytes(served):
    audio, _, _, _, pipeline = served

    return export_serving(pipeline, audio.shape[-1], batch_size=4)


@pytest.fixture(scope='module')
def artifact(artifact_bytes):
    return load_serving(artifact_bytes)


def _port_model(variables, **kwargs):
    model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                          model_complexity=2, **kwargs)
    model.load_state_dict(from_flax(variables), strict=not kwargs)

    return model


def _assert_same_notes(got, expected):
    assert len(got) == len(expected)
    for (p_g, i_g), (p_e, i_e) in zip(got, expected):
        np.testing.assert_array_equal(p_g, p_e)
        np.testing.assert_array_equal(i_g, i_e)


def test_export_round_trip_matches_live_pipeline(served, tmp_path):
    audio, _, _, _, pipeline = served
    num_samples = audio.shape[-1]

    path = tmp_path / 'serving.amtx'
    with warnings.catch_warnings():
        warnings.simplefilter('error')  # the batch stays symbolic
        meta = save_serving(path, pipeline, num_samples, batch_size=4,
                            platforms=['cpu'])
    assert meta['num_samples'] == num_samples
    assert meta['capacity'] == 256
    assert meta['platforms'] == ['cpu']
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ['meta.json', 'module.bin',
                                         'times.npy']

    artifact = load_serving(path)
    live = pipeline(audio)
    frozen = artifact(audio)

    assert any(len(p) for p, _ in live), 'probe produced no notes'
    _assert_same_notes(frozen, live)

    # The device buffers too, bit for bit
    buffers = artifact._module(torch.from_numpy(audio))
    for got, want in zip(buffers, pipeline._decode(torch.from_numpy(audio),
                                                   256)):
        assert torch.equal(got, want)


def test_artifact_notes_match_jax_artifact(served, artifact):
    audio, _, jax_raw, jax_notes, pipeline = served

    notes = artifact(audio)
    with torch.no_grad():
        feats = MelSpec(n_mels=N_MELS).process(torch.from_numpy(audio))
        model = pipeline.model
        port_raw = model(model.pre_proc({tools.KEY_FEATS: feats})[
            tools.KEY_FEATS])

    # (B, 88): the pitch rows whose thresholded maps differ
    rows = np.zeros((audio.shape[0], 88), dtype=bool)
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
        ref = np.asarray(jax_raw[key])
        got = port_raw[key].numpy()
        np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL)

        maps = [decode.threshold(decode.sigmoid(torch.from_numpy(
            np.swapaxes(x, -1, -2)))).numpy() > 0 for x in (got, ref)]
        differ = maps[0] != maps[1]
        assert (np.abs(np.swapaxes(ref, -1, -2)[differ]) <= LOGIT_ATOL).all()
        rows |= differ.any(-1)

    low = tools.PianoProfile().low
    compared = 0
    for b, ((p_got, i_got), (p_ref, i_ref)) in enumerate(zip(notes,
                                                             jax_notes)):
        keep_got = ~rows[b][p_got.astype(int) - low]
        keep_ref = ~rows[b][p_ref.astype(int) - low]
        np.testing.assert_array_equal(p_got[keep_got], p_ref[keep_ref])
        np.testing.assert_allclose(i_got[keep_got], i_ref[keep_ref],
                                   rtol=0, atol=1e-9)
        compared += keep_ref.sum()
    assert compared > 0


def test_export_symbolic_batch_serves_any_size(served, artifact):
    audio, _, _, _, pipeline = served

    assert artifact.meta['symbolic_batch']
    assert artifact.meta['batch_size'] is None
    for batch in (1, 3):
        _assert_same_notes(artifact(audio[:batch]), pipeline(audio[:batch]))


def test_artifact_rejects_wrong_length(served, artifact):
    audio = served[0]

    with pytest.raises(ValueError, match='samples'):
        artifact(np.zeros((2, audio.shape[-1] // 2), np.float32))


def test_artifact_overflow_warns_and_truncates(served):
    audio, variables, _, _, _ = served

    tiny = TranscriptionPipeline(_port_model(variables),
                                 MelSpec(n_mels=N_MELS), capacity=1,
                                 device='cpu')
    artifact = load_serving(export_serving(tiny, audio.shape[-1],
                                           batch_size=4))

    with pytest.warns(UserWarning, match='overflow'):
        notes = artifact(audio)
    assert max(len(p) for p, _ in notes) == 1


def test_cuda_artifact_refused_without_a_card(artifact_bytes):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')

    data = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(artifact_bytes)) as zin, \
            zipfile.ZipFile(data, 'w') as zout:
        for name in zin.namelist():
            content = zin.read(name)
            if name == 'meta.json':
                meta = json.loads(content)
                meta['platforms'] = ['cuda']
                content = json.dumps(meta)
            zout.writestr(name, content)

    with pytest.raises(RuntimeError, match='does not run on the CPU'):
        load_serving(data.getvalue())


def test_loading_turns_tf32_off(artifact_bytes):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    load_serving(artifact_bytes)

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _online_pair(dim_in=48):
    jax_model = JaxOnsetsFramesOnline(dim_in=dim_in,
                                      profile=jtools.PianoProfile(),
                                      model_complexity=2)
    variables = jax_model.init(
        {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(1)},
        jnp.zeros((1, 1, dim_in, 1)), train=False)
    # A bias on the heads keeps some cells on, so the maps say something
    variables = jax.tree_util.tree_map(np.array, variables)
    variables['params']['adjoin_out']['Dense_0']['bias'] += 2.0
    variables['params']['onset_out']['Dense_0']['bias'] += 2.0
    model = OnsetsFramesOnline(dim_in=dim_in, profile=tools.PianoProfile(),
                               model_complexity=2)
    model.load_state_dict(from_flax(variables))

    return jax_model, variables, model.eval()


def test_streaming_export_matches_live_model_and_jax():
    jax_model, variables, model = _online_pair()
    feats = np.random.RandomState(0).rand(1, 1, 48, 6).astype(np.float32)

    artifact = load_streaming(export_streaming(model))
    assert artifact.meta['batch_size'] == 1
    jax_artifact = jax_load_streaming(jax_export_streaming(jax_model,
                                                           variables))

    carries_frozen = artifact.init_carries()
    carries_live = model.init_carries(1)
    carries_jax = jax_artifact.init_carries()
    on = 0
    for i in range(feats.shape[-1]):
        frame = feats[..., i:i + 1]
        out_f, carries_frozen = artifact.step(carries_frozen, frame)
        with torch.no_grad():
            batch = model.pre_proc({tools.KEY_FEATS: torch.from_numpy(frame)})
            raw, carries_live = model(batch[tools.KEY_FEATS],
                                      carries=carries_live)
            out_l = model.post_proc({tools.KEY_OUTPUT: raw})
        out_j, carries_jax = jax_artifact.step(carries_jax,
                                               jnp.asarray(frame))

        for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
            assert torch.equal(out_f[key], out_l[key])
            np.testing.assert_allclose(out_f[key].numpy(),
                                       np.asarray(out_j[key]), rtol=0,
                                       atol=STREAM_TOL)
            on += int(out_f[key].sum())
    assert on > 0, 'no cell of the maps was on'

    for name in ('onset', 'adjoin'):
        for frozen, live, theirs in zip(carries_frozen[name],
                                        carries_live[name],
                                        carries_jax[name]):
            assert torch.equal(frozen, live)
            assert frozen.dtype == torch.float32
            np.testing.assert_allclose(frozen.numpy(), np.asarray(theirs),
                                       rtol=0, atol=STREAM_TOL)

    with pytest.raises(ValueError, match='shape'):
        artifact.step(carries_frozen, feats[..., :2])


def test_streaming_export_rejects_non_streaming_model():
    model = OnsetsFrames2(dim_in=48, profile=tools.PianoProfile(),
                          model_complexity=2)

    with pytest.raises(TypeError, match='init_carries'):
        export_streaming(model)


@pytest.mark.parametrize('quant', [True, 'static'])
def test_quant_pipeline_exports(served, quant):
    """Int8 serving exports, dynamic and static (the calibrated scales are
    the layers' buffers, frozen into the program). The int8 layers' im2col
    chunks are sized from the batch, so both go the concrete-batch way,
    with the warning, and refuse another batch."""

    audio, variables, _, _, pipeline = served

    model = _port_model(variables, quant_acoustic=quant)
    if quant == 'static':
        calibrate_quant_stats(model, pipeline.data_proc, audio, device='cpu')
    qpipe = TranscriptionPipeline(model, pipeline.data_proc, capacity=256,
                                  device='cpu')

    with pytest.warns(UserWarning, match='symbolic-batch export'):
        data = export_serving(qpipe, audio.shape[-1], batch_size=4)
    artifact = load_serving(data)

    assert not artifact.meta['symbolic_batch']
    assert artifact.meta['batch_size'] == 4
    _assert_same_notes(artifact(audio), qpipe(audio))
    with pytest.raises(ValueError, match='fixed batch'):
        artifact(audio[:2])


def test_export_rejects_mesh_pipeline(served, tmp_path):
    """A pipeline on a one-rank gloo mesh is refused."""

    from amt_tools_tpu_torch.parallel import get_mesh

    audio, variables, _, _, _ = served
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/store',
                            rank=0, world_size=1)
    try:
        sharded = TranscriptionPipeline(_port_model(variables),
                                        MelSpec(n_mels=N_MELS),
                                        capacity=256, device='cpu',
                                        mesh=get_mesh(device='cpu'))
        with pytest.raises(ValueError, match='mesh'):
            export_serving(sharded, audio.shape[-1])
    finally:
        dist.destroy_process_group()


def test_platforms_must_name_the_pipeline_device(served):
    audio, _, _, _, pipeline = served

    with pytest.raises(ValueError, match='platforms'):
        export_serving(pipeline, audio.shape[-1], platforms=['cuda'])
