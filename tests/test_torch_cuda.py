"""The port's Hopper kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit, without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances:
- STFT power: 1e-5 of each clip's peak power (both float32, sums in
  another order);
- LSTM float32: 1e-4 absolute after hundreds of steps (float32 products in
  another order, compounded through the recurrence);
- LSTM bf16: 1e-2 absolute at most and 8e-5 absolute on the mean, on
  outputs in (-1, 1). The plain version's cuBLAS product sums in another
  order, which moves an occasional gate across a bf16 rounding boundary
  (2^-8 relative) and the recurrence carries the difference for a few
  steps. Every output rounds to bf16, so the max alone cannot tell sound
  numerics from a bf16 carry or the logistic sigmoid; the mean can
  (``tests/test_torch_lstm_kernel.py`` shows both faults exceed it).
"""

import numpy as np
import pytest
import torch

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2
from amt_tools_tpu_torch.ops import decode, spectral
from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan, lstm_scan_plain
from amt_tools_tpu_torch.ops.stft_kernel import stft_power, stft_power_plain
from amt_tools_tpu_torch.serving import TranscriptionPipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the hand-written Hopper kernels)')
    with tools.exact_fp32():
        yield torch.device('cuda')


def _audio(batch, num_samples, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(num_samples) / 16000.0
    freqs = torch.rand(batch, 4, 1, generator=g) * 3000 + 60
    amps = torch.rand(batch, 4, 1, generator=g) * 0.2 + 0.05
    audio = (amps * torch.sin(2 * np.pi * freqs * t)).sum(1)
    return audio + 1e-3 * torch.randn(batch, num_samples, generator=g)


@pytest.mark.parametrize('n_fft,hop,center,num_samples',
                         [(2048, 512, True, 48000),
                          (512, 160, True, 12345),
                          (400, 128, False, 9000)])
def test_stft_kernel_matches_plain(cuda, n_fft, hop, center, num_samples):
    audio = _audio(3, num_samples).to(cuda)
    bank = torch.from_numpy(spectral.dft_bank(n_fft)).to(cuda)

    launches = stft_power.launches
    got = stft_power(audio, bank, n_fft, hop, center=center)
    torch.cuda.synchronize()
    assert stft_power.launches == launches + 1

    ref = stft_power_plain(audio, bank, n_fft, hop, center=center)
    assert got.shape == ref.shape
    peak = ref.amax(dim=(1, 2), keepdim=True)
    assert ((got - ref).abs() / peak).max().item() <= 1e-5


@pytest.mark.parametrize('dtype,atol,mean_atol', [(torch.float32, 1e-4, 1e-5),
                                                  (torch.bfloat16, 1e-2, 8e-5)])
@pytest.mark.parametrize('reverse', [False, True])
def test_lstm_kernel_matches_plain(cuda, dtype, atol, mean_atol, reverse):
    g = torch.Generator().manual_seed(1)
    batch, frames, hidden = 6, 300, 256
    xw = (torch.randn(batch, frames, 4 * hidden, generator=g) * 0.5)
    w_h = torch.nn.init.orthogonal_(torch.empty(hidden, 4 * hidden),
                                    generator=g)
    xw, w_h = xw.to(cuda, dtype), w_h.to(cuda, dtype)

    launches = lstm_scan.launches
    got = lstm_scan(xw, w_h, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_scan.launches == launches + 1

    ref = lstm_scan_plain(xw, w_h, reverse=reverse)
    assert got.dtype == ref.dtype == dtype
    diff = (got.float() - ref.float()).abs()
    assert diff.max().item() <= atol
    assert diff.mean().item() <= mean_atol


def _logits(model, mel, audio):
    with torch.no_grad():
        feats = mel.process(audio)
        return model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])


def test_pipeline_on_cuda_matches_cpu(cuda):
    """A narrow float32 O&F2 on the card (kernels) against the CPU (plain
    versions): logits within 2e-3, and identical notes in every pitch row
    whose thresholded maps agree (a map may differ only where
    |logit| <= 2e-3)."""

    g = torch.Generator().manual_seed(2)
    audio = _audio(2, 32000, seed=3)
    mel = MelSpec(n_mels=64)
    model = OnsetsFrames2(dim_in=64, profile=tools.PianoProfile(),
                          model_complexity=2, generator=g).eval()
    with torch.no_grad():
        model.adjoin_out.Dense_0.bias += 2.0
        model.onset_out.Dense_0.bias += 2.0

    cpu_raw = _logits(model, mel, audio)
    cpu_notes = TranscriptionPipeline(model, mel, capacity=256,
                                      device='cpu')(audio.numpy())

    stft, lstm = stft_power.launches, lstm_scan.launches
    gpu_notes = TranscriptionPipeline(model, mel, capacity=256,
                                      device=cuda)(audio.numpy())
    assert stft_power.launches == stft + 1
    assert lstm_scan.launches == lstm + 6
    gpu_raw = _logits(model, mel, audio.to(cuda))

    rows = torch.zeros(2, 88, dtype=torch.bool)  # pitch rows whose maps differ
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
        ref, got = cpu_raw[key], gpu_raw[key].cpu()
        assert (got - ref).abs().max().item() <= 2e-3
        differ = (decode.threshold(decode.sigmoid(got)) !=
                  decode.threshold(decode.sigmoid(ref)))
        assert (ref[differ].abs() <= 2e-3).all()
        rows |= differ.any(dim=1)

    # The decode works row by row: outside the rows whose maps differ the
    # notes must be identical
    low = tools.PianoProfile().low
    compared = 0
    for b, ((p_gpu, i_gpu), (p_cpu, i_cpu)) in enumerate(zip(gpu_notes,
                                                             cpu_notes)):
        keep_gpu = ~rows[b].numpy()[p_gpu.astype(int) - low]
        keep_cpu = ~rows[b].numpy()[p_cpu.astype(int) - low]
        np.testing.assert_array_equal(p_gpu[keep_gpu], p_cpu[keep_cpu])
        np.testing.assert_array_equal(i_gpu[keep_gpu], i_cpu[keep_cpu])
        compared += keep_cpu.sum()
    assert compared > 0


def test_cuda_tensors_never_take_the_plain_path(cuda):
    bank = torch.from_numpy(spectral.dft_bank(256)).to(cuda)
    with pytest.raises(TypeError):
        stft_power(torch.zeros(2, 1000, device=cuda, dtype=torch.float64),
                   bank.double(), 256, 64)
    with pytest.raises(ValueError):
        stft_power(torch.zeros(2, 1000, device=cuda), bank.cpu(), 256, 64)
    with pytest.raises(ValueError):
        lstm_scan(torch.zeros(1, 4, 4 * 2048, device=cuda),
                  torch.zeros(2048, 4 * 2048, device=cuda))
