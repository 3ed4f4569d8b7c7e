"""The port's Hopper kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit, without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances:
- STFT power: 1e-5 of each clip's peak power on both routes (both float32,
  an FFT or a DFT sum against the plain matmul's order);
- CQT magnitudes (kernels C and D): 1e-5 of each clip's peak magnitude
  against the plain versions, on every route (``exact=True``: float32 sums
  in another order; 'high' and False: the same bf16 hi/lo split on both
  sides, whose products are exact in float32, summed in another order), and
  D within 1e-5 of C on the full bank in the same mode;
- LSTM float32: 1e-4 absolute after hundreds of steps (float32 products in
  another order, compounded through the recurrence);
- LSTM bf16: 1e-2 absolute at most and 8e-5 absolute on the mean, on
  outputs in (-1, 1). The plain version's cuBLAS product sums in another
  order, which moves an occasional gate across a bf16 rounding boundary
  (2^-8 relative) and the recurrence carries the difference for a few
  steps. Every output rounds to bf16, so the max alone cannot tell sound
  numerics from a bf16 carry or the logistic sigmoid; the mean can
  (``tests/test_torch_lstm_kernel.py`` shows both faults exceed it);
- LSTM with residuals (kernel E): h as for B and bit for bit equal to
  kernel B's; gates and c within 1e-4 (float32) or 2e-2 (bf16) of their
  largest value, and 1e-5 or 1e-4 absolute on the mean;
- BPTT (kernel F): da and dW_h = h_prev^T da within 1e-4 (float32) or
  5e-4 (bf16) of their largest value, and 1e-5 or 1e-4 of their mean
  magnitude on the mean, on residuals that both versions share. In bf16 a
  sum in another order moves an occasional carry-product operand by one
  bf16 ulp; unrounded da or a float32 W_h^T in the carry product moves
  every one and exceeds the mean (``tests/test_torch_lstm_grad.py`` shows
  both faults do).
"""

import numpy as np
import pytest
import torch

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import CQT, MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2, TabCNN
from amt_tools_tpu_torch.ops import cuda_build, decode, lstm_kernel, spectral
from amt_tools_tpu_torch.ops.cqt_kernel import (ROUTES, cqt_mag,
                                                cqt_mag_grouped,
                                                cqt_mag_grouped_plain,
                                                cqt_mag_plain, cqt_route)
from amt_tools_tpu_torch.ops.lstm_kernel import (_shift_prev, bptt_geometry,
                                                 bptt_launch_plan,
                                                 bptt_max_rows, bptt_resident,
                                                 lstm_bptt, lstm_bptt_plain,
                                                 lstm_scan, lstm_scan_grad,
                                                 lstm_scan_plain,
                                                 lstm_scan_residuals,
                                                 lstm_scan_residuals_plain,
                                                 scan_geometry,
                                                 scan_launch_plan,
                                                 scan_max_rows, scan_resident)
from amt_tools_tpu_torch.ops.stft_kernel import (stft_power, stft_power_plain,
                                                 stft_route)
from amt_tools_tpu_torch.serving import (TablaturePipeline,
                                         TranscriptionPipeline,
                                         calibrate_tablature_activity)

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


@pytest.mark.parametrize('n_fft,hop,center,num_samples,route', [
    (2048, 512, True, 48000, 'fft'), (2048, 512, False, 48001, 'fft'),
    (512, 160, True, 12345, 'fft'), (512, 128, False, 9001, 'fft'),
    (256, 64, True, 7777, 'fft'), (256, 100, False, 9000, 'fft'),
    (400, 128, False, 9000, 'dft'), (400, 160, True, 12345, 'dft')])
def test_stft_kernel_matches_plain(cuda, n_fft, hop, center, num_samples,
                                   route):
    """Both routes, centred and not, at frame counts that leave the last
    tile ragged; the route counter shows which one ran."""

    audio = _audio(3, num_samples).to(cuda)
    bank = torch.from_numpy(spectral.dft_bank(n_fft)).to(cuda)
    assert stft_route(n_fft, hop, n_fft // 2 + 1) == route

    launches, fft = stft_power.launches, stft_power.fft_launches
    got = stft_power(audio, bank, n_fft, hop, center=center)
    torch.cuda.synchronize()
    assert stft_power.launches == launches + 1
    assert stft_power.fft_launches == fft + (route == 'fft')

    ref = stft_power_plain(audio, bank, n_fft, hop, center=center)
    assert got.shape == ref.shape
    peak = ref.amax(dim=(1, 2), keepdim=True)
    assert ((got - ref).abs() / peak).max().item() <= 1e-5


def test_stft_fft_route_takes_the_window_from_the_bank(cuda):
    """win_length < n_fft: the bank's bin-0 column is the centre-padded
    window, which the FFT route reads."""

    window = spectral.hann_window(300)
    bank = torch.from_numpy(spectral.dft_bank(512, 300, window)).to(cuda)
    audio = _audio(2, 8000, seed=6).to(cuda)

    fft = stft_power.fft_launches
    got = stft_power(audio, bank, 512, 128)
    assert stft_power.fft_launches == fft + 1
    ref = stft_power_plain(audio, bank, 512, 128)
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


# The cluster kernels at batches below, at and above one cluster of 8 rows
# and one wave (130 rows), ragged and long T, H resident (16, 48, 64, 256)
# and streamed (512, 1024) in both dtypes; at H = 16 and 48 a CTA owns
# fewer units than a warp's 8, so padded unit columns run
CLUSTER_SHAPES = [(batch, frames, hidden) for batch in (1, 3, 8, 130)
                  for frames in (37, 300)
                  for hidden in (16, 48, 64, 256, 512, 1024)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('shape', CLUSTER_SHAPES)
def test_cluster_lstm_matches_plain_and_e_equals_b(cuda, dtype, reverse,
                                                   shape):
    batch, frames, hidden = shape
    g = torch.Generator().manual_seed(batch * 7 + hidden)
    xw = torch.randn(batch, frames, 4 * hidden, generator=g) * 0.5
    w_h = torch.nn.init.orthogonal_(torch.empty(hidden, 4 * hidden),
                                    generator=g)
    xw, w_h = xw.to(cuda, dtype), w_h.to(cuda, dtype)
    assert scan_launch_plan(batch, hidden, dtype, cuda)['resident'] == (
        hidden <= 256)

    got = lstm_scan(xw, w_h, reverse=reverse)
    ref = lstm_scan_plain(xw, w_h, reverse=reverse)
    atol, mean_atol = {torch.float32: (1e-4, 1e-5),
                       torch.bfloat16: (1e-2, 8e-5)}[dtype]
    diff = (got.float() - ref.float()).abs()
    assert diff.max().item() <= atol and diff.mean().item() <= mean_atol

    assert torch.equal(lstm_scan_residuals(xw, w_h, reverse)[0], got)


def test_lstm_geometry_matches_the_kernel(cuda):
    """The shared-memory layout of kernels B and E is computed twice: in
    the kernel, and by the wrapper to size the launch and plan the
    clusters. The two agree."""

    lib = cuda_build.library('lstm_scan', lstm_kernel._SCAN_SIGNATURES)
    for hidden in (16, 48, 64, 256, 384, 512, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            resident = scan_resident(hidden, dtype)
            for rows in (1, 8, scan_max_rows(hidden, dtype, resident)):
                assert lib.lstm_scan_smem(
                    hidden, int(dtype == torch.bfloat16), rows,
                    int(resident)) == scan_geometry(hidden, dtype, rows,
                                                    resident)['bytes']


def test_lstm_serving_batch_runs_in_one_wave(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        plan = scan_launch_plan(128, 256, dtype, cuda)
        assert plan['resident'] and plan['waves'] == 1
        assert plan['clusters'] <= plan['active_clusters']


# (batch, frames, hidden): small and ragged (B not a multiple of 8 rows, T
# not of the Pallas kernels' 16), and the training shape
TRAIN_SHAPES = [(3, 37, 64), (8, 625, 256)]
RESIDUAL_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-4)}
BPTT_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (5e-4, 1e-4)}


def _lstm_inputs(batch, frames, hidden, dtype, device, seed=3):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(batch, frames, 4 * hidden, generator=g) * 0.5
    w_h = torch.nn.init.orthogonal_(torch.empty(hidden, 4 * hidden),
                                    generator=g)
    dout = torch.randn(batch, frames, hidden, generator=g)
    return xw.to(device, dtype), w_h.to(device, dtype), dout.to(device, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('shape', TRAIN_SHAPES)
def test_lstm_residuals_kernel_matches_plain(cuda, dtype, reverse, shape):
    xw, w_h, _ = _lstm_inputs(*shape, dtype, cuda)

    launches = lstm_scan_residuals.launches
    got = lstm_scan_residuals(xw, w_h, reverse)
    torch.cuda.synchronize()
    assert lstm_scan_residuals.launches == launches + 1

    assert torch.equal(got[0], lstm_scan(xw, w_h, reverse))
    ref = lstm_scan_residuals_plain(xw, w_h, reverse)
    atol, mean_atol = {torch.float32: (1e-4, 1e-5),
                       torch.bfloat16: (1e-2, 8e-5)}[dtype]
    diff = (got[0].float() - ref[0].float()).abs()
    assert diff.max().item() <= atol and diff.mean().item() <= mean_atol

    rel, mean_tol = RESIDUAL_TOL[dtype]
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == torch.float32
        diff = (a - b).abs()
        assert diff.max().item() <= rel * b.abs().max().item()
        assert diff.mean().item() <= mean_tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('shape', TRAIN_SHAPES)
def test_lstm_bptt_kernel_matches_plain(cuda, dtype, reverse, shape):
    xw, w_h, dout = _lstm_inputs(*shape, dtype, cuda)
    out, gates, c_seq = lstm_scan_residuals(xw, w_h, reverse)
    w_h_t = w_h.t().contiguous()

    launches = lstm_bptt.launches
    got = lstm_bptt(gates, c_seq, dout, w_h_t, reverse)
    torch.cuda.synchronize()
    assert lstm_bptt.launches == launches + 1

    ref = lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse)
    assert got.dtype == ref.dtype == torch.float32

    hidden = shape[-1]
    h_prev = _shift_prev(out, reverse).float().reshape(-1, hidden).t()
    max_rel, mean_rel = BPTT_TOL[dtype]
    for a, b in ((got, ref), (h_prev @ got.reshape(-1, 4 * hidden),
                              h_prev @ ref.reshape(-1, 4 * hidden))):
        diff = (a - b).abs()
        assert diff.max().item() <= max_rel * b.abs().max().item()
        assert diff.mean().item() <= mean_rel * b.abs().mean().item()


def _bptt_errors(got, ref, out, reverse):
    """Max over the largest and mean over the mean magnitude, of da and of
    dW_h = h_prev^T da."""

    hidden = out.shape[-1]
    h_prev = _shift_prev(out, reverse).float().reshape(-1, hidden).t()
    errors = []
    for a, b in ((got, ref), (h_prev @ got.reshape(-1, 4 * hidden),
                              h_prev @ ref.reshape(-1, 4 * hidden))):
        diff = (a - b).abs()
        errors.append(((diff.max() / b.abs().max()).item(),
                       (diff.mean() / b.abs().mean()).item()))
    return errors


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('shape', CLUSTER_SHAPES)
def test_cluster_bptt_matches_plain(cuda, dtype, reverse, shape):
    """Kernel F's clusters at the shapes of kernel B's: rows a cluster from
    1 to a full wave and past it, ragged T, the W_h^T slice resident (H up
    to 256) and streamed (512, 1024), padded units (H = 16, 48)."""

    batch, frames, hidden = shape
    xw, w_h, dout = _lstm_inputs(batch, frames, hidden, dtype, cuda,
                                 seed=batch * 7 + hidden)
    out, gates, c_seq = lstm_scan_residuals(xw, w_h, reverse)
    w_h_t = w_h.t().contiguous()
    assert bptt_launch_plan(batch, hidden, dtype, cuda)['resident'] == (
        hidden <= 256)

    launches = lstm_bptt.launches
    got = lstm_bptt(gates, c_seq, dout, w_h_t, reverse)
    torch.cuda.synchronize()
    assert lstm_bptt.launches == launches + 1
    ref = lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse)

    max_rel, mean_rel = BPTT_TOL[dtype]
    for worst, mean in _bptt_errors(got, ref, out, reverse):
        assert worst <= max_rel and mean <= mean_rel, (worst, mean)


def test_bptt_geometry_matches_the_kernel(cuda):
    """Kernel F's shared-memory layout, computed in the kernel and by the
    wrapper, agrees."""

    lib = cuda_build.library('lstm_bptt', lstm_kernel._BPTT_SIGNATURES)
    for hidden in (16, 48, 64, 256, 384, 512, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            resident = bptt_resident(hidden, dtype)
            for rows in (1, 8, bptt_max_rows(hidden, dtype, resident)):
                assert lib.lstm_bptt_smem(
                    hidden, int(dtype == torch.bfloat16), rows,
                    int(resident)) == bptt_geometry(hidden, dtype, rows,
                                                    resident)['bytes']


def test_bptt_training_batch_runs_in_one_wave(cuda):
    """At the recipe's B = 8: 8 clusters of one row, 64 SMs, one wave."""

    for dtype in (torch.float32, torch.bfloat16):
        plan = bptt_launch_plan(8, 256, dtype, cuda)
        assert plan['resident'] and plan['waves'] == 1
        assert (plan['rows'], plan['clusters'], plan['ctas']) == (1, 8, 64)


@pytest.mark.parametrize('reverse', [False, True])
def test_lstm_grad_on_cuda_matches_autograd_through_plain(cuda, reverse):
    xw, w_h, dout = _lstm_inputs(3, 37, 64, torch.float32, cuda)

    grads = []
    for fn in (lstm_scan_grad, lstm_scan_plain):
        x = xw.clone().requires_grad_()
        w = w_h.clone().requires_grad_()
        (fn(x, w, reverse) * dout).sum().backward()
        grads.append((x.grad, w.grad))

    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def _close_to_peak(got, ref):
    peak = ref.amax(dim=(1, 2), keepdim=True)
    return ((got - ref).abs() / peak).max().item()


def _guitar_cqt(grouped, group_size=64, n_bins=192):
    return CQT(n_bins=n_bins, bins_per_octave=24, exact='high',
               grouped=grouped, group_size=group_size)


@pytest.mark.parametrize('exact', [True, 'high', False])
@pytest.mark.parametrize('num_samples', [22050 * 3, 12345])
def test_cqt_kernel_matches_plain(cuda, exact, num_samples):
    cqt = _guitar_cqt(grouped=False)
    audio = _audio(3, num_samples).to(cuda)
    bank = torch.from_numpy(cqt._kernel).to(cuda)

    route = cqt_route(exact)
    counts = {r: getattr(cqt_mag, f'{r}_launches') for r in ROUTES}
    launches = cqt_mag.launches
    got = cqt_mag(audio, bank, cqt._support, 512, exact=exact)
    torch.cuda.synchronize()
    assert cqt_mag.launches == launches + 1
    for r in ROUTES:
        assert getattr(cqt_mag, f'{r}_launches') == counts[r] + (r == route)

    ref = cqt_mag_plain(audio, bank, cqt._support, 512, exact=exact)
    assert got.shape == ref.shape == (3, 192, 1 + num_samples // 512)
    assert _close_to_peak(got, ref) <= 1e-5


@pytest.mark.parametrize('exact', [True, 'high', False])
@pytest.mark.parametrize('n_bins,group_size,num_samples',
                         [(192, 64, 22050 * 2), (80, 32, 22050 * 2),
                          (192, 64, 12345)])
def test_cqt_grouped_kernel_matches_plain_and_full_bank(cuda, exact, n_bins,
                                                        group_size,
                                                        num_samples):
    """(80, 32) gives groups of 32, 32 and 16: the last is column padded;
    12,345 samples take the 4-byte copies of the tensor-core route."""

    cqt = _guitar_cqt(grouped=True, group_size=group_size, n_bins=n_bins)
    audio = _audio(2, num_samples, seed=4).to(cuda)
    stack = torch.from_numpy(cqt._bank_stack).to(cuda)
    args = (stack, cqt._group_supports, cqt._group_bins, 512)

    route = cqt_route(exact)
    counts = {r: getattr(cqt_mag_grouped, f'{r}_launches') for r in ROUTES}
    launches = cqt_mag_grouped.launches
    got = cqt_mag_grouped(audio, *args, exact=exact)
    torch.cuda.synchronize()
    assert cqt_mag_grouped.launches == launches + 1
    for r in ROUTES:
        assert getattr(cqt_mag_grouped, f'{r}_launches') == (
            counts[r] + (r == route))

    assert _close_to_peak(
        got, cqt_mag_grouped_plain(audio, *args, exact=exact)) <= 1e-5
    full = cqt_mag(audio, torch.from_numpy(cqt._kernel).to(cuda),
                   cqt._support, 512, exact=exact)
    assert _close_to_peak(got, full) <= 1e-5


def test_tablature_pipeline_on_cuda_matches_cpu(cuda):
    """A float32 TabCNN behind the serving CQT recipe, the card (kernel D)
    against the CPU (plain versions): logits within 2e-3, tablature equal
    wherever the CPU's top-two margin exceeds 4e-3, and identical notes on
    every string whose tablature is equal."""

    profile = tools.GuitarProfile(num_frets=19)
    cqt = _guitar_cqt(grouped='auto')
    audio = _audio(2, 22050 * 4, seed=5)
    model = TabCNN(dim_in=192, profile=profile, fullseq=True,
                   generator=torch.Generator().manual_seed(6))
    calibrate_tablature_activity(model, cqt, audio, device='cpu')

    outputs = {}
    for device in ('cpu', cuda):
        launches = cqt_mag_grouped.launches
        notes = TablaturePipeline(model, cqt, capacity=64,
                                  device=device)(audio.numpy())
        with torch.no_grad():
            feats = cqt.process(audio.to(device))
            raw = model(model.pre_proc({tools.KEY_FEATS: feats})[
                tools.KEY_FEATS])[tools.KEY_TABLATURE].cpu()
        if device == cuda:
            assert cqt_mag_grouped.launches == launches + 2
        outputs[str(device)] = notes, raw

    (cpu_notes, cpu_raw), (gpu_notes, gpu_raw) = outputs['cpu'], outputs['cuda']
    assert (gpu_raw - cpu_raw).abs().max().item() <= 2e-3

    head = model.tablature_out
    cpu_tab = head.finalize_output(cpu_raw)
    gpu_tab = head.finalize_output(gpu_raw)
    top2 = cpu_raw.reshape(2, -1, 6, 21).topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).transpose(-1, -2)
    assert (margin[cpu_tab != gpu_tab] <= 4e-3).all()

    compared = 0
    for b in range(2):
        for string in range(6):
            if torch.equal(cpu_tab[b, string], gpu_tab[b, string]):
                (p_cpu, i_cpu), (p_gpu, i_gpu) = (cpu_notes[b][string],
                                                  gpu_notes[b][string])
                np.testing.assert_array_equal(p_gpu, p_cpu)
                np.testing.assert_array_equal(i_gpu, i_cpu)
                compared += 1
    assert compared > 0


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
    with pytest.raises(ValueError):
        lstm_scan_residuals(torch.zeros(1, 4, 4 * 2048, device=cuda),
                            torch.zeros(2048, 4 * 2048, device=cuda))
    with pytest.raises(ValueError):  # H = 24: not whole bf16 pairs a CTA
        lstm_scan(torch.zeros(1, 4, 4 * 24, device=cuda),
                  torch.zeros(24, 4 * 24, device=cuda))
    with pytest.raises(TypeError):
        lstm_bptt(torch.zeros(1, 4, 8, device=cuda),
                  torch.zeros(1, 4, 2, device=cuda),
                  torch.zeros(1, 4, 2, device=cuda, dtype=torch.float16),
                  torch.zeros(8, 2, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        lstm_bptt(torch.zeros(1, 4, 8, device=cuda),
                  torch.zeros(1, 4, 2, device=cuda),
                  torch.zeros(1, 4, 2, device=cuda), torch.zeros(8, 2))
    with pytest.raises(ValueError):  # H = 24: not whole bf16 pairs a CTA
        lstm_bptt(torch.zeros(1, 4, 96, device=cuda),
                  torch.zeros(1, 4, 24, device=cuda),
                  torch.zeros(1, 4, 24, device=cuda),
                  torch.zeros(96, 24, device=cuda))

    cqt_bank = torch.zeros(4096, 8, device=cuda)
    with pytest.raises(TypeError):
        cqt_mag(torch.zeros(2, 1000, device=cuda, dtype=torch.float64),
                cqt_bank.double(), 4096, 512)
    with pytest.raises(ValueError):
        cqt_mag(torch.zeros(2, 1000, device=cuda), cqt_bank.cpu(), 4096, 512)
    with pytest.raises(ValueError):
        cqt_mag_grouped(torch.zeros(2, 1000, device=cuda),
                        torch.zeros(33 * 16, 2, device=cuda), (16,) * 33,
                        (1,) * 33, 512)
