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
- int8 layers (``ops/qconv.py``): none. The same float32 input gives the
  same int8 operands (an IEEE division and round half to even on both
  devices), the same int32 accumulators and the same outputs (one multiply
  and one add a value, in the same order), bit for bit;
- a LSTM width the kernels do not take (H = 24, 40), run zero-padded to a
  multiple of 16: 1e-4 on outputs, as kernel B float32, and 1e-4 of the
  largest value on gradients, as the Function's (card against CPU);
- kernel B from a carry: as kernel B on the outputs and the returned h,
  the returned c within the same bound times its largest value; chunks
  that thread the carry bit for bit equal to one launch;
- a training step of the velocity model or TabCNN, card against CPU:
  losses within 1e-4 relative, the gradients of the layers after the conv
  stacks within 1e-3 of their module's largest;
- features computed by loader threads on the card, ``HCQT`` and
  ``AudioFileStream`` frames, card against CPU: 4e-4 on the [0, 1] mel
  features (``amt_tools_tpu/ops/pallas_stft.py:30``) and 2e-4 on the CQT
  ones (``amt_tools_tpu/features/cqt.py:29``), float32 sums in another
  order; features read back from the npz cache bit for bit;
- grouped launches of B, E and F (G sequences in one launch): bit for bit
  the G per-stream launches (a row's arithmetic does not depend on the
  cluster that holds it or on the rows beside it), and each against its
  plain version with the ungrouped kernel's tolerances; dW_h of the
  grouped gradient, one batched matmul, within 1e-5 of its largest value
  of the per-stream matmuls (the same sums, maybe blocked otherwise);
- BPTT (kernel F): da and dW_h = h_prev^T da within 1e-4 (float32) or
  5e-4 (bf16) of their largest value, and 1e-5 or 1e-4 of their mean
  magnitude on the mean, on residuals that both versions share. In bf16 a
  sum in another order moves an occasional carry-product operand by one
  bf16 ulp; unrounded da or a float32 W_h^T in the carry product moves
  every one and exceeds the mean (``tests/test_torch_lstm_grad.py`` shows
  both faults do);
- masked and carried E and F: as E and F, padded steps exactly 0, lengths
  = T and a zero carry bit for bit the unmasked launches, grouped masked
  launches bit for bit the per-stream ones; the initial carry's gradient
  by ``CARRY_GRAD_TOL`` against the plain version and within 1e-5 of its
  largest value against the product of the kernel's own last da; the
  differentiable carried recurrence in chunks against one call by
  ``test_carried_grad_in_chunks_equals_one_call``'s bounds.
"""

import copy

import numpy as np
import pytest
import torch

from amt_tools_tpu_torch import tools
from amt_tools_tpu_torch.features import CQT, MelSpec
from amt_tools_tpu_torch.models import OnsetsFrames2, TabCNN
from amt_tools_tpu_torch.models import run_on_batch as models_run_on_batch
from amt_tools_tpu_torch.models.onsetsframes import LanguageModel
from amt_tools_tpu_torch.ops.lstm import FastLSTM, GroupedBiLSTM
from amt_tools_tpu_torch.ops import (cuda_build, decode, lstm_kernel, qconv,
                                     spectral)
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
from amt_tools_tpu_torch.ops.lstm_kernel import (
    cluster_plan, lstm_bptt_grouped, lstm_bptt_grouped_plain,
    lstm_scan_grouped, lstm_scan_grouped_grad, lstm_scan_grouped_plain,
    lstm_scan_residuals_grouped, lstm_scan_residuals_grouped_plain)
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
    wrapper, agrees, with and without the dh buffer of a masked or carried
    launch."""

    lib = cuda_build.library('lstm_bptt', lstm_kernel._BPTT_SIGNATURES)
    for hidden in (16, 48, 64, 256, 384, 512, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            resident = bptt_resident(hidden, dtype)
            for rows in (1, 8, bptt_max_rows(hidden, dtype, resident)):
                for hold in (False, True):
                    assert lib.lstm_bptt_smem(
                        hidden, int(dtype == torch.bfloat16), rows,
                        int(resident), int(hold)) == bptt_geometry(
                            hidden, dtype, rows, resident, hold)['bytes']


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


# -- int8 layers and the padded LSTM widths --------------------------------


def _card_and_cpu(layer, x, cuda):
    """A layer's int8 operands, int32 accumulators and outputs on the CPU
    and on the card from the same float32 input."""

    on_card = copy.deepcopy(layer).to(cuda)
    with torch.no_grad():
        x8, _ = layer.quantize(x)
        x8_card, _ = on_card.quantize(x.to(cuda))
        acc = layer.accumulate(x8)
        # The CPU's operands on the card
        acc_card = on_card.accumulate(x8.to(cuda))
        out, out_card = layer(x), on_card(x.to(cuda))

    return (x8, x8_card.cpu()), (acc, acc_card.cpu()), (out, out_card.cpu())


@pytest.mark.parametrize('static', [False, True])
@pytest.mark.parametrize('c_in,padding', [
    (48, 'SAME'),   # K = 432 meets torch._int_mm's rules (O&F2's Conv_1)
    (1, 'VALID'),   # K = 9, padded to 16 (TabCNN's conv1)
])
def test_int8_conv_card_equals_cpu(cuda, c_in, padding, static):
    g = torch.Generator().manual_seed(c_in)
    conv = qconv.Int8Conv(c_in, 32, padding=padding, static_scale=static,
                          generator=g)
    conv.bias.data = torch.randn(32, generator=g)
    x = torch.rand(3, c_in, 40, 33, generator=g) * torch.tensor(
        [0.2, 1.0, 3.0]).view(3, 1, 1, 1)
    if static:
        conv.act_amax.fill_(0.8 * float(x.abs().max()))  # some saturate

    (x8, x8_card), (acc, acc_card), (out, out_card) = _card_and_cpu(
        conv, x, cuda)
    assert acc.dtype == acc_card.dtype == torch.int32
    assert acc.shape[-1] == 32 and acc.abs().max() > 0
    assert torch.equal(x8_card, x8)
    assert torch.equal(acc_card, acc)
    assert torch.equal(out_card, out)


@pytest.mark.parametrize('static', [False, True])
@pytest.mark.parametrize('k,n', [(5472, 768), (264, 1024), (9, 12)])
def test_int8_dense_card_equals_cpu(cuda, k, n, static):
    g = torch.Generator().manual_seed(k)
    dense = qconv.Int8Dense(k, n, static_scale=static, generator=g)
    x = torch.randn(2, 37, k, generator=g)
    if static:
        dense.act_amax.fill_(float(x.abs().max()))

    (x8, x8_card), (acc, acc_card), (out, out_card) = _card_and_cpu(
        dense, x, cuda)
    assert torch.equal(x8_card, x8)
    assert torch.equal(acc_card, acc)
    assert torch.equal(out_card, out)


@pytest.mark.parametrize('static', [False, True])
def test_int8_conv_chunks_equal_one_pass_on_the_card(cuda, monkeypatch,
                                                     static):
    """O&F2 complexity 3's Conv_2 over 6 clips of 200 frames: one pass, and
    chunks of 2 whole clips."""

    g = torch.Generator().manual_seed(1)
    conv = qconv.Int8Conv(48, 96, static_scale=static, dtype=torch.bfloat16,
                          generator=g).to(cuda)
    x = torch.rand(6, 48, 200, 114, generator=g).to(cuda, torch.bfloat16)
    if static:
        conv.act_amax.fill_(1.0)

    with torch.no_grad():
        whole = conv(x)
        clip_bytes = 200 * 114 * 432
        monkeypatch.setattr(qconv, 'CHUNK_BYTES', 2 * clip_bytes)
        chunked = conv(x)
    assert whole.dtype == torch.bfloat16 and whole.shape == (6, 96, 200, 114)
    assert torch.equal(chunked, whole)


@pytest.mark.parametrize('hidden', [24, 40, 48])
def test_every_lstm_width_runs_the_kernels(cuda, hidden):
    """A LanguageModel of 24 or 40 units a direction (not a multiple of 16)
    runs kernels B, E and F zero-padded to the next multiple of 16; 48 runs
    them as it is. Forward and backward on the card, held to the same layer
    on the CPU."""

    g = torch.Generator().manual_seed(hidden)
    model = LanguageModel(40, 2 * hidden, generator=g)
    x = torch.randn(4, 50, 40, generator=g)
    dout = torch.randn(4, 50, 2 * hidden, generator=g)

    with torch.no_grad():
        want = model(x)
    model.zero_grad()
    (model(x) * dout).sum().backward()
    want_grads = {n: p.grad.clone() for n, p in model.named_parameters()}

    on_card = copy.deepcopy(model).to(cuda)
    on_card.zero_grad()
    counts = (lstm_scan.launches, lstm_scan_residuals.launches,
              lstm_bptt.launches)
    with torch.no_grad():
        got = on_card(x.to(cuda))
    (on_card(x.to(cuda)) * dout.to(cuda)).sum().backward()
    torch.cuda.synchronize()

    # Two directions: B for the forward, E and F for the trained one
    assert (lstm_scan.launches, lstm_scan_residuals.launches,
            lstm_bptt.launches) == tuple(c + 2 for c in counts)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    for name, param in on_card.named_parameters():
        ref = want_grads[name]
        assert ((param.grad.cpu() - ref).abs().max().item() <=
                1e-4 * ref.abs().max().item()), name

    # The kernels themselves still refuse H = 24, and a layer above
    # MAX_HIDDEN raises rather than leave them
    with pytest.raises(ValueError):
        lstm_scan(torch.zeros(1, 4, 96, device=cuda),
                  torch.zeros(24, 96, device=cuda))
    with pytest.raises(ValueError):
        with torch.no_grad():
            FastLSTM(8, 1040).to(cuda)(torch.zeros(1, 4, 8, device=cuda))


# Kernel B with per-row lengths (bucketed evaluation): lengths 0, 1, T and
# between in one batch, H resident (16, 256) and streamed (512)
MASKED_SHAPES = [(6, 300, 256), (13, 37, 16), (3, 300, 512)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('shape', MASKED_SHAPES)
def test_masked_lstm_kernel_matches_plain(cuda, dtype, reverse, shape):
    """Masked B against its masked plain version (B's tolerances), padded
    outputs exactly 0, each row's valid frames bit for bit the unmasked
    kernel's on the row cut to its length, and full lengths bit for bit
    the unmasked launch."""

    batch, frames, hidden = shape
    g = torch.Generator().manual_seed(batch + hidden)
    xw = torch.randn(batch, frames, 4 * hidden, generator=g) * 0.5
    w_h = torch.nn.init.orthogonal_(torch.empty(hidden, 4 * hidden),
                                    generator=g)
    xw, w_h = xw.to(cuda, dtype), w_h.to(cuda, dtype)
    lengths = torch.randint(0, frames + 1, (batch,), generator=g)
    lengths[:3] = torch.tensor([0, 1, frames])[:batch]
    lengths = lengths.to(cuda)

    launches, masked = lstm_scan.launches, lstm_scan.masked_launches
    got = lstm_scan(xw, w_h, reverse=reverse, lengths=lengths)
    torch.cuda.synchronize()
    assert lstm_scan.launches == launches + 1
    assert lstm_scan.masked_launches == masked + 1

    ref = lstm_scan_plain(xw, w_h, reverse=reverse, lengths=lengths)
    atol, mean_atol = {torch.float32: (1e-4, 1e-5),
                       torch.bfloat16: (1e-2, 8e-5)}[dtype]
    diff = (got.float() - ref.float()).abs()
    assert diff.max().item() <= atol and diff.mean().item() <= mean_atol

    for row, length in enumerate(lengths.tolist()):
        assert torch.count_nonzero(got[row, length:]) == 0
        if length:
            alone = lstm_scan(xw[row: row + 1, :length].contiguous(), w_h,
                              reverse=reverse)
            assert torch.equal(got[row: row + 1, :length], alone), row

    full = torch.full((batch,), frames, dtype=torch.int32, device=cuda)
    assert torch.equal(lstm_scan(xw, w_h, reverse=reverse, lengths=full),
                       lstm_scan(xw, w_h, reverse=reverse))


def test_masked_lstm_at_a_padded_width(cuda):
    """H = 24 (run zero-padded to 32 units) with lengths: the layer on the
    card against the same layer on the CPU, 1e-4 as kernel B float32."""

    g = torch.Generator().manual_seed(24)
    model = LanguageModel(40, 48, generator=g).eval()
    x = torch.randn(5, 60, 40, generator=g)
    lengths = torch.tensor([60, 0, 1, 33, 59])

    with torch.no_grad():
        want = model(x, lengths)
        masked = lstm_scan.masked_launches
        got = copy.deepcopy(model).to(cuda)(x.to(cuda), lengths.to(cuda))
    torch.cuda.synchronize()
    assert lstm_scan.masked_launches == masked + 2
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


class _Tracks:
    """A duck-typed validation set of unequal synthetic piano tracks."""

    def __init__(self, mel, durations):
        from amt_tools_tpu_torch.datasets import SyntheticPiano

        # One set a duration; a split of its own names (and seeds) each
        self.sets = {f'val{i}_000': SyntheticPiano(
            splits=[f'val{i}'], num_tracks=1, track_duration=d,
            data_proc=mel, device='cpu') for i, d in enumerate(durations)}
        self.tracks = list(self.sets)

    def get_track_data(self, track_id):
        return self.sets[track_id].get_track_data(track_id)

    def get_track_frames(self, track_id):
        return self.sets[track_id].get_track_frames(track_id)


def test_bucketed_validate_on_the_card_matches_the_cpu(cuda):
    """A narrow float32 O&F2's bucketed validation (kernel B with lengths)
    on the card against the CPU's: losses within 1e-4 relative (float32
    logits within 2e-3), the frame and note scores within 0.02 (a map may
    differ only where a logit is within 2e-3 of the threshold); the card's
    batched pass (batch-level losses) against its per-track pass on the
    scores, equal."""

    from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                              MultipitchEvaluator,
                                              NoteEvaluator, validate)
    from amt_tools_tpu_torch.transcribe import ComboEstimator, NoteTranscriber

    mel = MelSpec(n_mels=64)
    tracks = _Tracks(mel, [2.1, 3.0, 1.4])
    profile = tools.PianoProfile()
    model = OnsetsFrames2(dim_in=64, profile=profile, model_complexity=2,
                          generator=torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        model.adjoin_out.Dense_0.bias += 2.0
        model.onset_out.Dense_0.bias += 2.0

    def run(device, batch_size):
        evaluator = ComboEvaluator([LossWrapper(), MultipitchEvaluator(),
                                    NoteEvaluator()])
        estimator = ComboEstimator([NoteTranscriber(profile=profile)])
        return validate(copy.deepcopy(model), tracks, evaluator, estimator,
                        bucket=32, batch_size=batch_size, device=device)

    cpu = run('cpu', 1)
    masked = lstm_scan.masked_launches
    card = run(cuda, 1)
    assert lstm_scan.masked_launches == masked + 6 * 3
    batched = run(cuda, 2)

    for key, value in cpu[tools.KEY_LOSS].items():
        assert abs(card[tools.KEY_LOSS][key] - value) <= 1e-4 * abs(value), key
    for group in (tools.KEY_MULTIPITCH, tools.KEY_NOTES):
        for key, value in cpu[group].items():
            assert abs(card[group][key] - value) <= 0.02, (group, key)
        for key, value in card[group].items():
            # the same scores, averaged over the tracks in another order
            assert abs(batched[group][key] - value) <= 1e-12, (group, key)


# Kernel B from a carry (streaming): one row and a few, T = 1 (a frame a
# launch) and longer, H resident (16, 48, 256)
CARRIED_BATCHES = [1, 8]
CARRIED_FRAMES = [1, 37, 300]
CARRIED_HIDDEN = [16, 48, 256]
CHUNKS = (1, 7, 64)  # the chunk lengths, in turn


def _carried_inputs(batch, frames, hidden, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(batch, frames, 4 * hidden, generator=g) * 0.5
    w_h = torch.nn.init.orthogonal_(torch.empty(hidden, 4 * hidden),
                                    generator=g)
    carry = (torch.randn(batch, hidden, generator=g),
             torch.rand(batch, hidden, generator=g) * 2 - 1)
    return (xw.to(device, dtype), w_h.to(device, dtype),
            tuple(x.to(device) for x in carry))


def _chunked(xw, w_h, reverse, carry):
    """The sequence in chunks of CHUNKS' lengths in turn, each launch given
    the previous one's carry; returns (out, final carry)."""

    frames = xw.shape[1]
    bounds, start, k = [], 0, 0
    while start < frames:
        stop = min(frames, start + CHUNKS[k % len(CHUNKS)])
        bounds.append((start, stop))
        start, k = stop, k + 1
    pieces = {}
    for start, stop in (reversed(bounds) if reverse else bounds):
        pieces[start], carry = lstm_scan(
            xw[:, start:stop].contiguous(), w_h, reverse=reverse,
            initial_carry=carry, return_carry=True)
    return torch.cat([pieces[s] for s, _ in bounds], dim=1), carry


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('batch', CARRIED_BATCHES)
@pytest.mark.parametrize('frames', CARRIED_FRAMES)
@pytest.mark.parametrize('hidden', CARRIED_HIDDEN)
def test_carried_lstm_kernel_matches_plain(cuda, dtype, reverse, batch,
                                           frames, hidden):
    """Carried B against its carried plain version (B's tolerances, on the
    outputs and the final carry); chunks that thread the carry equal the
    whole launch bit for bit, outputs and carry; the returned h is the last
    output; a zero carry equals the launch without one bit for bit."""

    xw, w_h, carry = _carried_inputs(batch, frames, hidden, dtype, cuda,
                                     batch * frames + hidden)

    launches, carried = lstm_scan.launches, lstm_scan.carried_launches
    got, (c, h) = lstm_scan(xw, w_h, reverse=reverse, initial_carry=carry,
                            return_carry=True)
    torch.cuda.synchronize()
    assert lstm_scan.launches == launches + 1
    assert lstm_scan.carried_launches == carried + 1
    assert c.dtype == h.dtype == torch.float32

    ref, (ref_c, ref_h) = lstm_scan_plain(xw, w_h, reverse=reverse,
                                          initial_carry=carry,
                                          return_carry=True)
    atol, mean_atol = {torch.float32: (1e-4, 1e-5),
                       torch.bfloat16: (1e-2, 8e-5)}[dtype]
    for mine, theirs in ((got, ref), (h, ref_h)):
        diff = (mine.float() - theirs.float()).abs()
        assert diff.max().item() <= atol and diff.mean().item() <= mean_atol
    # c is unbounded: held relative to its largest value
    assert ((c - ref_c).abs().max().item() <=
            atol * max(1.0, ref_c.abs().max().item()))
    assert torch.equal(h.to(dtype), got[:, 0 if reverse else -1])

    out, (cc, ch) = _chunked(xw, w_h, reverse, carry)
    torch.cuda.synchronize()
    assert torch.equal(out, got) and torch.equal(cc, c) and torch.equal(ch, h)

    zeros = tuple(torch.zeros_like(x) for x in carry)
    assert torch.equal(lstm_scan(xw, w_h, reverse=reverse,
                                 initial_carry=zeros),
                       lstm_scan(xw, w_h, reverse=reverse))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_carried_lstm_with_lengths(cuda, dtype, reverse):
    """A carry together with lengths: against the carried masked plain
    version; a row of length 0 returns its initial carry (h rounded as the
    next step reads it), and the launch is counted both ways."""

    xw, w_h, carry = _carried_inputs(6, 40, 256, dtype, cuda, 5)
    lengths = torch.tensor([40, 0, 1, 17, 39, 40], device=cuda)

    masked, carried = lstm_scan.masked_launches, lstm_scan.carried_launches
    got, (c, h) = lstm_scan(xw, w_h, reverse=reverse, lengths=lengths,
                            initial_carry=carry, return_carry=True)
    torch.cuda.synchronize()
    assert lstm_scan.masked_launches == masked + 1
    assert lstm_scan.carried_launches == carried + 1

    ref, (ref_c, ref_h) = lstm_scan_plain(xw, w_h, reverse=reverse,
                                          lengths=lengths,
                                          initial_carry=carry,
                                          return_carry=True)
    atol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}[dtype]
    assert (got.float() - ref.float()).abs().max().item() <= atol
    assert (h - ref_h).abs().max().item() <= atol
    assert torch.equal(c[1], carry[0][1])
    assert torch.equal(h[1], carry[1][1].to(dtype).float())


def test_carried_fast_lstm_at_a_padded_width(cuda):
    """H = 24 (run zero-padded to 32 units) from a carry, frame by frame:
    the layer on the card against the same layer on the CPU, 1e-4 as kernel
    B float32, on the outputs and the carry; while autograd records, the
    carried kernels E and F, whose gradients (the carry's too) are held to
    the CPU's within 1e-4 of their largest value."""

    g = torch.Generator().manual_seed(24)
    layer = FastLSTM(40, 24, generator=g)
    x = torch.randn(2, 12, 40, generator=g)
    carry = (torch.randn(2, 24, generator=g), torch.randn(2, 24, generator=g))

    def frames(module, device):
        state, outs = tuple(t.to(device) for t in carry), []
        for t in range(x.shape[1]):
            state, out = module(x[:, t: t + 1].to(device),
                                initial_carry=state, return_carry=True)
            outs.append(out)
        return torch.cat(outs, dim=1), state

    with torch.no_grad():
        want, (want_c, want_h) = frames(layer, 'cpu')
        carried = lstm_scan.carried_launches
        got, (c, h) = frames(copy.deepcopy(layer).to(cuda), cuda)
    torch.cuda.synchronize()
    assert lstm_scan.carried_launches == carried + x.shape[1]
    assert c.shape == (2, 24)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    torch.testing.assert_close(h.cpu(), want_h, rtol=0, atol=1e-4)
    torch.testing.assert_close(c.cpu(), want_c, rtol=0, atol=1e-4)

    def grads(module, device):
        state = tuple(t.detach().to(device).requires_grad_() for t in carry)
        (c, h), out = module(x.to(device), initial_carry=state,
                             return_carry=True)
        (out.square().sum() + c.sum() + h.sum()).backward()
        return [p.grad.cpu() for p in module.parameters()] + [
            t.grad.cpu() for t in state]

    want = grads(layer, 'cpu')
    residuals = lstm_kernel.lstm_scan_residuals.carried_launches
    bptt = lstm_bptt.carried_launches
    got = grads(copy.deepcopy(layer).to(cuda), cuda)
    assert lstm_kernel.lstm_scan_residuals.carried_launches == residuals + 1
    assert lstm_bptt.carried_launches == bptt + 1
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def _train_step(model, batch, device):
    """One train-mode ``run_on_batch`` on ``device`` (dropout off): the
    losses and every gradient, on the host."""

    model = model.to(device)
    model.zero_grad()
    output = models_run_on_batch(model, {k: v.to(device)
                                         for k, v in batch.items()},
                                 train=True)
    loss = output[tools.KEY_LOSS]
    loss[tools.KEY_LOSS_TOTAL].backward()
    return ({k: v.item() for k, v in loss.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()})


def _held(card, cpu, names):
    """Each gradient of ``names`` within 1e-3 of the largest of its module
    (conv blocks ahead of a ReLU or max-pool decision that the two devices
    take differently are left out: chip_smoke.py phase 12b counts those)."""

    for name in names:
        module = name.rsplit('.', 1)[0]
        scale = max(g.abs().max().item() for k, g in cpu.items()
                    if k.rsplit('.', 1)[0] == module)
        assert (card[name] - cpu[name]).abs().max().item() <= 1e-3 * scale, \
            name


def test_velocity_train_step_on_the_card_matches_the_cpu(cuda):
    """A narrow O&F2 with the velocity head: one float32 train step on the
    card (kernels E and F eight times) against the CPU: losses within 1e-4
    relative, the velocity BiLSTM's and head's gradients within 1e-3 of
    their module's largest."""

    g = torch.Generator().manual_seed(8)
    model = OnsetsFrames2(dim_in=32, profile=tools.PianoProfile(),
                          model_complexity=2, estimate_velocity=True,
                          dropout=False, generator=g)
    multi_pitch = (torch.rand(2, 88, 40, generator=g) < 0.1).float()
    batch = {tools.KEY_FEATS: torch.rand(2, 1, 32, 40, generator=g),
             tools.KEY_MULTIPITCH: multi_pitch,
             tools.KEY_VELOCITY: multi_pitch * torch.rand(2, 88, 40,
                                                          generator=g)}

    cpu_loss, cpu_grads = _train_step(copy.deepcopy(model), batch, 'cpu')
    counts = (lstm_scan_residuals.launches, lstm_bptt.launches)
    card_loss, card_grads = _train_step(model, batch, cuda)
    torch.cuda.synchronize()
    assert (lstm_scan_residuals.launches, lstm_bptt.launches) == tuple(
        c + 8 for c in counts)

    assert tools.KEY_LOSS_VELOCITY in card_loss
    for key, value in cpu_loss.items():
        assert abs(card_loss[key] - value) <= 1e-4 * abs(value), key
    _held(card_grads, cpu_grads, [n for n in cpu_grads
                                  if n.startswith(('velocity_lm',
                                                   'velocity_out'))])


def test_tabcnn_train_step_on_the_card_matches_the_cpu(cuda):
    """Windowed TabCNN: one float32 train step on the card against the CPU:
    the loss within 1e-4 relative, the dense layers' gradients within 1e-3
    of their module's largest."""

    g = torch.Generator().manual_seed(9)
    model = TabCNN(dim_in=48, profile=tools.GuitarProfile(), dropout=False,
                   generator=g)
    batch = {tools.KEY_FEATS: torch.rand(2, 1, 48, 30, generator=g),
             tools.KEY_TABLATURE: torch.randint(-1, 20, (2, 6, 30),
                                                generator=g)}

    cpu_loss, cpu_grads = _train_step(copy.deepcopy(model), batch, 'cpu')
    card_loss, card_grads = _train_step(model, batch, cuda)
    for key, value in cpu_loss.items():
        assert abs(card_loss[key] - value) <= 1e-4 * abs(value), key
    _held(card_grads, cpu_grads, [n for n in cpu_grads
                                  if n.startswith(('dense1',
                                                   'tablature_out'))])


def test_loader_threads_compute_features_on_the_card(cuda, tmp_path):
    """``DataLoader(num_workers=4)`` over a dataset whose features the
    worker threads compute on the card (kernel A) into the npz cache, with
    kernel A's library unloaded first, so the threads are the first to
    reach it: A exactly once a track with the cache cold, never with it
    warm, the warm features the cold ones bit for bit, and a track's
    features within the mel tolerance of the CPU's."""

    from amt_tools_tpu_torch.datasets import DataLoader, SyntheticPiano

    mel = MelSpec(n_mels=64, htk=True)

    def run():
        dataset = SyntheticPiano(num_tracks=16, track_duration=3.0,
                                 num_frames=32, data_proc=mel,
                                 store_data=False, save_data=True,
                                 save_loc=str(tmp_path))
        feats = {}
        calculate = dataset.calculate_feats

        def record(data):
            out = calculate(data)
            feats[out[tools.KEY_TRACK]] = out[tools.KEY_FEATS]
            return out

        dataset.calculate_feats = record
        launches = stft_power.launches
        batches = list(DataLoader(dataset, batch_size=4, num_workers=4,
                                  seed=0))
        torch.cuda.synchronize()
        assert len(batches) == 4
        return dataset, feats, stft_power.launches - launches

    cuda_build._loaded.pop('stft_power', None)
    dataset, cold, launches = run()
    assert launches == len(cold) == 16
    assert len(list((tmp_path / 'SyntheticPiano' / 'MelSpec').iterdir())) == 16
    _, warm, launches = run()
    assert launches == 0 and sorted(warm) == sorted(cold)
    for track, feats in warm.items():
        assert feats.dtype == cold[track].dtype
        np.testing.assert_array_equal(feats, cold[track])

    audio = dataset.load(dataset.tracks[3])[tools.KEY_AUDIO]
    want = mel.process_audio(audio, device='cpu')
    assert np.abs(cold[dataset.tracks[3]] - want).max() <= 4e-4


def test_hcqt_on_the_card_matches_the_cpu(cuda):
    """One kernel C launch a harmonic, on the float32 FFMA route; the
    [0, 1] features within 2e-4 of the CPU's."""

    from amt_tools_tpu_torch.features import HCQT

    hcqt = HCQT(n_bins=48, harmonics=[0.5, 1, 2, 3])
    audio = _audio(2, 3 * 22050, seed=4)
    launches, ffma = cqt_mag.launches, cqt_mag.ffma_launches
    with torch.inference_mode():
        got = hcqt.process(audio.to(cuda))
        torch.cuda.synchronize()
        want = hcqt.process(audio)
    assert cqt_mag.launches == launches + 4
    assert cqt_mag.ffma_launches == ffma + 4
    assert got.shape == want.shape == (2, 4, 48, 1 + audio.shape[-1] // 512)
    assert (got.cpu() - want).abs().max().item() <= 2e-4


def test_audio_file_stream_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A 22.05 kHz WAV streamed at 16 kHz: kernel A once a frame, each
    frame within the mel tolerance of the CPU stream's."""

    from amt_tools_tpu_torch.features import AudioFileStream

    path = str(tmp_path / 'clip.wav')
    tools.write_wav(path, _audio(1, 22050, seed=5)[0].numpy(), 22050)
    streams = [AudioFileStream(MelSpec(n_mels=229), audio_path=path,
                               feature_device=device)
               for device in (None, 'cpu')]
    for stream in streams:
        stream.start_streaming()
    launches = stft_power.launches
    frames = 0
    while not streams[0].query_finished():
        got, want = (s.extract_frame_features() for s in streams)
        assert got.shape == want.shape == (1, 229, 1)
        assert np.abs(got - want).max() <= 4e-4
        frames += 1
    assert streams[1].query_finished()
    assert frames == 1 + len(streams[0].audio) // 512
    assert stft_power.launches == launches + frames


# Grouped launches (the fused_lms layout): G sequences with their own W_h in
# one launch of B, E or F, the groups from reverse_from on reversed. The
# velocity model's six directions at the training batch, the O&F2 four at a
# ragged T, a small ragged batch, and a streamed W_h slice (H = 512)
GROUPED_SHAPES = [(4, 8, 625, 256), (6, 8, 37, 256), (4, 5, 37, 64),
                  (2, 3, 300, 512)]


def _grouped_inputs(groups, batch, frames, hidden, dtype, device, seed=5):
    g = torch.Generator().manual_seed(seed + groups * hidden)
    xw = torch.randn(groups, batch, frames, 4 * hidden, generator=g) * 0.5
    w_h = torch.stack([torch.nn.init.orthogonal_(
        torch.empty(hidden, 4 * hidden), generator=g) for _ in range(groups)])
    dout = torch.randn(groups, batch, frames, hidden, generator=g)
    return xw.to(device, dtype), w_h.to(device, dtype), dout.to(device, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', GROUPED_SHAPES)
def test_grouped_lstm_kernels_equal_per_stream_launches(cuda, dtype, shape):
    """Grouped B, E and F, one launch each, bit for bit the per-stream
    launches of the ungrouped ops."""

    groups = shape[0]
    split = groups // 2
    xw, w_h, dout = _grouped_inputs(*shape, dtype, cuda)
    w_h_t = w_h.transpose(1, 2).contiguous()

    counts = (lstm_scan_grouped.launches,
              lstm_scan_residuals_grouped.launches,
              lstm_bptt_grouped.launches)
    out = lstm_scan_grouped(xw, w_h, split)
    res = lstm_scan_residuals_grouped(xw, w_h, split)
    da = lstm_bptt_grouped(res[1], res[2], dout, w_h_t, split)
    torch.cuda.synchronize()
    assert (lstm_scan_grouped.launches, lstm_scan_residuals_grouped.launches,
            lstm_bptt_grouped.launches) == tuple(c + 1 for c in counts)

    assert torch.equal(res[0], out)
    for g in range(groups):
        reverse = g >= split
        assert torch.equal(out[g], lstm_scan(xw[g], w_h[g], reverse)), g
        alone = lstm_scan_residuals(xw[g], w_h[g], reverse)
        for got, want in zip(res, alone):
            assert torch.equal(got[g], want), g
        assert torch.equal(da[g], lstm_bptt(alone[1], alone[2], dout[g],
                                            w_h_t[g], reverse)), g


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_grouped_lstm_kernels_match_plain(cuda, dtype):
    xw, w_h, dout = _grouped_inputs(4, 3, 37, 64, dtype, cuda)
    w_h_t = w_h.transpose(1, 2).contiguous()

    atol, mean_atol = {torch.float32: (1e-4, 1e-5),
                       torch.bfloat16: (1e-2, 8e-5)}[dtype]
    diff = (lstm_scan_grouped(xw, w_h, 2).float() -
            lstm_scan_grouped_plain(xw, w_h, 2).float()).abs()
    assert diff.max().item() <= atol and diff.mean().item() <= mean_atol

    got = lstm_scan_residuals_grouped(xw, w_h, 2)
    ref = lstm_scan_residuals_grouped_plain(xw, w_h, 2)
    rel, mean_atol = RESIDUAL_TOL[dtype]
    for a, b in zip(got[1:], ref[1:]):
        diff = (a - b).abs()
        assert diff.max().item() <= rel * b.abs().max().item()
        assert diff.mean().item() <= mean_atol

    # On residuals both versions share
    da = lstm_bptt_grouped(ref[1], ref[2], dout, w_h_t, 2)
    want = lstm_bptt_grouped_plain(ref[1], ref[2], dout, w_h_t, 2)
    rel, mean_rel = BPTT_TOL[dtype]
    diff = (da - want).abs()
    assert diff.max().item() <= rel * want.abs().max().item()
    assert diff.mean().item() <= mean_rel * want.abs().mean().item()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_masked_grouped_lstm_equals_per_stream(cuda, dtype):
    """Grouped B with the lengths every group shares, bit for bit the
    per-stream masked launches; counted as masked."""

    xw, w_h, _ = _grouped_inputs(4, 6, 300, 256, dtype, cuda)
    lengths = torch.tensor([0, 1, 300, 17, 250, 299], device=cuda)

    masked = lstm_scan_grouped.masked_launches
    got = lstm_scan_grouped(xw, w_h, 2, lengths)
    torch.cuda.synchronize()
    assert lstm_scan_grouped.masked_launches == masked + 1
    for g in range(4):
        assert torch.equal(got[g], lstm_scan(xw[g], w_h[g], g >= 2,
                                             lengths=lengths)), g


def test_grouped_lstm_grad_equals_per_stream(cuda):
    """The grouped Function (grouped E forward, grouped F backward) against
    the per-stream Function: outputs and d(xw) bit for bit, dW_h within
    1e-5 of its largest value."""

    xw, w_h, dout = _grouped_inputs(4, 3, 37, 64, torch.float32, cuda)
    xw.requires_grad_()
    w_h.requires_grad_()
    out = lstm_scan_grouped_grad(xw, w_h, 2)
    out.backward(dout)
    got = out.detach(), xw.grad.clone(), w_h.grad.clone()

    xw.grad = w_h.grad = None
    ref = torch.stack([lstm_scan_grad(xw[g], w_h[g], g >= 2)
                       for g in range(4)])
    ref.backward(dout)
    assert torch.equal(got[0], ref.detach())
    assert torch.equal(got[1], xw.grad)
    assert ((got[2] - w_h.grad).abs().max().item() <=
            1e-5 * w_h.grad.abs().max().item())


@pytest.mark.parametrize('hidden', [24, 256])
def test_grouped_bilstm_on_the_card_matches_the_cpu(cuda, hidden):
    """The layer at a width the kernels take and at one they run zero-
    padded: one grouped B in eval, one grouped E and one grouped F in a
    backward; card against CPU within 1e-4 (outputs) and 1e-4 of the
    largest value (gradients)."""

    g = torch.Generator().manual_seed(hidden)
    layer = GroupedBiLSTM(40, hidden, streams=3, generator=g)
    on_card = copy.deepcopy(layer).to(cuda)
    x = torch.randn(3, 4, 37, 40, generator=g)

    launches = lstm_scan_grouped.launches
    with torch.no_grad():
        got = on_card(x.to(cuda))
    assert lstm_scan_grouped.launches == launches + 1
    torch.testing.assert_close(got.cpu(), layer(x).detach(), rtol=0,
                               atol=1e-4)

    counts = (lstm_scan_residuals_grouped.launches,
              lstm_bptt_grouped.launches)
    on_card(x.to(cuda)).square().sum().backward()
    layer(x).square().sum().backward()
    assert (lstm_scan_residuals_grouped.launches,
            lstm_bptt_grouped.launches) == tuple(c + 1 for c in counts)
    for name, param in on_card.named_parameters():
        ref = dict(layer.named_parameters())[name].grad
        assert ((param.grad.cpu() - ref).abs().max().item() <=
                1e-4 * ref.abs().max().item()), name


def test_grouped_launch_plans_on_the_card(cuda):
    """The grouped plans the fused models launch, from the card's own count
    of clusters: one wave where rows allow it."""

    for kernel_plan in (scan_launch_plan, bptt_launch_plan):
        for groups, batch in ((4, 8), (6, 8), (4, 128)):
            plan = kernel_plan(batch, 256, torch.float32, cuda, groups=groups)
            kernel = 'scan' if kernel_plan is scan_launch_plan else 'bptt'
            assert plan == cluster_plan(batch, 256, torch.float32,
                                        plan['active_clusters'], kernel,
                                        groups)
            if groups * -(-batch // plan['max_rows']) <= plan['active_clusters']:
                assert plan['waves'] == 1


# Kernels E and F with per-row lengths and a carry (masked and carried
# training): lengths 0, 1, T and between in one batch; the carry a seeded
# random (c0, h0) and final-carry gradient
MASKED_TRAIN_SHAPES = [(3, 37, 64), (8, 625, 256)]


def _train_lengths(batch, frames, device, seed):
    """Lengths 0, 1 and T, then random ones; a lone row between 1 and T."""

    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, frames + 1, (batch,), generator=g)
    if batch >= 3:
        lengths[:3] = torch.tensor([0, 1, frames])
    return lengths.to(device)


def _train_carry(batch, hidden, device, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn(batch, hidden, generator=g) * 0.5).to(device)
                 for _ in range(4))


# The initial carry's gradient in bf16 against the plain version: a sum
# over 4H of da rounded to bf16, where an occasional da the two versions
# compounded apart rounds the other way (one bf16 ulp): 5e-4 of the largest
# value, and 5e-4 of the mean magnitude on the mean (read at H = 512 and
# 1024: 1.9e-4). Against the kernel's own last da it is one product, held
# to 1e-5 of its largest value.
CARRY_GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (5e-4, 5e-4)}


def _first_step_dh(da, w_h_t, reverse, lengths):
    """dh0 from a BPTT's own da: round(da) @ W_h^T at each row's first
    valid forward step (t = 0, or t = lengths - 1 reversed), 0 for a row of
    length 0."""

    batch, frames = da.shape[:2]
    lengths = (torch.full((batch,), frames, device=da.device)
               if lengths is None else lengths.long())
    first = lengths - 1 if reverse else torch.zeros_like(lengths)
    step = da[torch.arange(batch, device=da.device), first.clamp(min=0)]
    dh0 = step.to(w_h_t.dtype).float() @ w_h_t.float()
    return torch.where((lengths > 0)[:, None], dh0, 0.0)


def _held_to(got, ref, rel, mean_rel):
    diff = (got.float() - ref.float()).abs()
    assert diff.max().item() <= rel * ref.abs().max().item(), (
        diff.max().item(), ref.abs().max().item())
    assert diff.mean().item() <= mean_rel * max(ref.abs().mean().item(),
                                                1e-30)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('shape', MASKED_TRAIN_SHAPES)
@pytest.mark.parametrize('masked,carried', [(True, False), (False, True),
                                            (True, True)])
def test_masked_carried_e_and_f_match_plain(cuda, dtype, reverse, shape,
                                            masked, carried):
    """Masked and carried E against its plain version (out as B, gates and
    c_seq as E, the final carry as carried B), its h bit for bit the masked
    or carried B's; F on the residuals both share against its plain
    version (da, dW_h = h_prev^T da, and the initial carry's gradient as
    da), each launch counted on its route."""

    batch, frames, hidden = shape
    xw, w_h, dout = _lstm_inputs(*shape, dtype, cuda)
    lengths = _train_lengths(batch, frames, cuda, 7) if masked else None
    c0, h0, dc, dh = _train_carry(batch, hidden, cuda, 8)
    carry = (c0, h0) if carried else None

    counts = {w: (w.launches, w.masked_launches, w.carried_launches)
              for w in (lstm_scan_residuals, lstm_bptt)}
    got = lstm_scan_residuals(xw, w_h, reverse, lengths, carry,
                              return_carry=carried)
    ref = lstm_scan_residuals_plain(xw, w_h, reverse, lengths, carry,
                                    return_carry=carried)
    scan = lstm_scan(xw, w_h, reverse, lengths, carry, return_carry=carried)
    torch.cuda.synchronize()
    assert torch.equal(got[0], scan[0] if carried else scan)

    atol, mean_atol = {torch.float32: (1e-4, 1e-5),
                       torch.bfloat16: (1e-2, 8e-5)}[dtype]
    diff = (got[0].float() - ref[0].float()).abs()
    assert diff.max().item() <= atol and diff.mean().item() <= mean_atol
    rel, mean_tol = RESIDUAL_TOL[dtype]
    for a, b in zip(got[1:3], ref[1:3]):
        diff = (a - b).abs()
        assert diff.max().item() <= rel * b.abs().max().item()
        assert diff.mean().item() <= mean_tol
    if carried:
        assert torch.equal(got[3][0], scan[1][0])
        assert torch.equal(got[3][1], scan[1][1])
        for a, b in zip(got[3], ref[3]):
            assert (a - b).abs().max().item() <= atol * max(
                1.0, b.abs().max().item())
    if masked:
        for row, length in enumerate(lengths.tolist()):
            assert torch.count_nonzero(got[0][row, length:]) == 0

    gates, c_seq = ref[1], ref[2]
    w_h_t = w_h.t().contiguous()
    bptt_carry = (c0, dc, dh) if carried else None
    da = lstm_bptt(gates, c_seq, dout, w_h_t, reverse, lengths, bptt_carry)
    want = lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse, lengths,
                           bptt_carry)
    torch.cuda.synchronize()
    for wrapper in (lstm_scan_residuals, lstm_bptt):
        launches, masked_n, carried_n = counts[wrapper]
        assert wrapper.launches == launches + 1
        assert wrapper.masked_launches == masked_n + masked
        assert wrapper.carried_launches == carried_n + carried

    if carried:
        (da, dc0, dh0), (want, want_dc0, want_dh0) = da, want
    max_rel, mean_rel = BPTT_TOL[dtype]
    h_prev = lstm_kernel._h_prev(ref[0], reverse, lengths,
                                 h0 if carried else None)
    for a, b in ((da, want), (lstm_kernel._dw_h(h_prev, da),
                              lstm_kernel._dw_h(h_prev, want))):
        _held_to(a, b, max_rel, mean_rel)
    if masked:
        mask = torch.arange(frames, device=cuda)[None] < lengths[:, None]
        assert torch.count_nonzero(da[~mask]) == 0
    if carried:
        _held_to(dc0, want_dc0, *CARRY_GRAD_TOL[dtype])
        _held_to(dh0, want_dh0, *CARRY_GRAD_TOL[dtype])
        own = _first_step_dh(da, w_h_t, reverse, lengths)
        live = (lengths > 0) if masked else slice(None)
        assert ((dh0 - own)[live].abs().max().item() <=
                1e-5 * own.abs().max().item())
        if masked:  # a row of length 0 passes the final carry's gradient
            assert torch.equal(dc0[0], dc[0]) and torch.equal(dh0[0], dh[0])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
@pytest.mark.parametrize('shape', [(s[0], 37, s[2]) for s in CLUSTER_SHAPES
                                   if s[1] == 37])
def test_masked_carried_f_at_cluster_shapes(cuda, dtype, reverse, shape):
    """Masked and carried F at kernel F's cluster shapes: one row to past a
    wave, the W_h^T slice resident and streamed, padded units; against its
    plain version, da as F and the initial carry's gradient by
    ``CARRY_GRAD_TOL``, and dh0 against the product of its own last da."""

    batch, frames, hidden = shape
    xw, w_h, dout = _lstm_inputs(batch, frames, hidden, dtype, cuda,
                                 seed=batch * 5 + hidden)
    lengths = _train_lengths(batch, frames, cuda, batch + hidden)
    c0, h0, dc, dh = _train_carry(batch, hidden, cuda, hidden)
    out, gates, c_seq, _ = lstm_scan_residuals_plain(
        xw, w_h, reverse, lengths, (c0, h0), return_carry=True)
    w_h_t = w_h.t().contiguous()

    got = lstm_bptt(gates, c_seq, dout, w_h_t, reverse, lengths, (c0, dc, dh))
    want = lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse, lengths,
                           (c0, dc, dh))
    _held_to(got[0], want[0], *BPTT_TOL[dtype])
    for a, b in zip(got[1:], want[1:]):
        _held_to(a, b, *CARRY_GRAD_TOL[dtype])
    own = _first_step_dh(got[0], w_h_t, reverse, lengths)
    live = lengths > 0
    assert ((got[2] - own)[live].abs().max().item() <=
            1e-5 * own.abs().max().item())
    max_rel, mean_rel = BPTT_TOL[dtype]
    masked = lstm_bptt(gates, c_seq, dout, w_h_t, reverse, lengths)
    _held_to(masked, lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse,
                                     lengths), max_rel, mean_rel)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_full_lengths_and_zero_carry_equal_the_plain_launches(cuda, dtype,
                                                              reverse):
    """Lengths = T give the unmasked E and F bit for bit, and so does a
    zero carry with a zero final-carry gradient (da; its extra product
    changes no da)."""

    xw, w_h, dout = _lstm_inputs(8, 625, 256, dtype, cuda)
    full = torch.full((8,), 625, dtype=torch.int32, device=cuda)
    zeros = torch.zeros(8, 256, device=cuda)
    plain = lstm_scan_residuals(xw, w_h, reverse)
    for got in (lstm_scan_residuals(xw, w_h, reverse, full),
                lstm_scan_residuals(xw, w_h, reverse, None, (zeros, zeros)),
                lstm_scan_residuals(xw, w_h, reverse, full, (zeros, zeros))):
        assert all(torch.equal(a, b) for a, b in zip(got, plain))

    gates, c_seq = plain[1], plain[2]
    w_h_t = w_h.t().contiguous()
    da = lstm_bptt(gates, c_seq, dout, w_h_t, reverse)
    assert torch.equal(lstm_bptt(gates, c_seq, dout, w_h_t, reverse, full), da)
    for lengths in (None, full):
        got, dc0, dh0 = lstm_bptt(gates, c_seq, dout, w_h_t, reverse,
                                  lengths, (zeros, zeros, zeros))
        assert torch.equal(got, da)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('reverse', [False, True])
def test_carried_grad_in_chunks_equals_one_call(cuda, dtype, reverse):
    """The carried Function over chunks of 125 frames that thread the carry
    against one call from the same carry: outputs bit for bit, d(xw) within
    1e-6 (float32) of its largest value, dW_h and the carry's gradients
    within 1e-5; in bf16 the held tolerance of F."""

    xw, w_h, dout = _lstm_inputs(8, 625, 256, dtype, cuda)
    c0, h0, _, _ = _train_carry(8, 256, cuda, 9)

    def grads(chunk):
        x = xw.detach().clone().requires_grad_()
        w = w_h.detach().float().clone().requires_grad_()
        carry = (c0.clone().requires_grad_(), h0.clone().requires_grad_())
        state, pieces = carry, {}
        starts = list(range(0, 625, chunk))
        for start in (reversed(starts) if reverse else starts):
            pieces[start], state = lstm_scan_grad(
                x[:, start:start + chunk], w, reverse, initial_carry=state,
                return_carry=True)
        out = torch.cat([pieces[s] for s in starts], dim=1)
        (out.float() * dout.float()).sum().backward()
        return out.detach(), [x.grad, w.grad, carry[0].grad, carry[1].grad]

    whole, want = grads(625)
    chunked, got = grads(125)
    assert torch.equal(chunked, whole)
    tol = 1e-6 if dtype == torch.float32 else 5e-4
    for i, (a, b) in enumerate(zip(got, want)):
        limit = (tol if i == 0 else max(tol, 1e-5)) * b.abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= limit, i


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_masked_grouped_e_and_f_equal_per_stream(cuda, dtype):
    """Grouped E and F with the lengths every group shares, bit for bit the
    per-stream masked launches; counted as masked."""

    xw, w_h, dout = _grouped_inputs(4, 8, 300, 256, dtype, cuda)
    w_h_t = w_h.transpose(1, 2).contiguous()
    lengths = torch.tensor([0, 1, 300, 17, 250, 299, 150, 300], device=cuda)

    counts = (lstm_scan_residuals_grouped.masked_launches,
              lstm_bptt_grouped.masked_launches)
    res = lstm_scan_residuals_grouped(xw, w_h, 2, lengths)
    da = lstm_bptt_grouped(res[1], res[2], dout, w_h_t, 2, lengths)
    torch.cuda.synchronize()
    assert (lstm_scan_residuals_grouped.masked_launches,
            lstm_bptt_grouped.masked_launches) == tuple(c + 1 for c in counts)
    for g in range(4):
        reverse = g >= 2
        alone = lstm_scan_residuals(xw[g], w_h[g], reverse, lengths)
        for got, want in zip(res, alone):
            assert torch.equal(got[g], want), g
        assert torch.equal(da[g], lstm_bptt(alone[1], alone[2], dout[g],
                                            w_h_t[g], reverse, lengths)), g

    want = lstm_bptt_grouped_plain(res[1], res[2], dout, w_h_t, 2, lengths)
    _held_to(da, want, *BPTT_TOL[dtype])


@pytest.mark.parametrize('hidden', [24, 256])
def test_masked_bilstm_training_on_the_card_matches_the_cpu(cuda, hidden):
    """FastBiLSTM and GroupedBiLSTM with lengths under autograd: masked E
    and F on the card (grouped for the grouped layer) against the CPU's
    plain versions, outputs within 1e-4 and gradients within 1e-4 of their
    largest value."""

    g = torch.Generator().manual_seed(hidden + 1)
    layers = (LanguageModel(40, 2 * hidden, generator=g),
              GroupedBiLSTM(40, hidden, streams=2, generator=g))
    lengths = torch.tensor([37, 0, 12, 36])
    for layer, shape in zip(layers, ((4, 37, 40), (2, 4, 37, 40))):
        x = torch.randn(*shape, generator=g)
        on_card = copy.deepcopy(layer).to(cuda)
        grouped = isinstance(layer, GroupedBiLSTM)
        wrappers = ((lstm_scan_residuals_grouped, lstm_bptt_grouped)
                    if grouped else (lstm_scan_residuals, lstm_bptt))
        counts = [w.masked_launches for w in wrappers]
        got = on_card(x.to(cuda), lengths.to(cuda))
        got.square().sum().backward()
        want = layer(x, lengths)
        want.square().sum().backward()
        assert [w.masked_launches for w in wrappers] == [
            c + (1 if grouped else 2) for c in counts]
        torch.testing.assert_close(got.detach().cpu(), want.detach(),
                                   rtol=0, atol=1e-4)
        for name, param in on_card.named_parameters():
            ref = dict(layer.named_parameters())[name].grad
            assert ((param.grad.cpu() - ref).abs().max().item() <=
                    1e-4 * ref.abs().max().item()), name
