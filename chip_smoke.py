"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve, train.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build every hand-written kernel from ``amt_tools_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), printing ``ptxas -v`` for
   each (registers, shared memory, spills);
3. the STFT power kernel (A) against its plain version at the serving shape
   (128 clips x 60 s at 16 kHz), on power and on the [0, 1] mel features,
   timed beside the plain version and ``torch.stft`` (cuFFT); the shape
   must take the FFT route, whose frames a block and shared memory it
   prints;
4. the LSTM kernel (B) against its plain version at B = 128, T = 1876,
   H = 256, both directions, float32 and bf16, timed beside the plain
   version and cuDNN ``torch.nn.LSTM`` (bf16, and float16 with flat
   weights); it prints the cluster launch (clusters, rows a cluster, the
   card's count of resident clusters, a resident or streamed W_h slice,
   shared memory) and a step's time beside launches with one row a cluster
   and with H = 64;
5. the piano serving path: Onsets & Frames v2 at complexity 3 (full
   width) in bf16 with seeded random weights, activity calibration on 4
   clips, then 3 requests of 128 x 60 s clips with overlapped
   dispatch/finalize. Every kernel's launch count is reset just before the
   requests and read just after; kernels A (on its FFT route) and B must
   have run. 5b: a
   narrow float32 copy checks notes and logits on the card against the CPU
   (plain versions);
6. the full-bank CQT kernel (C) against its plain version of the same
   ``exact`` at the serving shape, 64 guitar clips of 60 s at 22.05 kHz
   (192 bins at 24 per octave from C1, support 24,576): 'high' (the bf16x3
   split on the tensor cores) at that shape, and within the JAX
   package's bound of the float32 plain version; False (one bf16 pass) and
   True (float32 FMAs) on the first 5 s of each clip, and True at the full
   shape as [0, 1] features against the float32 plain version; each
   route's launches counted; then 'high' timed at that shape beside the plain version and
   cuDNN ``conv1d`` over the same bank;
7. the support-grouped CQT kernel (D) the same way, and against kernel C
   on the full bank;
8. the guitar serving path: TabCNN (fullseq, paper width) in bf16 with
   seeded random weights behind the serving CQT (exact='high',
   grouped='auto'), tablature activity calibration on 4 clips, then 3
   requests of 64 x 60 s with overlapped dispatch/finalize, counts reset
   before and read after: kernel D must have run on its bf16x3 route. One
   more request goes through the full-bank CQT (grouped=False), counts
   reset before and read after: kernel C must have run on that route. 8b:
   a float32 TabCNN behind the serving CQT, card (kernel D, bf16x3)
   against the CPU (plain versions, float32), on the logits and the notes;
10. the LSTM forward with residuals (E) against its plain version at the
    training shape B = 8, T = 625, H = 256, both directions, float32 and
    bf16, its h bit for bit against kernel B's, with its cluster launch;
    timed beside kernel B, the plain version and a training-mode cuDNN
    ``nn.LSTM`` forward;
11. the BPTT kernel (F) against its plain version at the same shapes, on
    d(xw) and dW_h, and the float32 ``lstm_scan_grad`` against autograd
    through the plain recurrence; with its cluster launch (as phase 4),
    timed beside the plain version and cuDNN ``nn.LSTM``'s backward;
12. the training path: O&F2 at complexity 3 through ``train()`` on 16
    SyntheticPiano tracks of 30 s cropped to 625 frames (HTK mels on the
    card, kernel A), batch 8, Adam 6e-4, 3 passes in float32 and 3 in bf16,
    each with a checkpoint; then 30 float32 steps on one batch, whose loss
    must fall. Counts are reset before each run and read after it: E and F
    six times a step, B never; every loss finite. 12b: one float32
    training step of a narrow O&F2 on each of three seeds, card (kernels)
    against the CPU (plain versions), on the losses, the gradients and the
    parameters after one SGD step, with the ReLU and max-pool decisions
    that the two forwards took differently counted per acoustic stack;
9 and 13. one piano batch, one guitar batch and one float32 training step
   under ``torch.profiler``, in one session: the device time by kernel and
   the busy share of each, whose path's kernels must appear in it.

The last lines are the card, one ``kernels`` JSON line (A to F), and one
JSON line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SAMPLE_RATE = 16000
GUITAR_SAMPLE_RATE = 22050
GUITAR_BATCH = 64
GUITAR_CAPACITY = 512
HOP = 512
N_FFT = 2048
N_MELS = 229
CLIP_SECONDS = 60.0
BATCH = 128
REQUESTS = 3
HIDDEN = 256
CAPACITY = 2048

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

STFT_POWER_TOL = 1e-5    # of each clip's peak power: float32, sum order
MEL_FEATURE_TOL = 4e-4   # [0, 1] features (ops/pallas_stft.py:30)
# Absolute, on the outputs: max and mean (see tests/test_torch_cuda.py and
# tests/test_torch_lstm_kernel.py)
LSTM_TOL = {'float32': 1e-4, 'bfloat16': 1e-2}
LSTM_MEAN_TOL = {'float32': 1e-5, 'bfloat16': 8e-5}
LOGIT_TOL = 2e-3         # float32 logits, card vs CPU (PARITY.md bound)
CQT_TOL = 1e-5           # of each clip's peak magnitude: the same exact on
                         # both sides, sums in another order
CQT_FEATURE_TOL = 2e-4   # [0, 1] features (amt_tools_tpu/features/cqt.py:29)
# 'high' (bf16x3) against float32, of each clip's peak magnitude: the JAX
# package's bound for its split (tests/test_pallas_cqt.py:119)
CQT_HIGH_TOL = 2e-4
TAB_MARGIN = 2 * LOGIT_TOL  # tablature may differ where the top two are closer
TRAIN_BATCH = 8          # the O&F2 recipe (examples/papers/of_2.py)
TRAIN_FRAMES = 625
# Kernel E's gates and c against the plain version: max over the largest
# value, and mean absolute (a bf16 gate that rounds the other way moves by
# one ulp, 2^-8 relative, and the carry keeps it for a few steps)
RESIDUAL_TOL = {'float32': 1e-4, 'bfloat16': 2e-2}
RESIDUAL_MEAN_TOL = {'float32': 1e-5, 'bfloat16': 1e-4}
# Kernel F's da and dW_h against the plain version on the same residuals:
# the max over the largest value, and the mean over the mean magnitude. In
# bf16 the carry product reads da rounded to bf16, so a sum in another order
# moves an occasional element by one bf16 ulp; forming the product from
# unrounded da or a float32 W_h^T moves every element and exceeds the mean
# (tests/test_torch_lstm_grad.py::test_card_bptt_bf16_tolerance_catches_
# numerics_faults)
BPTT_TOL = {'float32': 1e-4, 'bfloat16': 5e-4}
BPTT_MEAN_TOL = {'float32': 1e-5, 'bfloat16': 1e-4}
TRAIN_PASSES = 3
FIT_STEPS = 30
LEARNING_RATE = 6e-4
# A float32 training step, card vs CPU (phase 12b, seeds 8 to 19).
# Gradients are held to the largest gradient of the same module (a conv
# bias ahead of a train-mode BatchNorm has a gradient of rounding noise):
# 1e-4. One thing can move a gradient further: a ReLU or 1x2 max-pool
# decision that the two forwards take differently, because its inputs
# differ by a rounding error. The whole gradient element then goes another
# way, into the conv blocks at and before that decision, so in a stack
# where such a decision differs those blocks are held to 3e-2. Read on the
# card (NVIDIA H100 80GB HBM3) over these seeds: the stacks whose decisions
# all agreed were within 4.2e-5 in every conv block; with one to three
# differing decisions a stack was off by up to 1.4e-2 (a single max-pool
# pair, onset stack, seed 8).
# After one SGD step a parameter may differ by the learning rate times its
# gradient's tolerance, plus its own rounding; a running statistic by 1e-6.
LOSS_TOL = 1e-5          # relative
GRAD_TOL = 1e-4
CONV_BLOCK_GRAD_TOL = 3e-2
TRAIN_CHECK_SEEDS = tuple(range(8, 20))
SGD_LR = 0.05
STAT_TOL = 1e-6
ROOT = os.path.dirname(os.path.abspath(__file__))


def require(condition, message):
    if not condition:
        raise RuntimeError(message)


def log(message):
    print(message, flush=True)


def time_ms(fn, reps, warmup=1):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()

    return start.elapsed_time(end) / reps


def bound_ms(num_bytes, flops, peak_flops):
    """Least time for the work: bytes over HBM rate vs ops over peak."""

    by_bytes = num_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / peak_flops * 1e3

    return max(by_bytes, by_ops), ('bytes' if by_bytes >= by_ops
                                   else 'operations')


def render_clips(profile, count, seconds, sample_rate=SAMPLE_RATE):
    """About 2 notes a second per clip (``bench.py:430-437``), from seed 0."""

    from amt_tools_tpu_torch.datasets import random_notes, render_notes

    rng = np.random.RandomState(0)
    clips = []
    for b in range(count):
        pitches, intervals = random_notes(profile, seconds, int(2 * seconds),
                                          rng)
        clips.append(render_notes(pitches, intervals, sample_rate, seconds,
                                  seed=b))

    return np.stack(clips)


def kernel_counters():
    """Every hand-written kernel's wrapper, by kernel name."""

    from amt_tools_tpu_torch.ops.cqt_kernel import cqt_mag, cqt_mag_grouped
    from amt_tools_tpu_torch.ops.lstm_kernel import (lstm_bptt, lstm_scan,
                                                     lstm_scan_residuals)
    from amt_tools_tpu_torch.ops.stft_kernel import stft_power

    return {'stft_power': stft_power, 'lstm_scan': lstm_scan,
            'cqt_mag': cqt_mag, 'cqt_mag_grouped': cqt_mag_grouped,
            'lstm_scan_residuals': lstm_scan_residuals,
            'lstm_bptt': lstm_bptt}


def route_counters():
    """(kernel, route, attribute) of every counter of a kernel's route:
    kernel A's FFT route, kernels C and D by ``exact``."""

    from amt_tools_tpu_torch.ops.cqt_kernel import ROUTES

    return ([('stft_power', 'fft', 'fft_launches')] +
            [(name, route, f'{route}_launches')
             for name in ('cqt_mag', 'cqt_mag_grouped') for route in ROUTES])


def reset_launches():
    counters = kernel_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    for name, _, attribute in route_counters():
        setattr(counters[name], attribute, 0)


def read_launches():
    """Launch counts by kernel, and by route as ``<kernel>_<route>``:
    ``stft_power_fft`` (kernel A's FFT route), ``cqt_mag_bf16x3`` and the
    other routes of kernels C and D."""

    counters = kernel_counters()
    launches = {name: wrapper.launches for name, wrapper in counters.items()}
    for name, route, attribute in route_counters():
        launches[f'{name}_{route}'] = getattr(counters[name], attribute)

    return launches


def check_stft(audio):
    """Phase 3: kernel A vs its plain version at the serving shape."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.ops import spectral
    from amt_tools_tpu_torch.ops.stft_kernel import (fft_geometry,
                                                     fft_tile_frames,
                                                     fft_twiddles, stft_power,
                                                     stft_power_plain,
                                                     stft_route)

    mel = MelSpec(n_mels=N_MELS)
    bank = mel._bank(audio.device)
    route = stft_route(N_FFT, HOP, bank.shape[1] // 2)
    tile = fft_tile_frames(N_FFT, HOP)
    smem = fft_geometry(N_FFT, HOP, tile)['bytes']
    design = (f'{route} route: radix-4 FFT of n_fft/2 complex points in '
              f'shared memory, {tile} frames a block of 512 threads, '
              f'{smem} bytes of shared memory')
    log(f'stft_power at n_fft {N_FFT}, hop {HOP}: {design}')
    require(route == 'fft', 'the serving STFT shape does not take the FFT '
                            'route')

    with tools.exact_fp32():
        fft = stft_power.fft_launches
        got = stft_power(audio, bank, N_FFT, HOP)
        ref = stft_power_plain(audio, bank, N_FFT, HOP)
        torch.cuda.synchronize()
        require(stft_power.fft_launches == fft + 1,
                'kernel A did not run its FFT route')

        peak = ref.amax(dim=(1, 2), keepdim=True)
        abs_err = (got - ref).abs().max().item()
        rel_err = ((got - ref).abs() / peak).max().item()

        fb = mel._filterbank(audio.device)
        feat_err = (mel.post_proc(torch.matmul(fb, got)) -
                    mel.post_proc(torch.matmul(fb, ref))).abs().max().item()

        # Both against a float64 FFT (cuFFT) of the same windowed frames,
        # on the first 4 clips: which of the two float32 sums is nearer
        few = audio[:4].double()
        frames_64 = (spectral.frame_signal(few, N_FFT, HOP) *
                     bank[:, 0].double())
        truth = torch.fft.rfft(frames_64, dim=-1).abs().pow(2).transpose(-1,
                                                                         -2)
        peak_64 = truth.amax(dim=(1, 2), keepdim=True)
        kernel_64 = ((got[:4].double() - truth).abs() / peak_64).max().item()
        plain_64 = ((ref[:4].double() - truth).abs() / peak_64).max().item()
        del ref, few, frames_64, truth

        window = torch.hann_window(N_FFT, periodic=True, device=audio.device)

        def library():
            spec = torch.stft(audio, N_FFT, HOP, window=window, center=True,
                              pad_mode='constant', return_complex=True)
            return spec.abs() ** 2

        lib_err = ((library() - got).abs() / peak).max().item()

        ms = time_ms(lambda: stft_power(audio, bank, N_FFT, HOP), reps=5)
        plain_ms = time_ms(lambda: stft_power_plain(audio, bank, N_FFT, HOP),
                           reps=3)
        library_ms = time_ms(library, reps=5)

    log(f'stft_power: max |kernel - plain| = {abs_err:.6g} '
        f'({rel_err:.3g} of the clip peak, tolerance {STFT_POWER_TOL}); '
        f'mel features {feat_err:.3g} (tolerance {MEL_FEATURE_TOL}); '
        f'torch.stft vs kernel {lib_err:.3g} of the clip peak; against a '
        f'float64 FFT of 4 clips: kernel {kernel_64:.3g}, plain '
        f'{plain_64:.3g} of the clip peak')
    require(rel_err <= STFT_POWER_TOL, 'stft_power disagrees with its plain version')
    require(feat_err <= MEL_FEATURE_TOL, 'stft_power mel features disagree')

    batch, num_samples = audio.shape
    frames, n_bins = got.shape[-1], got.shape[1]
    # The FFT route reads the audio, the window (the bank's bin-0 column)
    # and the twiddle table, and writes the power
    table_bytes = fft_twiddles(N_FFT).nbytes
    num_bytes = 4 * (audio.numel() + N_FFT + got.numel()) + table_bytes
    # The least work that gives STFT power is a real FFT of each windowed
    # frame (about 2.5 n log2 n operations), then re^2 + im^2
    fft_flops = batch * frames * (2.5 * N_FFT * np.log2(N_FFT) + N_FFT +
                                  3.0 * n_bins)
    bound, bound_by = bound_ms(num_bytes, fft_flops, PEAK_FP32_FLOPS)
    # What the DFT route (an implicit GEMM) cannot beat at this shape
    dft_flops = 2.0 * batch * frames * N_FFT * 2 * n_bins
    log(f'stft_power: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
        f'torch.stft {library_ms:.3f} ms, bound {bound:.3f} ms ({bound_by}: '
        f'{num_bytes / 1e9:.4f} GB of audio, window, {table_bytes} bytes of '
        f'twiddles and power on the {route} route; FFT work) at '
        f'({batch}, {num_samples}) -> {tuple(got.shape)}; '
        f'a DFT-matmul does {dft_flops / 1e12:.3f} TFLOP: at least '
        f'{dft_flops / PEAK_FP32_FLOPS * 1e3:.3f} ms in float32, '
        f'{3 * dft_flops / PEAK_BF16_FLOPS * 1e3:.3f} ms as 3 bf16 passes')

    return {'name': 'stft_power', 'route': 'cuda',
            'source': 'amt_tools_tpu_torch/csrc/stft_power.cu',
            'replaces': 'amt_tools_tpu/ops/pallas_stft.py:119',
            'max_abs_err': abs_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms, 'design': design,
            'geometry': {'path': route, 'tile_frames': tile,
                         'smem_bytes': smem}}


def lstm_bf16_fault(xw, w_h, fault):
    """The plain bf16 recurrence with one fault in its numerics: 'carry'
    rounds c and h to bf16 every step (the JAX XLA scan's numerics),
    'logistic' takes the logistic sigmoid for the Pallas kernel's tanh form."""

    import torch

    batch, frames, four_h = xw.shape
    hidden = four_h // 4
    if fault == 'logistic':
        sigmoid = torch.sigmoid
    else:
        def sigmoid(v):
            return 0.5 * torch.tanh(0.5 * v) + 0.5

    w = w_h.float()
    h = torch.zeros(batch, hidden, device=xw.device)
    c = torch.zeros_like(h)
    out = torch.empty(batch, frames, hidden, dtype=xw.dtype, device=xw.device)
    for t in range(frames):
        gates = (xw[:, t].float() + h.bfloat16().float() @ w).bfloat16()
        i_g, f_g, g_g, o_g = gates.split(hidden, dim=-1)
        c = sigmoid(f_g).float() * c + (sigmoid(i_g) * torch.tanh(g_g)).float()
        h = sigmoid(o_g).float() * torch.tanh(c)
        if fault == 'carry':
            c, h = c.bfloat16().float(), h.bfloat16().float()
        out[:, t] = h.bfloat16()

    return out


def lstm_design(batch, hidden, dtype, residuals=False, bptt=False):
    """The cluster launch of kernels B and E (F with ``bptt``) for a batch,
    as a line of text and a dict for the ``kernels`` line."""

    import torch

    from amt_tools_tpu_torch.ops.lstm_kernel import (bptt_launch_plan,
                                                     scan_launch_plan)

    device = torch.device('cuda')
    plan = (bptt_launch_plan(batch, hidden, dtype, device) if bptt else
            scan_launch_plan(batch, hidden, dtype, device, residuals))
    text = (f'{plan["clusters"]} clusters of 8 CTAs ({plan["ctas"]} CTAs), '
            f'{plan["rows"]} rows a cluster, the card holds '
            f'{plan["active_clusters"]} clusters at once '
            f'(cudaOccupancyMaxActiveClusters), {plan["waves"]} wave(s), '
            f'{"W_h^T" if bptt else "W_h"} slice '
            f'{"resident in" if plan["resident"] else "streamed through"}'
            f' shared memory, {plan["smem_bytes"]} bytes of shared memory and '
            f'{plan["threads"]} threads a CTA')

    return plan, text


def check_lstm_tolerance(xw, w_h, ref):
    """The bf16 tolerance must reject the numerics the port must not have."""

    for fault in ('carry', 'logistic'):
        diff = (lstm_bf16_fault(xw, w_h, fault).float() - ref.float()).abs()
        err, mean_err = diff.max().item(), diff.mean().item()
        log(f'lstm bf16 with the fault {fault!r}: |fault - plain| max '
            f'{err:.6g}, mean {mean_err:.6g}')
        require(err > LSTM_TOL['bfloat16'] or
                mean_err > LSTM_MEAN_TOL['bfloat16'],
                f'the bf16 LSTM tolerance does not catch the fault {fault!r}')


def check_lstm(frames):
    """Phase 4: kernel B vs its plain version at the serving shape."""

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan, lstm_scan_plain

    class OpNames(TorchDispatchMode):
        """The ATen operators a block calls (which RNN path ran)."""

        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(str(func))
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(1)
    dim_in = 768
    x = torch.rand(BATCH, frames, dim_in, generator=g)
    w_x = torch.randn(dim_in, 4 * HIDDEN, generator=g) / dim_in ** 0.5
    bias = torch.zeros(4 * HIDDEN)
    w_h = torch.nn.init.orthogonal_(torch.empty(HIDDEN, 4 * HIDDEN),
                                    generator=g)
    x, w_x, bias, w_h = (t.cuda() for t in (x, w_x, bias, w_h))

    def torch_lstm(dtype):
        """torch.nn.LSTM with the same weights (it also runs the input
        projection): its time and the ATen path it took."""

        module = torch.nn.LSTM(dim_in, HIDDEN, batch_first=True).cuda()
        with torch.no_grad():
            module.weight_ih_l0.copy_(w_x.t())
            module.weight_hh_l0.copy_(w_h.t())
            module.bias_ih_l0.copy_(bias)
            module.bias_hh_l0.zero_()
        module = module.to(dtype)
        module.flatten_parameters()
        xd = x.to(dtype)
        with torch.no_grad():
            library_ms = time_ms(lambda: module(xd), reps=5)
            with OpNames() as ops:
                module(xd)
        cudnn = any('_cudnn_rnn' in name for name in ops.names)

        return library_ms, 'cuDNN' if cudnn else 'ATen native, not cuDNN'

    result = {}
    with tools.exact_fp32():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            xw = (x.to(dtype) @ w_x.to(dtype) + bias.to(dtype)).contiguous()
            wh = w_h.to(dtype).contiguous()

            err = mean_err = 0.0
            for reverse in (False, True):
                got = lstm_scan(xw, wh, reverse=reverse)
                ref = lstm_scan_plain(xw, wh, reverse=reverse)
                diff = (got.float() - ref.float()).abs()
                err = max(err, diff.max().item())
                mean_err = max(mean_err, diff.mean().item())
            log(f'lstm_scan {name}: |kernel - plain| max {err:.6g} '
                f'(tolerance {LSTM_TOL[name]}), mean {mean_err:.6g} '
                f'(tolerance {LSTM_MEAN_TOL[name]}), worse direction')
            require(err <= LSTM_TOL[name] and
                    mean_err <= LSTM_MEAN_TOL[name],
                    f'lstm_scan {name} disagrees with its plain version')
            if dtype == torch.bfloat16:
                check_lstm_tolerance(xw, wh, ref=lstm_scan_plain(xw, wh))

            plan, design = lstm_design(BATCH, HIDDEN, dtype)
            log(f'lstm_scan {name} at B={BATCH}, H={HIDDEN}: {design}')
            require(plan['resident'] and plan['waves'] == 1,
                    'the serving LSTM is not one wave with W_h on chip')
            ms = time_ms(lambda: lstm_scan(xw, wh), reps=5)
            plain_ms = time_ms(lambda: lstm_scan_plain(xw, wh), reps=1)
            library_ms, backend = torch_lstm(dtype)
            log(f'torch.nn.LSTM {name} ran on {backend}')
            if dtype == torch.bfloat16:
                # flatten_parameters() leaves bf16 weights apart (cuDNN's
                # is_acceptable rejects bf16), so each bf16 call compacts
                # them first; float16 times cuDNN with flat weights in the
                # same two bytes a value
                half_ms, half_backend = torch_lstm(torch.float16)
                log(f'torch.nn.LSTM float16 ran on {half_backend}: '
                    f'{half_ms:.3f} ms (with its input projection)')
                step_anatomy(xw, wh, ms, frames)

            size = torch.finfo(dtype).bits // 8
            num_bytes = size * (xw.numel() + wh.numel() +
                                BATCH * frames * HIDDEN)
            flops = 2.0 * BATCH * frames * HIDDEN * 4 * HIDDEN
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
            bound, bound_by = bound_ms(num_bytes, flops, peak)
            log(f'lstm_scan {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} '
                f'ms, torch.nn.LSTM {library_ms:.3f} ms ({backend}, with its '
                f'input projection), bound '
                f'{bound:.3f} ms ({bound_by}) per direction at B={BATCH}, '
                f'T={frames}, H={HIDDEN}')

            result[name] = {'name': 'lstm_scan', 'route': 'cuda',
                            'source': 'amt_tools_tpu_torch/csrc/lstm_scan.cu',
                            'replaces': 'amt_tools_tpu/ops/pallas_lstm.py:60',
                            'max_abs_err': err, 'ms': ms,
                            'plain_ms': plain_ms, 'bound_ms': bound,
                            'bound_by': bound_by, 'library_ms': library_ms,
                            'design': f'thread-block clusters: {design}',
                            'geometry': plan}

    # The serving path runs the recurrence in bf16
    return result['bfloat16']


def step_anatomy(xw, w_h, ms, frames):
    """Kernel B's time a dependent step at the serving shape, beside two
    launches that keep the cluster barrier and shrink the rest: one row a
    cluster (B = 16: the same mma chain, the rows being the n = 8 side,
    but one row's xw copies and h exchange) and H = 64 (a quarter of each
    warp's mma chain, of the xw copies and of the exchange)."""

    from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan

    rows_one = xw[:16].contiguous()
    narrow = xw[..., :256].contiguous()
    narrow_w = w_h[:64, :256].contiguous()
    one_ms = time_ms(lambda: lstm_scan(rows_one, w_h), reps=5)
    narrow_ms = time_ms(lambda: lstm_scan(narrow, narrow_w), reps=5)
    _, one = lstm_design(16, HIDDEN, xw.dtype)
    _, small = lstm_design(BATCH, 64, xw.dtype)
    log(f'lstm_scan bf16 a step: {1e3 * ms / frames:.3f} us at B={BATCH}, '
        f'H={HIDDEN}; {1e3 * one_ms / frames:.3f} us at B=16 ({one}); '
        f'{1e3 * narrow_ms / frames:.3f} us at H=64 ({small})')


def lstm_inputs(batch, frames, dtype, seed):
    """Training-shape LSTM inputs on the card: projections of random
    features through a random dense, and an orthogonal W_h."""

    import torch

    g = torch.Generator().manual_seed(seed)
    dim_in = 768
    x = torch.rand(batch, frames, dim_in, generator=g)
    w_x = torch.randn(dim_in, 4 * HIDDEN, generator=g) / dim_in ** 0.5
    w_h = torch.nn.init.orthogonal_(torch.empty(HIDDEN, 4 * HIDDEN),
                                    generator=g)
    x, w_x, w_h = x.cuda(), w_x.cuda(), w_h.cuda()
    xw = (x.to(dtype) @ w_x.to(dtype)).contiguous()

    return x, w_x, w_h, xw, w_h.to(dtype).contiguous()


def cudnn_lstm(x, w_x, w_h, dtype):
    """A training-mode ``torch.nn.LSTM`` with the same weights (it also runs
    the input projection): the yardstick for kernels E and F."""

    import torch

    module = torch.nn.LSTM(x.shape[-1], HIDDEN, batch_first=True).cuda()
    with torch.no_grad():
        module.weight_ih_l0.copy_(w_x.t())
        module.weight_hh_l0.copy_(w_h.t())
        module.bias_ih_l0.zero_()
        module.bias_hh_l0.zero_()
    module = module.to(dtype).train()
    module.flatten_parameters()

    return module, x.to(dtype).requires_grad_()


def lstm_errors(got, ref):
    """Max and mean |got - ref|, the max over the largest |ref| and the mean
    over the mean |ref|."""

    diff = (got.float() - ref.float()).abs()
    magnitude = ref.float().abs()
    scale = magnitude.max().clamp(min=1e-30)

    return (diff.max().item(), diff.mean().item(), (diff.max() / scale).item(),
            (diff.mean() / magnitude.mean().clamp(min=1e-30)).item())


def check_lstm_residuals():
    """Phase 10: kernel E vs its plain version, and its h vs kernel B's."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.lstm_kernel import (
        lstm_scan, lstm_scan_residuals, lstm_scan_residuals_plain)

    result = {}
    with tools.exact_fp32():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            x, w_x, w_h, xw, wh = lstm_inputs(TRAIN_BATCH, TRAIN_FRAMES,
                                              dtype, seed=5)
            worst = {key: (0.0,) * 4 for key in ('out', 'gates', 'c')}
            for reverse in (False, True):
                got = lstm_scan_residuals(xw, wh, reverse)
                ref = lstm_scan_residuals_plain(xw, wh, reverse)
                serving = lstm_scan(xw, wh, reverse)
                torch.cuda.synchronize()
                require(torch.equal(got[0], serving),
                        f'kernel E {name} h differs from kernel B '
                        f'(reverse={reverse})')
                for key, a, b in zip(('out', 'gates', 'c'), got, ref):
                    worst[key] = tuple(max(u, v) for u, v in
                                       zip(worst[key], lstm_errors(a, b)))
            log(f'lstm_scan_residuals {name}: h equals kernel B bit for bit; '
                + '; '.join(f'{key} |kernel - plain| max {m:.6g}, mean '
                            f'{mean:.6g}, {rel:.3g} of the largest'
                            for key, (m, mean, rel, _) in worst.items()))
            require(worst['out'][0] <= LSTM_TOL[name] and
                    worst['out'][1] <= LSTM_MEAN_TOL[name],
                    f'lstm_scan_residuals {name} h disagrees with its plain '
                    f'version')
            for key in ('gates', 'c'):
                require(worst[key][2] <= RESIDUAL_TOL[name] and
                        worst[key][1] <= RESIDUAL_MEAN_TOL[name],
                        f'lstm_scan_residuals {name} {key} disagree with '
                        f'the plain version')

            plan, design = lstm_design(TRAIN_BATCH, HIDDEN, dtype,
                                       residuals=True)
            log(f'lstm_scan_residuals {name} at B={TRAIN_BATCH}, '
                f'H={HIDDEN}: {design}')
            ms = time_ms(lambda: lstm_scan_residuals(xw, wh), reps=5)
            serving_ms = time_ms(lambda: lstm_scan(xw, wh), reps=5)
            plain_ms = time_ms(lambda: lstm_scan_residuals_plain(xw, wh),
                               reps=1)
            module, xd = cudnn_lstm(x, w_x, w_h, dtype)
            library_ms = time_ms(lambda: module(xd), reps=5)

            size = torch.finfo(dtype).bits // 8
            rows = TRAIN_BATCH * TRAIN_FRAMES
            num_bytes = (size * (xw.numel() + wh.numel() + rows * HIDDEN) +
                         4 * rows * 5 * HIDDEN)
            flops = 2.0 * rows * HIDDEN * 4 * HIDDEN
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
            bound, bound_by = bound_ms(num_bytes, flops, peak)
            log(f'lstm_scan_residuals {name}: kernel {ms:.3f} ms (kernel B '
                f'{serving_ms:.3f} ms), plain {plain_ms:.3f} ms, cuDNN '
                f'nn.LSTM training forward {library_ms:.3f} ms (with its '
                f'input projection), bound {bound:.3f} ms ({bound_by}) per '
                f'direction at B={TRAIN_BATCH}, T={TRAIN_FRAMES}, H={HIDDEN}')
            result[name] = {'name': 'lstm_scan_residuals', 'route': 'cuda',
                            'source': 'amt_tools_tpu_torch/csrc/lstm_scan.cu',
                            'replaces': 'amt_tools_tpu/ops/pallas_lstm.py:192',
                            'max_abs_err': worst['out'][0], 'ms': ms,
                            'plain_ms': plain_ms, 'bound_ms': bound,
                            'bound_by': bound_by, 'library_ms': library_ms,
                            'design': 'kernel B\'s cluster body with '
                                      f'kResiduals: {design}',
                            'geometry': plan}

    # The recipe trains in float32
    return result['float32']


def check_lstm_bptt():
    """Phase 11: kernel F vs its plain version on da and dW_h, and the
    float32 Function's gradients vs autograd through the plain forward."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.lstm_kernel import (
        _shift_prev, lstm_bptt, lstm_bptt_plain, lstm_scan_grad,
        lstm_scan_plain, lstm_scan_residuals)

    def dw_h(out, da, reverse):
        h_prev = _shift_prev(out, reverse).float()
        return h_prev.reshape(-1, HIDDEN).t() @ da.reshape(-1, 4 * HIDDEN)

    result = {}
    with tools.exact_fp32():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            x, w_x, w_h, xw, wh = lstm_inputs(TRAIN_BATCH, TRAIN_FRAMES,
                                              dtype, seed=6)
            g = torch.Generator().manual_seed(7)
            dout = torch.randn(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN,
                               generator=g).cuda().to(dtype)
            w_h_t = w_h.t().to(dtype).contiguous()
            worst = {'da': (0.0,) * 4, 'dW_h': (0.0,) * 4}
            for reverse in (False, True):
                out, gates, c_seq = lstm_scan_residuals(xw, wh, reverse)
                got = lstm_bptt(gates, c_seq, dout, w_h_t, reverse)
                ref = lstm_bptt_plain(gates, c_seq, dout, w_h_t, reverse)
                torch.cuda.synchronize()
                pairs = (('da', got, ref),
                         ('dW_h', dw_h(out, got, reverse),
                          dw_h(out, ref, reverse)))
                for key, a, b in pairs:
                    worst[key] = tuple(max(u, v) for u, v in
                                       zip(worst[key], lstm_errors(a, b)))
            log(f'lstm_bptt {name}: ' + '; '.join(
                f'{key} |kernel - plain| max {m:.6g} ({rel:.3g} of the '
                f'largest), mean {mean:.6g} ({mean_rel:.3g} of the mean '
                f'magnitude)' for key, (m, mean, rel, mean_rel) in
                worst.items()))
            for key in ('da', 'dW_h'):
                require(worst[key][2] <= BPTT_TOL[name] and
                        worst[key][3] <= BPTT_MEAN_TOL[name],
                        f'lstm_bptt {name} {key} disagrees with its plain '
                        f'version')

            if dtype == torch.float32:
                grad_err = 0.0
                for reverse in (False, True):
                    grads = []
                    for fn in (lstm_scan_grad, lstm_scan_plain):
                        xi = xw.clone().requires_grad_()
                        wi = w_h.clone().requires_grad_()
                        (fn(xi, wi, reverse) * dout).sum().backward()
                        grads.append((xi.grad, wi.grad))
                    for a, b in zip(*grads):
                        grad_err = max(grad_err, lstm_errors(a, b)[2])
                log(f'lstm_scan_grad float32 vs autograd through '
                    f'lstm_scan_plain: {grad_err:.3g} of the largest '
                    f'gradient (tolerance {BPTT_TOL[name]})')
                require(grad_err <= BPTT_TOL[name],
                        'lstm_scan_grad disagrees with autograd through the '
                        'plain recurrence')

            plan, design = lstm_design(TRAIN_BATCH, HIDDEN, dtype, bptt=True)
            log(f'lstm_bptt {name} at B={TRAIN_BATCH}, H={HIDDEN}: {design}')
            out, gates, c_seq = lstm_scan_residuals(xw, wh)
            ms = time_ms(lambda: lstm_bptt(gates, c_seq, dout, w_h_t), reps=5)
            plain_ms = time_ms(
                lambda: lstm_bptt_plain(gates, c_seq, dout, w_h_t), reps=1)
            module, xd = cudnn_lstm(x, w_x, w_h, dtype)
            lib_out, _ = module(xd)
            params = [xd] + list(module.parameters())
            library_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, params, dout, retain_graph=True), reps=5)

            size = torch.finfo(dtype).bits // 8
            rows = TRAIN_BATCH * TRAIN_FRAMES
            num_bytes = (4 * (gates.numel() + c_seq.numel() + gates.numel()) +
                         size * (dout.numel() + w_h_t.numel()))
            flops = 2.0 * rows * HIDDEN * 4 * HIDDEN
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
            bound, bound_by = bound_ms(num_bytes, flops, peak)
            log(f'lstm_bptt {name}: kernel {ms:.3f} ms '
                f'({1e3 * ms / TRAIN_FRAMES:.3f} us a step), plain '
                f'{plain_ms:.3f} ms, cuDNN nn.LSTM backward {library_ms:.3f} '
                f'ms (with its input projection), bound {bound:.3f} ms '
                f'({bound_by}) per direction at B={TRAIN_BATCH}, '
                f'T={TRAIN_FRAMES}, H={HIDDEN}')
            result[name] = {'name': 'lstm_bptt', 'route': 'cuda',
                            'source': 'amt_tools_tpu_torch/csrc/lstm_bptt.cu',
                            'replaces': 'amt_tools_tpu/ops/pallas_lstm.py:245',
                            'max_abs_err': worst['da'][0], 'ms': ms,
                            'plain_ms': plain_ms, 'bound_ms': bound,
                            'bound_by': bound_by, 'library_ms': library_ms,
                            'design': f'clusters of 8 CTAs: {design}',
                            'geometry': plan}

    return result['float32']


def serve(clips, profile, card):
    """Phase 5: the port's serving path at full width, 3 requests."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.serving import (TranscriptionPipeline,
                                             calibrate_activity)

    mel = MelSpec(sample_rate=SAMPLE_RATE, hop_length=HOP, n_mels=N_MELS)
    model = OnsetsFrames2(dim_in=N_MELS, profile=profile, model_complexity=3,
                          dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0))
    shifts = calibrate_activity(model, mel, clips[:4])
    log(f'calibrated head biases by {shifts}')

    pipeline = TranscriptionPipeline(model, mel, capacity=CAPACITY)
    audio = torch.from_numpy(clips).cuda()
    requests = [torch.roll(audio, shifts=43 * r, dims=0)
                for r in range(REQUESTS)]

    pipeline(requests[0][:8])  # warm-up: cuDNN and allocator first use
    torch.cuda.synchronize()

    reset_launches()
    results, elapsed = serve_requests(pipeline, requests)
    launches = read_launches()

    notes = [len(pitches) for result in results for pitches, _ in result]
    audio_seconds = REQUESTS * BATCH * CLIP_SECONDS
    log(f'served {REQUESTS} requests of {BATCH} x {CLIP_SECONDS:.0f} s in '
        f'{elapsed:.3f} s: {audio_seconds / elapsed:.1f} audio-s per wall-s '
        f'({card}); '
        f'notes per clip min {min(notes)} median {int(np.median(notes))} '
        f'max {max(notes)}; launches {launches}')

    require(launches['stft_power'] >= REQUESTS,
            'the STFT kernel did not run once per dispatch')
    require(launches['stft_power_fft'] == launches['stft_power'],
            'the STFT kernel left its FFT route on the serving path')
    require(launches['lstm_scan'] >= 6 * REQUESTS,
            'the LSTM kernel did not run six times per dispatch')
    require(len(notes) == REQUESTS * BATCH and min(notes) > 0,
            'a served clip decoded no notes')

    with torch.inference_mode():
        feats = mel.process(audio[:2])
        raw = model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])
    frames = mel.get_expected_frames(clips[0])
    for key, logits in raw.items():
        require(logits.shape == (2, frames, 88) and
                bool(torch.isfinite(logits).all()),
                f'bf16 {key} logits are not finite of shape (2, {frames}, 88)')

    return launches, (f'piano batch of {BATCH} clips',
                      lambda: pipeline(requests[0]),
                      ('stft_power_fft_kernel', 'lstm_scan_kernel'))


def serve_requests(pipeline, requests):
    """Overlapped dispatch/finalize of the requests -> (results, seconds)."""

    import torch

    start = time.perf_counter()
    pending = pipeline.dispatch(requests[0])
    results = []
    for request in requests[1:]:
        upcoming = pipeline.dispatch(request)
        results.append(pipeline.finalize(pending))
        pending = upcoming
    results.append(pipeline.finalize(pending))
    torch.cuda.synchronize()

    return results, time.perf_counter() - start


def profile_batches(batches):
    """Device time by kernel over one batch of each path.

    ``batches`` holds (label, run, kernel name fragments), ``run`` a
    callable that does one batch's work. All batches run in one
    ``torch.profiler`` session, after every kernel's library is loaded: a
    kernel whose module was loaded after an earlier session ended went
    missing from a later session's trace. Each batch runs in its own
    ``record_function`` range, and a device event belongs to the range its
    start falls in (the profiler keeps host and device events on one
    clock). Each path's kernels must appear in its range.
    """

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    labels = [label for label, _, _ in batches]
    walls = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, run, _ in batches:
            torch.cuda.synchronize()
            with record_function(label):
                start = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls[label] = (time.perf_counter() - start) * 1e3

    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.name in labels and e.device_type == DeviceType.CPU}
    for label, _, kernels in batches:
        span = ranges[label]
        by_kernel = {}
        intervals = []
        # Device-side events only, without the ranges' own annotations
        for e in events:
            if (e.device_type == DeviceType.CUDA and e.name not in labels and
                    span.start <= e.time_range.start <= span.end):
                ms, count = by_kernel.get(e.name, (0.0, 0))
                by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                     count + 1)
                intervals.append((e.time_range.start, e.time_range.end))
        rows = sorted(((ms, count, name)
                       for name, (ms, count) in by_kernel.items()),
                      reverse=True)
        kernel_ms = sum(ms for ms, _, _ in rows)
        # Busy: the union of the kernels' intervals (kernels may overlap)
        busy_us, end = 0.0, None
        for start, stop in sorted(intervals):
            if end is None or start > end:
                busy_us += stop - start
                end = stop
            elif stop > end:
                busy_us += stop - end
                end = stop
        log(f'{label} under the profiler: {walls[label]:.1f} ms wall, '
            f'{kernel_ms:.1f} ms of kernel time, the device busy '
            f'{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / walls[label]:.1f}'
            f'% of the wall time)')
        # The 15 largest, and the path's own kernels wherever they rank
        shown = rows[:15] + [row for row in rows[15:]
                             if any(kernel in row[2] for kernel in kernels)]
        for ms, count, name in shown:
            log(f'  {ms:9.3f} ms {100 * ms / kernel_ms:5.1f}% x{count:<4d} '
                f'{name[:200]}')
        for kernel in kernels:
            require(any(kernel in name for _, _, name in rows),
                    f'{kernel} is missing from the profile of the {label}')


def check_against_cpu(clips, profile):
    """Phase 5b: a narrow float32 O&F2, card (kernels) vs CPU (plain)."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.ops import decode
    from amt_tools_tpu_torch.serving import (TranscriptionPipeline,
                                             calibrate_activity)

    audio = np.ascontiguousarray(clips[:2, :10 * SAMPLE_RATE])
    mel = MelSpec(n_mels=N_MELS)
    model = OnsetsFrames2(dim_in=N_MELS, profile=profile, model_complexity=2,
                          generator=torch.Generator().manual_seed(3))
    calibrate_activity(model, mel, audio, device='cpu')

    outputs = {}
    for device in ('cpu', 'cuda'):
        pipeline = TranscriptionPipeline(model, mel, capacity=CAPACITY,
                                         device=device)
        notes = pipeline(audio)
        with torch.inference_mode(), tools.exact_fp32():
            feats = mel.process(torch.from_numpy(audio).to(device))
            raw = model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])
        outputs[device] = notes, {k: v.float().cpu() for k, v in raw.items()}

    (cpu_notes, cpu_raw), (gpu_notes, gpu_raw) = outputs['cpu'], outputs['cuda']
    rows = torch.zeros(len(audio), 88, dtype=torch.bool)  # maps differ
    worst = 0.0
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
        ref, got = cpu_raw[key], gpu_raw[key]
        worst = max(worst, (got - ref).abs().max().item())
        differ = (decode.threshold(decode.sigmoid(got)) !=
                  decode.threshold(decode.sigmoid(ref)))
        require(bool((ref[differ].abs() <= LOGIT_TOL).all()),
                f'{key} maps differ away from the threshold')
        rows |= differ.any(dim=1)

    require(worst <= LOGIT_TOL, f'float32 logits card vs CPU {worst} > '
                                f'{LOGIT_TOL}')
    # The decode works row by row: outside the rows whose maps differ the
    # notes must be identical
    compared = 0
    for b in range(len(audio)):
        (p_gpu, i_gpu), (p_cpu, i_cpu) = gpu_notes[b], cpu_notes[b]
        keep_gpu = ~rows[b].numpy()[p_gpu.astype(int) - profile.low]
        keep_cpu = ~rows[b].numpy()[p_cpu.astype(int) - profile.low]
        require(np.array_equal(p_gpu[keep_gpu], p_cpu[keep_cpu]) and
                np.array_equal(i_gpu[keep_gpu], i_cpu[keep_cpu]),
                f'clip {b}: notes on the card differ from the CPU')
        compared += int(keep_cpu.sum())
    require(compared > 0, 'no notes were compared')
    log(f'float32 card vs CPU: logits within {worst:.3g} (tolerance '
        f'{LOGIT_TOL}); notes identical in {88 * len(audio) - int(rows.sum())}'
        f' of {88 * len(audio)} pitch rows, {compared} of '
        f'{sum(len(p) for p, _ in cpu_notes)} notes compared')


class FixedLoader:
    """A re-iterable loader over fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def train_run(model, loader, iterations, label, log_dir=None, checkpoints=0):
    """One ``train()`` run on the card with fresh launch counts: E and F six
    times a step, B never; every loss finite. Returns (result, launches,
    steps per second)."""

    import torch

    from amt_tools_tpu_torch.train import train

    optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    result = train(model, loader, optimizer, iterations,
                   checkpoints=checkpoints, log_dir=log_dir, seed=0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = read_launches()

    steps = result['step']
    losses = result['losses']
    log(f'{label}: {steps} steps in {elapsed:.3f} s, {steps / elapsed:.3f} '
        f'steps/s; launches {launches}')
    for key, values in sorted(losses.items()):
        log(f'  {key}: ' + ' '.join(f'{v:.6g}' for v in values))
    require(launches['lstm_scan_residuals'] == 6 * steps and
            launches['lstm_bptt'] == 6 * steps,
            f'{label}: kernels E and F did not run six times a step')
    require(launches['lstm_scan'] == 0,
            f'{label}: kernel B ran inside a training step')
    require(all(np.isfinite(values).all() for values in losses.values()),
            f'{label}: a loss is not finite')

    return result, launches, steps / elapsed


def train_piano(card):
    """Phase 12: OnsetsFrames2 at complexity 3 trained through ``train()``
    on the recipe's data (16 kHz SyntheticPiano crops of 625 frames, HTK
    mels computed on the card by kernel A, batch 8, Adam 6e-4): float32
    and bf16 runs with a checkpoint, then 30 float32 steps on one batch.
    Returns the float32 run's launch counts, the steps, and a profiler
    entry for one float32 step."""

    import tempfile

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import DataLoader, SyntheticPiano
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.train import (_place_batch, latest_checkpoint,
                                           make_train_step, step_generator)

    tools.use_exact_fp32()
    dataset = SyntheticPiano(num_tracks=16, track_duration=30.0,
                             num_frames=TRAIN_FRAMES,
                             data_proc=MelSpec(n_mels=N_MELS, htk=True))
    loader = DataLoader(dataset, batch_size=TRAIN_BATCH, seed=0)

    def model(dtype, seed):
        return OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                             model_complexity=3, dtype=dtype,
                             generator=torch.Generator().manual_seed(seed))

    runs = {}
    with tempfile.TemporaryDirectory(prefix='_chip_smoke_train_',
                                     dir=ROOT) as log_dir:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            run_dir = f'{log_dir}/{name}'
            result, launches, rate = train_run(
                model(dtype, 0), loader, TRAIN_PASSES,
                f'training O&F2 complexity 3 in {name}, {TRAIN_PASSES} '
                f'passes over {len(dataset)} tracks ({card})',
                log_dir=run_dir, checkpoints=1)
            require(latest_checkpoint(run_dir)[1] == TRAIN_PASSES,
                    f'the {name} run saved no checkpoint')
            runs[name] = result, launches
    require(runs['float32'][1]['stft_power'] >= 1,
            'the dataset features did not run kernel A')

    batch = next(iter(loader))
    result, _, _ = train_run(model(torch.float32, 1), FixedLoader([batch]),
                             FIT_STEPS, f'{FIT_STEPS} float32 steps on one '
                             f'batch')
    losses = result['losses'][tools.KEY_LOSS_TOTAL]
    log(f'fixed batch: total loss {losses[0]:.6g} -> {losses[-1]:.6g}')
    require(losses[-1] < losses[0], 'the float32 loss did not fall on a '
                                    'fixed batch')

    # One float32 step for the profiler, on a model that has stepped
    profiled = model(torch.float32, 2).cuda()
    step = make_train_step(profiled, torch.optim.Adam(profiled.parameters(),
                                                      lr=LEARNING_RATE))
    device_batch = _place_batch(batch, torch.device('cuda'))
    step(device_batch, step_generator(0, 0, 'cuda'))

    steps = runs['float32'][0]['step']
    return (runs['float32'][1], steps,
            (f'float32 training step of {TRAIN_BATCH} x {TRAIN_FRAMES} '
             f'frames',
             lambda: step(device_batch, step_generator(0, 1, 'cuda')),
             ('lstm_scan_kernel', 'lstm_bptt_kernel')))


def conv_block(name):
    """(stack, block) of an acoustic conv block's parameter or buffer, as
    ('onset_am', 1) for ``onset_am.Conv_1.weight``; None elsewhere."""

    stack, layer = name.split('.')[:2]
    if not stack.endswith('_am') or not layer.startswith(('Conv_',
                                                          'BatchNorm_')):
        return None

    return stack, int(layer.rsplit('_', 1)[1])


def record_pre_relu(model, store):
    """Forward hooks that keep each acoustic BatchNorm's output, the input
    of its block's ReLU (and, in blocks 1 and 2, of its 1x2 max-pool)."""

    def keep(name):
        return lambda _module, _inputs, out: store.__setitem__(
            name, out.detach().cpu())

    return [module.register_forward_hook(keep(name))
            for name, module in model.named_modules()
            if '_am.BatchNorm_' in name]


def decision_flips(cpu, gpu, pooled):
    """The ReLU and max-pool decisions that two forwards of one block took
    differently, from their pre-ReLU values (B, C, T, F): a ReLU that passes
    on one side only, and a frequency pair whose larger member differs
    (pairs that are zero on both sides have no gradient to route)."""

    relu = int(((cpu > 0) != (gpu > 0)).sum())
    if not pooled:
        return relu, 0

    def picks(x):
        x = x.clamp(min=0)
        width = 2 * (x.shape[-1] // 2)
        first, second = x[..., 0:width:2], x[..., 1:width:2]
        return first >= second, (first > 0) | (second > 0)

    pick_cpu, live_cpu = picks(cpu)
    pick_gpu, live_gpu = picks(gpu)

    return relu, int(((pick_cpu != pick_gpu) & (live_cpu | live_gpu)).sum())


def train_step_both(seed):
    """One float32 training step of a narrow O&F2 (batch from ``seed``,
    weights from ``seed + 1``) on the CPU and on the card: losses,
    gradients, state after one SGD step and pre-ReLU values, by device."""

    import copy

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2, run_on_batch

    rng = np.random.RandomState(seed)
    batch = {
        tools.KEY_FEATS: rng.rand(2, 1, N_MELS, 128).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(2, 88, 128) < 0.05).astype(
            np.float32),
    }
    model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                          model_complexity=2, dropout=False,
                          generator=torch.Generator().manual_seed(seed + 1))

    results = {}
    with tools.exact_fp32():
        for device in ('cpu', 'cuda'):
            local = copy.deepcopy(model).to(device)
            pre_relu = {}
            hooks = record_pre_relu(local, pre_relu)
            optimizer = torch.optim.SGD(local.parameters(), lr=SGD_LR)
            output = run_on_batch(local, {k: torch.from_numpy(v).to(device)
                                          for k, v in batch.items()},
                                  train=True)
            for hook in hooks:
                hook.remove()
            loss = output[tools.KEY_LOSS]
            loss[tools.KEY_LOSS_TOTAL].backward()
            grads = {n: p.grad.cpu() for n, p in local.named_parameters()}
            optimizer.step()
            results[device] = ({k: v.item() for k, v in loss.items()}, grads,
                               {k: v.cpu() for k, v in
                                local.state_dict().items()}, pre_relu)

    return results['cpu'], results['cuda']


def train_against_cpu():
    """Phase 12b: one float32 training step of a narrow O&F2 on each of
    ``TRAIN_CHECK_SEEDS``, the card (kernels) vs the CPU (plain versions):
    the losses, every gradient against the largest gradient of its module,
    the parameters and statistics after one SGD step (tolerances above),
    and the ReLU and max-pool decisions each acoustic block took on the two
    devices. A conv block is held to ``GRAD_TOL`` unless a decision of its
    stack differs in it or after it."""

    import torch

    eps = torch.finfo(torch.float32).eps
    for seed in TRAIN_CHECK_SEEDS:
        ((cpu_loss, cpu_grads, cpu_state, cpu_pre),
         (gpu_loss, gpu_grads, gpu_state, gpu_pre)) = train_step_both(seed)
        loss_err = max(abs(gpu_loss[k] - cpu_loss[k]) / abs(cpu_loss[k])
                       for k in cpu_loss)

        # Differing decisions (ReLU, max-pool) by acoustic stack and block
        flips = {}
        for name, ref in cpu_pre.items():
            block = conv_block(name)
            flips[block] = decision_flips(ref, gpu_pre[name],
                                          pooled=block[1] > 0)

        # Each tensor's gradient error and parameter error over its
        # tolerance; a conv block is held to CONV_BLOCK_GRAD_TOL where a
        # decision of its stack differs at or after it
        grad_ratios, param_ratios, block_errs = [], [], {}
        for name, ref in cpu_grads.items():
            module = name.rsplit('.', 1)[0]
            scale = max(g.abs().max().item() for n, g in cpu_grads.items()
                        if n.rsplit('.', 1)[0] == module)
            grad_err = (gpu_grads[name] - ref).abs().max().item() / scale
            tol = GRAD_TOL
            block = conv_block(name)
            if block is not None:
                stack, index = block
                block_errs[stack] = max(block_errs.get(stack, 0.0), grad_err)
                if any(sum(counts) for (other, later), counts in flips.items()
                       if other == stack and later >= index):
                    tol = CONV_BLOCK_GRAD_TOL
            grad_ratios.append((grad_err / tol, grad_err, name))

            param = cpu_state[name]
            param_tol = (SGD_LR * tol * scale +
                         2 * eps * param.abs().max().item())
            param_ratios.append(
                (gpu_state[name] - param).abs().max().item() / param_tol)
        grad_ratio, grad_err, grad_name = max(grad_ratios)
        param_ratio = max(param_ratios)
        stat_err = max((gpu_state[k].float() - v.float()).abs().max().item()
                       for k, v in cpu_state.items() if k not in cpu_grads)

        log(f'training step float32 card vs CPU, seed {seed}: losses within '
            f'{loss_err:.3g} (relative; tolerance {LOSS_TOL}); differing '
            f'ReLU/max-pool decisions in blocks 0-2, and the conv blocks\' '
            f'worst gradient error over their module\'s largest: ' +
            ', '.join(f'{stack} ' + ' '.join(
                f'{flips[stack, i][0]}/{flips[stack, i][1]}'
                for i in range(3)) + f' {block_errs[stack]:.3g}'
                for stack in sorted(block_errs)) +
            f'; gradients at most {grad_ratio:.3g} of their tolerance (worst '
            f'{grad_name}, {grad_err:.3g} of its module\'s largest); '
            f'parameters after one SGD step at most {param_ratio:.3g} of '
            f'theirs; running statistics within {stat_err:.3g} (tolerance '
            f'{STAT_TOL})')
        require(loss_err <= LOSS_TOL, 'training losses differ card vs CPU')
        require(grad_ratio <= 1.0, 'gradients differ card vs CPU')
        require(param_ratio <= 1.0 and stat_err <= STAT_TOL,
                'parameters or statistics after a step differ card vs CPU')


def guitar_cqt(grouped):
    """The guitar serving CQT (``bench.py:422-423``)."""

    from amt_tools_tpu_torch.features import CQT

    return CQT(sample_rate=GUITAR_SAMPLE_RATE, hop_length=HOP, n_bins=192,
               bins_per_octave=24, exact='high', grouped=grouped)


def cqt_fft_flops(cqt, frames):
    """Least operations of an FFT-based CQT over ``frames`` frames: per
    frame and octave, one real FFT of the octave's longest wavelet at the
    octave's decimated rate (2.5 n log2 n, n a power of two), plus one
    complex multiply-add per bin."""

    from amt_tools_tpu_torch.ops import spectral

    freqs = spectral.cqt_frequencies(cqt.n_bins, cqt.fmin,
                                     cqt.bins_per_octave)
    lengths = spectral.wavelet_lengths(freqs, cqt.sample_rate, cqt.alpha,
                                       cqt.gamma)
    octave = (cqt.n_bins - 1 - np.arange(cqt.n_bins)) // cqt.bins_per_octave
    per_frame = 8.0 * cqt.n_bins
    for o in np.unique(octave):
        n = 2 ** int(np.ceil(np.log2(lengths[octave == o].max() / 2 ** o)))
        per_frame += 2.5 * n * np.log2(n)

    return frames * per_frame


def cqt_errors(got, ref):
    """Max |got - ref|, absolute and as a share of each clip's peak."""

    peak = ref.amax(dim=(1, 2), keepdim=True)
    diff = (got - ref).abs()

    return diff.max().item(), (diff / peak).max().item()


def conv1d_cqt(audio, banks):
    """The library yardstick: one cuDNN ``conv1d`` per (bank, support) over
    the centred audio, then the magnitude, bins concatenated."""

    import torch
    import torch.nn.functional as F

    parts = []
    for weight, support in banks:
        resp = F.conv1d(audio[:, None], weight, stride=HOP,
                        padding=support // 2)
        n = weight.shape[0] // 2
        parts.append(torch.sqrt(resp[:, :n] ** 2 + resp[:, n:] ** 2))

    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def time_library(fn, name):
    """Time the library yardstick, or None where cuDNN refuses the shape or
    one call runs past 5 s (the port never calls it)."""

    import torch

    try:
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - start
    except RuntimeError as exc:
        log(f'{name}: no library call, cuDNN refused: {exc}')
        return None, None
    if first > 5.0:
        log(f'{name}: no library call, one call took {first:.1f} s')
        return None, None

    return time_ms(fn, reps=3), out


def report_cqt(name, ms, plain_ms, library_ms, cqt, audio, bank, out,
               contraction):
    """Log the times beside both bounds and the contraction's floors."""

    batch, frames = out.shape[0], out.shape[-1]
    num_bytes = 4 * (audio.numel() + bank.numel() + out.numel())
    fft_flops = cqt_fft_flops(cqt, batch * frames)
    bound, bound_by = bound_ms(num_bytes, fft_flops, PEAK_FP32_FLOPS)
    library = 'no library call' if library_ms is None else \
        f'conv1d {library_ms:.3f} ms'
    log(f'{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, {library}, '
        f'bound {bound:.3f} ms ({bound_by}: {num_bytes / 1e9:.3f} GB take '
        f'{num_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms, an FFT-based CQT '
        f'{fft_flops / 1e12:.4f} TFLOP {fft_flops / PEAK_FP32_FLOPS * 1e3:.3f}'
        f' ms) at {tuple(audio.shape)} -> {tuple(out.shape)}; the '
        f'contraction is {contraction / 1e12:.3f} TFLOP: at least '
        f'{contraction / PEAK_FP32_FLOPS * 1e3:.3f} ms in float32, '
        f'{3 * contraction / PEAK_BF16_FLOPS * 1e3:.3f} ms as three bf16 '
        f'passes ({3 * contraction / 1e9 / ms:.1f} TFLOP/s of bf16 passes '
        f'achieved)')

    return bound, bound_by


def check_cqt_routes(name, run, plain, short):
    """Kernel C or D on its three routes against the plain version of the
    same ``exact``: 'high' (bf16x3) at the full shape, False (one bf16
    pass) and True (float32 FMAs) on the first 5 s of each clip, with each
    route's launches counted. Returns the 'high' output and its error."""

    from amt_tools_tpu_torch.ops.cqt_kernel import ROUTES

    out = run(None, 'high')
    abs_err, rel_err = cqt_errors(out, plain(None, 'high'))
    errors = {'high': rel_err}
    for exact in (False, True):
        _, errors[exact] = cqt_errors(run(short, exact), plain(short, exact))
    counts = read_launches()
    launches = {f'{name}_{r}': counts[f'{name}_{r}'] for r in ROUTES}
    log(f'{name}: |kernel - plain| of the same exact, as a share of the clip '
        f'peak (tolerance {CQT_TOL}): high (bf16x3) {errors["high"]:.3g} '
        f'({abs_err:.6g} absolute) at the full shape; False (one bf16 pass) '
        f'{errors[False]:.3g}, True (float32 FMAs) {errors[True]:.3g} on the '
        f'first 5 s; launches by route {launches}')
    for exact, err in errors.items():
        require(err <= CQT_TOL, f'{name} exact={exact!r} disagrees with its '
                                f'plain version')
    require(launches[f'{name}_bf16x3'] >= 1 and launches[f'{name}_bf16'] >= 1
            and launches[f'{name}_ffma'] >= 1,
            f'{name} did not take each route it was asked for')

    return out, abs_err


def check_cqt_float32(name, cqt, out, f32_out, ref_high, ref_f32):
    """At the full shape, against the float32 plain version: the kernel's
    float32 route (exact=True) as [0, 1] features within the JAX package's
    feature bound, and its 'high' route (bf16x3) within the JAX package's
    bound for the split, of each clip's peak. Logged beside them: the
    distance of the 'high' features from float32's, the kernel's and the
    bf16x3 plain version's; the JAX package's feature comment
    (features/cqt.py:29-32) puts it within 2e-4, which these clips'
    quietest bins above the -80 dB floor do not keep."""

    feats = cqt.post_proc(ref_f32)
    f32_err = (cqt.post_proc(f32_out) - feats).abs().max().item()
    _, high_err = cqt_errors(out, ref_f32)
    gap = (cqt.post_proc(out) - feats).abs()
    plain_gap = (cqt.post_proc(ref_high) - feats).abs()
    loud = feats > 0.2  # above -64 dB
    log(f'{name} vs the float32 plain version: True (float32 FMAs) as '
        f'[0, 1] features {f32_err:.3g} (tolerance {CQT_FEATURE_TOL}); high '
        f'(bf16x3) {high_err:.3g} of the clip peak (tolerance '
        f'{CQT_HIGH_TOL}), as features {gap.max().item():.3g} '
        f'({gap[loud].max().item():.3g} above -64 dB), the bf16x3 plain '
        f'version {plain_gap.max().item():.3g} '
        f'({plain_gap[loud].max().item():.3g})')
    require(f32_err <= CQT_FEATURE_TOL,
            f'{name} float32 features disagree with the plain version')
    require(high_err <= CQT_HIGH_TOL,
            f'{name} bf16x3 disagrees with float32')


def check_cqt(clips):
    """Phase 6: kernel C vs its plain version, then timed at the recipe."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.cqt_kernel import cqt_mag, cqt_mag_plain

    cqt = guitar_cqt(grouped=False)
    support = cqt._support
    audio = torch.from_numpy(clips).cuda()
    short = audio[:, :5 * GUITAR_SAMPLE_RATE].contiguous()
    bank = torch.from_numpy(cqt._kernel).cuda()

    def clip(part):
        return audio if part is None else part

    with tools.exact_fp32():
        reset_launches()
        out, abs_err = check_cqt_routes(
            'cqt_mag',
            lambda part, exact: cqt_mag(clip(part), bank, support, HOP,
                                        exact=exact),
            lambda part, exact: cqt_mag_plain(clip(part), bank, support, HOP,
                                              exact=exact),
            short)
        check_cqt_float32(
            'cqt_mag', cqt, out,
            cqt_mag(audio, bank, support, HOP, exact=True),
            cqt_mag_plain(audio, bank, support, HOP, exact='high'),
            cqt_mag_plain(audio, bank, support, HOP))

        ms = time_ms(lambda: cqt_mag(audio, bank, support, HOP, exact='high'),
                     reps=5)
        plain_ms = time_ms(
            lambda: cqt_mag_plain(audio, bank, support, HOP, exact='high'),
            reps=2)
        weights = [(bank.t().contiguous()[:, None, :], support)]
        library_ms, lib_out = time_library(
            lambda: conv1d_cqt(audio, weights), 'cqt_mag yardstick')
        if lib_out is not None:
            log(f'cqt_mag: conv1d vs kernel {cqt_errors(lib_out, out)[1]:.3g}'
                f' of the clip peak')
        del lib_out

    contraction = 2.0 * support * bank.shape[1] * out.shape[0] * out.shape[-1]
    bound, bound_by = report_cqt('cqt_mag', ms, plain_ms, library_ms, cqt,
                                 audio, bank, out, contraction)

    return {'name': 'cqt_mag', 'route': 'cuda',
            'source': 'amt_tools_tpu_torch/csrc/cqt_mag.cu',
            'replaces': 'amt_tools_tpu/ops/pallas_cqt.py:51',
            'max_abs_err': abs_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms, 'exact': 'high',
            'design': 'bf16x3 split on the tensor cores (mma.sync)'}


def check_cqt_grouped(clips):
    """Phase 7: kernel D vs kernel C on the full bank and vs its plain
    version, then timed at the recipe."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.cqt_kernel import (cqt_mag, cqt_mag_grouped,
                                                    cqt_mag_grouped_plain)

    cqt = guitar_cqt(grouped='auto')
    require(cqt._groups is not None, "grouped='auto' built no groups")
    audio = torch.from_numpy(clips).cuda()
    short = audio[:, :5 * GUITAR_SAMPLE_RATE].contiguous()
    stack = torch.from_numpy(cqt._bank_stack).cuda()
    args = (stack, cqt._group_supports, cqt._group_bins, HOP)

    def clip(part):
        return audio if part is None else part

    with tools.exact_fp32():
        reset_launches()
        out, abs_err = check_cqt_routes(
            'cqt_mag_grouped',
            lambda part, exact: cqt_mag_grouped(clip(part), *args,
                                                exact=exact),
            lambda part, exact: cqt_mag_grouped_plain(clip(part), *args,
                                                      exact=exact),
            short)
        check_cqt_float32(
            'cqt_mag_grouped', cqt, out,
            cqt_mag_grouped(audio, *args, exact=True),
            cqt_mag_grouped_plain(audio, *args, exact='high'),
            cqt_mag_grouped_plain(audio, *args))
        full = cqt_mag(audio, torch.from_numpy(cqt._kernel).cuda(),
                       cqt._support, HOP, exact='high')
        _, full_err = cqt_errors(out, full)
        del full
        log(f'cqt_mag_grouped: groups of {cqt._group_bins} bins at supports '
            f'{cqt._group_supports}; vs kernel C on the full bank, both '
            f'high (bf16x3), {full_err:.3g} of the clip peak (tolerance '
            f'{CQT_TOL})')
        require(full_err <= CQT_TOL,
                'cqt_mag_grouped disagrees with the full-bank kernel')

        ms = time_ms(lambda: cqt_mag_grouped(audio, *args, exact='high'),
                     reps=5)
        plain_ms = time_ms(
            lambda: cqt_mag_grouped_plain(audio, *args, exact='high'), reps=2)
        one_pass_ms = time_ms(
            lambda: cqt_mag_grouped(audio, *args, exact=False), reps=5)
        gb = stack.shape[1] // 2
        weights, group_ms = [], []
        row0 = 0
        for support, bins in zip(cqt._group_supports, cqt._group_bins):
            rows = stack[row0: row0 + support]
            group_ms.append(time_ms(
                lambda rows=rows, group=((support,), (bins,)):
                cqt_mag_grouped(audio, rows, *group, HOP, exact='high'),
                reps=3))
            bank = torch.cat([rows[:, :bins], rows[:, gb: gb + bins]], dim=1)
            weights.append((bank.t().contiguous()[:, None, :], support))
            row0 += support
        log(f'cqt_mag_grouped: high (three bf16 passes) {ms:.3f} ms, False '
            f'(one pass, the same body) {one_pass_ms:.3f} ms; each group '
            f'alone on high ' + ', '.join(f'{t:.3f}' for t in group_ms) +
            f' ms (sum {sum(group_ms):.3f}: the groups in one launch leave '
            f'{max(0.0, ms - sum(group_ms)):.3f} ms of tail beyond it)')
        library_ms, lib_out = time_library(
            lambda: conv1d_cqt(audio, weights), 'cqt_mag_grouped yardstick')
        if lib_out is not None:
            log(f'cqt_mag_grouped: conv1d vs kernel '
                f'{cqt_errors(lib_out, out)[1]:.3g} of the clip peak')
        del lib_out

    contraction = sum(2.0 * support * 2 * bins for support, bins in
                      zip(cqt._group_supports, cqt._group_bins))
    contraction *= out.shape[0] * out.shape[-1]
    bound, bound_by = report_cqt('cqt_mag_grouped', ms, plain_ms, library_ms,
                                 cqt, audio, stack, out, contraction)

    return {'name': 'cqt_mag_grouped', 'route': 'cuda',
            'source': 'amt_tools_tpu_torch/csrc/cqt_mag.cu',
            'replaces': 'amt_tools_tpu/ops/pallas_cqt.py:115',
            'max_abs_err': abs_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms, 'exact': 'high',
            'design': 'bf16x3 split on the tensor cores (mma.sync)'}


def serve_guitar(clips, card):
    """Phase 8: the port's guitar serving path at full width, 3 requests
    through the serving CQT (kernel D), then one through the full bank
    (kernel C)."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.serving import (TablaturePipeline,
                                             calibrate_tablature_activity)

    profile = tools.GuitarProfile(num_frets=19)
    cqt = guitar_cqt(grouped='auto')
    model = TabCNN(dim_in=cqt.get_feature_size(), profile=profile,
                   fullseq=True, dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(0))
    shifts = calibrate_tablature_activity(model, cqt, clips[:4])
    log(f'calibrated silence biases by {np.round(shifts, 4).tolist()}')

    pipeline = TablaturePipeline(model, cqt, capacity=GUITAR_CAPACITY)
    audio = torch.from_numpy(clips).cuda()
    requests = [torch.roll(audio, shifts=17 * r, dims=0)
                for r in range(REQUESTS)]

    pipeline(requests[0][:8])  # warm-up: cuDNN and allocator first use
    torch.cuda.synchronize()

    reset_launches()
    results, elapsed = serve_requests(pipeline, requests)
    launches = read_launches()

    notes = [sum(len(pitches) for pitches, _ in clip.values())
             for result in results for clip in result]
    audio_seconds = REQUESTS * GUITAR_BATCH * CLIP_SECONDS
    log(f'guitar: served {REQUESTS} requests of {GUITAR_BATCH} x '
        f'{CLIP_SECONDS:.0f} s in {elapsed:.3f} s: '
        f'{audio_seconds / elapsed:.1f} audio-s per wall-s ({card}); notes '
        f'per clip min {min(notes)} median {int(np.median(notes))} max '
        f'{max(notes)}; launches {launches}')
    require(launches['cqt_mag_grouped_bf16x3'] >= REQUESTS,
            'the grouped CQT kernel did not run once per dispatch on its '
            'bf16x3 route')
    require(len(notes) == REQUESTS * GUITAR_BATCH and min(notes) > 0,
            'a served guitar clip decoded no notes')

    with torch.inference_mode():
        feats = cqt.process(audio[:2])
        raw = model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])
    frames = cqt.get_expected_frames(clips[0])
    logits = raw[tools.KEY_TABLATURE]
    require(logits.shape == (2, frames, 6 * 21) and
            bool(torch.isfinite(logits).all()),
            f'bf16 tablature logits are not finite of shape (2, {frames}, '
            f'126)')

    # The class default: the full bank, through kernel C
    full = TablaturePipeline(model, guitar_cqt(grouped=False),
                             capacity=GUITAR_CAPACITY)
    reset_launches()
    full_results, full_elapsed = serve_requests(full, requests[:1])
    full_launches = read_launches()
    full_notes = [sum(len(pitches) for pitches, _ in clip.values())
                  for clip in full_results[0]]
    log(f'guitar, full-bank CQT: 1 request of {GUITAR_BATCH} x '
        f'{CLIP_SECONDS:.0f} s in {full_elapsed:.3f} s; {sum(full_notes)} '
        f'notes (the grouped bank gave {sum(notes[:GUITAR_BATCH])}); '
        f'launches {full_launches}')
    require(full_launches['cqt_mag_bf16x3'] >= 1,
            'the full-bank CQT kernel did not run on its bf16x3 route')
    require(min(full_notes) > 0, 'a full-bank guitar clip decoded no notes')

    return ({'cqt_mag_grouped': launches['cqt_mag_grouped'],
             'cqt_mag': full_launches['cqt_mag']},
            (f'guitar batch of {GUITAR_BATCH} clips',
             lambda: pipeline(requests[0]), ('cqt_mag_tc_kernel',)))


def guitar_card_and_cpu(audio, model, cqt):
    """Notes, float32 logits and features of the guitar pipeline on the CPU
    and on the card, by device."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.serving import TablaturePipeline

    outputs = {}
    for device in ('cpu', 'cuda'):
        pipeline = TablaturePipeline(model, cqt, capacity=GUITAR_CAPACITY,
                                     device=device)
        notes = pipeline(audio)
        with torch.inference_mode(), tools.exact_fp32():
            feats = cqt.process(torch.from_numpy(audio).to(device))
            raw = model(model.pre_proc({tools.KEY_FEATS: feats})[
                tools.KEY_FEATS])[tools.KEY_TABLATURE]
        outputs[device] = notes, raw.float().cpu(), feats.cpu()

    return outputs


def check_guitar_against_cpu(clips):
    """Phase 8b: a float32 TabCNN behind the serving CQT, card (kernel D on
    'high', its bf16x3 route) vs CPU (plain versions, float32 whatever
    ``exact`` says, as JAX's CPU route): the logits within the piano check's
    bound, the tablature equal wherever the CPU's top-two margin allows,
    notes identical on every equal string; the features' distance logged."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.serving import (TablaturePipeline,
                                             calibrate_tablature_activity)

    audio = np.ascontiguousarray(clips[:2, :10 * GUITAR_SAMPLE_RATE])
    cqt = guitar_cqt(grouped='auto')
    model = TabCNN(dim_in=cqt.get_feature_size(),
                   profile=tools.GuitarProfile(num_frets=19), fullseq=True,
                   generator=torch.Generator().manual_seed(3))
    calibrate_tablature_activity(model, cqt, audio, device='cpu')

    outputs = {}
    for device in ('cpu', 'cuda'):
        pipeline = TablaturePipeline(model, cqt, capacity=GUITAR_CAPACITY,
                                     device=device)
        notes = pipeline(audio)
        with torch.inference_mode(), tools.exact_fp32():
            feats = cqt.process(torch.from_numpy(audio).to(device))
            raw = model(model.pre_proc({tools.KEY_FEATS: feats})[
                tools.KEY_FEATS])[tools.KEY_TABLATURE]
        outputs[device] = notes, raw.float().cpu(), feats.cpu()

    (cpu_notes, cpu_raw, cpu_feats), (gpu_notes, gpu_raw, gpu_feats) = (
        outputs['cpu'], outputs['cuda'])
    feat_err = (gpu_feats - cpu_feats).abs().max().item()
    worst = (gpu_raw - cpu_raw).abs().max().item()
    require(worst <= LOGIT_TOL, f'float32 tablature logits card vs CPU '
                                f'{worst} > {LOGIT_TOL}')

    head = model.tablature_out
    cpu_tab, gpu_tab = head.finalize_output(cpu_raw), head.finalize_output(
        gpu_raw)
    top2 = cpu_raw.reshape(cpu_raw.shape[:2] + (6, 21)).topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).transpose(-1, -2)
    differ = cpu_tab != gpu_tab
    require(bool((margin[differ] <= TAB_MARGIN).all()),
            f'tablature differs where the top-two margin exceeds {TAB_MARGIN}')

    compared = notes_compared = 0
    for b in range(len(audio)):
        for string in range(6):
            if not torch.equal(cpu_tab[b, string], gpu_tab[b, string]):
                continue
            (p_cpu, i_cpu), (p_gpu, i_gpu) = (cpu_notes[b][string],
                                              gpu_notes[b][string])
            require(np.array_equal(p_gpu, p_cpu) and
                    np.array_equal(i_gpu, i_cpu),
                    f'clip {b} string {string}: notes on the card differ '
                    f'from the CPU')
            compared += 1
            notes_compared += len(p_cpu)
    require(compared > 0, 'no string was compared')
    log(f'guitar float32 card (bf16x3 CQT) vs CPU (float32 CQT): features '
        f'within {feat_err:.3g}; logits within {worst:.3g} (tolerance '
        f'{LOGIT_TOL}); {int(differ.sum())} of {differ.numel()} tablature '
        f'cells differ (all within a top-two margin of {TAB_MARGIN}); notes '
        f'identical on {compared} of {6 * len(audio)} strings, '
        f'{notes_compared} notes compared')


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device')

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops import cuda_build

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}')

    start = time.perf_counter()
    report = cuda_build.build()
    log(f'built {sorted(report)} in {time.perf_counter() - start:.1f} s')
    for name, info in report.items():
        log(f'{name}: nvcc {info["seconds"]:.1f} s\n{info["ptxas"]}')

    profile = tools.PianoProfile()
    start = time.perf_counter()
    clips = render_clips(profile, BATCH, CLIP_SECONDS)
    log(f'rendered {BATCH} x {CLIP_SECONDS:.0f} s clips in '
        f'{time.perf_counter() - start:.1f} s')

    audio = torch.from_numpy(clips).cuda()
    stft = check_stft(audio)
    frames = 1 + clips.shape[-1] // HOP
    del audio
    lstm = check_lstm(frames)
    torch.cuda.empty_cache()

    launches, piano_batch = serve(clips, profile, card)
    check_against_cpu(clips, profile)
    del clips
    torch.cuda.empty_cache()

    stft['launches'] = launches['stft_power']
    lstm['launches'] = launches['lstm_scan']

    start = time.perf_counter()
    guitar = render_clips(tools.GuitarProfile(num_frets=19), GUITAR_BATCH,
                          CLIP_SECONDS, GUITAR_SAMPLE_RATE)
    log(f'rendered {GUITAR_BATCH} x {CLIP_SECONDS:.0f} s guitar clips at '
        f'{GUITAR_SAMPLE_RATE} Hz in {time.perf_counter() - start:.1f} s')

    cqt_full = check_cqt(guitar)
    torch.cuda.empty_cache()
    cqt_grouped = check_cqt_grouped(guitar)
    torch.cuda.empty_cache()

    launches, guitar_batch = serve_guitar(guitar, card)
    check_guitar_against_cpu(guitar)
    del guitar
    torch.cuda.empty_cache()

    cqt_full['launches'] = launches['cqt_mag']
    cqt_grouped['launches'] = launches['cqt_mag_grouped']

    residuals = check_lstm_residuals()
    bptt = check_lstm_bptt()
    torch.cuda.empty_cache()
    launches, steps, train_batch = train_piano(card)
    train_against_cpu()
    for entry in (residuals, bptt):
        entry['launches'] = launches[entry['name']]
        entry['launches_per_step'] = launches[entry['name']] / steps

    profile_batches([piano_batch, guitar_batch, train_batch])

    log(card)
    print(json.dumps({'kernels': [stft, lstm, cqt_full, cqt_grouped,
                                  residuals, bptt]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
