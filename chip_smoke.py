"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, serve.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build every hand-written kernel from ``amt_tools_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. the STFT power kernel against its plain version at the serving shape
   (128 clips x 60 s at 16 kHz), on power and on the [0, 1] mel features,
   timed beside the plain version and ``torch.stft`` (cuFFT);
4. the LSTM kernel against its plain version at B = 128, T = 1876,
   H = 256, both directions, float32 and bf16, timed beside the plain
   version and cuDNN ``torch.nn.LSTM``;
5. the serving path: Onsets & Frames v2 at complexity 3 (full width) in
   bf16 with seeded random weights, activity calibration on 4 clips, then
   3 requests of 128 x 60 s clips with overlapped dispatch/finalize. The
   kernels' launch counts are reset just before the requests and read just
   after; every kernel must have run. One more batch runs under
   ``torch.profiler`` to print the device time by kernel. A narrow float32
   copy checks notes and logits on the card against the CPU (plain
   versions).

The last lines are the card, one ``kernels`` JSON line, and one JSON line
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

SAMPLE_RATE = 16000
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


def render_clips(profile, count, seconds):
    from amt_tools_tpu_torch.datasets import random_notes, render_notes

    rng = np.random.RandomState(0)
    clips = []
    for b in range(count):
        pitches, intervals = random_notes(profile, seconds, int(2 * seconds),
                                          rng)
        clips.append(render_notes(pitches, intervals, SAMPLE_RATE, seconds,
                                  seed=b))

    return np.stack(clips)


def check_stft(audio):
    """Phase 3: kernel A vs its plain version at the serving shape."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.ops.stft_kernel import stft_power, stft_power_plain

    mel = MelSpec(n_mels=N_MELS)
    bank = mel._bank(audio.device)

    with tools.exact_fp32():
        got = stft_power(audio, bank, N_FFT, HOP)
        ref = stft_power_plain(audio, bank, N_FFT, HOP)
        torch.cuda.synchronize()

        peak = ref.amax(dim=(1, 2), keepdim=True)
        abs_err = (got - ref).abs().max().item()
        rel_err = ((got - ref).abs() / peak).max().item()

        fb = mel._filterbank(audio.device)
        feat_err = (mel.post_proc(torch.matmul(fb, got)) -
                    mel.post_proc(torch.matmul(fb, ref))).abs().max().item()
        del ref

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
        f'torch.stft vs kernel {lib_err:.3g} of the clip peak')
    require(rel_err <= STFT_POWER_TOL, 'stft_power disagrees with its plain version')
    require(feat_err <= MEL_FEATURE_TOL, 'stft_power mel features disagree')

    batch, num_samples = audio.shape
    frames, n_bins = got.shape[-1], got.shape[1]
    num_bytes = 4 * (audio.numel() + bank.numel() + got.numel())
    # The least work that gives STFT power is a real FFT of each windowed
    # frame (about 2.5 n log2 n operations), then re^2 + im^2
    fft_flops = batch * frames * (2.5 * N_FFT * np.log2(N_FFT) + N_FFT +
                                  3.0 * n_bins)
    bound, bound_by = bound_ms(num_bytes, fft_flops, PEAK_FP32_FLOPS)
    # What a DFT-matmul design (this kernel's) cannot beat
    dft_flops = 2.0 * batch * frames * N_FFT * 2 * n_bins
    log(f'stft_power: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
        f'torch.stft {library_ms:.3f} ms, bound {bound:.3f} ms ({bound_by}, '
        f'FFT work) at ({batch}, {num_samples}) -> {tuple(got.shape)}; '
        f'a DFT-matmul does {dft_flops / 1e12:.3f} TFLOP: at least '
        f'{dft_flops / PEAK_FP32_FLOPS * 1e3:.3f} ms in float32, '
        f'{3 * dft_flops / PEAK_BF16_FLOPS * 1e3:.3f} ms as 3 bf16 passes')

    return {'name': 'stft_power', 'route': 'cuda',
            'source': 'amt_tools_tpu_torch/csrc/stft_power.cu',
            'replaces': 'amt_tools_tpu/ops/pallas_stft.py:119',
            'max_abs_err': abs_err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': library_ms}


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
                            'bound_by': bound_by, 'library_ms': library_ms}

    # The serving path runs the recurrence in bf16
    return result['bfloat16']


def serve(clips, profile, card):
    """Phase 5: the port's serving path at full width, 3 requests."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan
    from amt_tools_tpu_torch.ops.stft_kernel import stft_power
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

    stft_power.launches = 0
    lstm_scan.launches = 0
    start = time.perf_counter()
    pending = pipeline.dispatch(requests[0])
    results = []
    for request in requests[1:]:
        upcoming = pipeline.dispatch(request)
        results.append(pipeline.finalize(pending))
        pending = upcoming
    results.append(pipeline.finalize(pending))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = {'stft_power': stft_power.launches,
                'lstm_scan': lstm_scan.launches}

    notes = [len(pitches) for result in results for pitches, _ in result]
    audio_seconds = REQUESTS * BATCH * CLIP_SECONDS
    log(f'served {REQUESTS} requests of {BATCH} x {CLIP_SECONDS:.0f} s in '
        f'{elapsed:.3f} s: {audio_seconds / elapsed:.1f} audio-s per wall-s '
        f'({card}); '
        f'notes per clip min {min(notes)} median {int(np.median(notes))} '
        f'max {max(notes)}; launches {launches}')

    require(launches['stft_power'] >= REQUESTS,
            'the STFT kernel did not run once per dispatch')
    require(launches['lstm_scan'] >= 6 * REQUESTS,
            'the LSTM kernel did not run six times per dispatch')
    require(len(notes) == REQUESTS * BATCH and min(notes) > 0,
            'a served clip decoded no notes')

    profile_batch(pipeline, requests[0])

    with torch.inference_mode():
        feats = mel.process(audio[:2])
        raw = model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])
    frames = mel.get_expected_frames(clips[0])
    for key, logits in raw.items():
        require(logits.shape == (2, frames, 88) and
                bool(torch.isfinite(logits).all()),
                f'bf16 {key} logits are not finite of shape (2, {frames}, 88)')

    return launches


def profile_batch(pipeline, audio):
    """Device time by kernel over one served batch, from torch.profiler."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        pipeline(audio)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

    # Device-side events only: the operators that launched them report
    # the same time again
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    for kernel in ('stft_power_kernel', 'lstm_scan_kernel'):
        require(any(kernel in name for _, _, name in rows),
                f'{kernel} is missing from the profile')
    busy_ms = sum(ms for ms, _, _ in rows)
    log(f'one batch of {audio.shape[0]} clips under the profiler: '
        f'{wall_ms:.1f} ms wall, {busy_ms:.1f} ms on the device '
        f'({100 * busy_ms / wall_ms:.1f}% busy)')
    for ms, count, name in rows[:15]:
        log(f'  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:<4d} '
            f'{name[:200]}')


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

    launches = serve(clips, profile, card)
    check_against_cpu(clips, profile)

    stft['launches'] = launches['stft_power']
    lstm['launches'] = launches['lstm_scan']

    log(card)
    print(json.dumps({'kernels': [stft, lstm]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
