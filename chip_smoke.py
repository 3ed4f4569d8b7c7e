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
   have run, the conv epilogue nine times a dispatch and the three acoustic
   stacks channels-last (``ops.layers.stack_layout``). 5b: a
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
    three times a step (one launch a BiLSTM), B and the conv epilogue never; every loss finite. 12b: one float32
    training step of a narrow O&F2 on each of three seeds, card (kernels)
    against the CPU (plain versions), on the losses, the gradients and the
    parameters after one SGD step, with the ReLU and max-pool decisions
    that the two forwards took differently counted per acoustic stack;
14. int8-static piano serving at the JAX headline recipe (``bench.py:52-
    113``, ``quant='static'``): O&F2 complexity 3 in bf16 with Conv_1,
    Conv_2 and Dense_0 of each acoustic stack in int8 (``ops/qconv.py``:
    an im2col into ``torch._int_mm``), scales calibrated on 4 clips
    (``calibrate_quant_stats``), then activity; 3 requests of 128 x 60 s
    with overlapped dispatch/finalize, in turns with the bf16 pipeline on
    the same weights (bf16, int8, int8, bf16); the note agreement (F1)
    with bf16 as ``bench.py:242-271`` computes it; each batch's peak
    memory, int8 and bf16; counts reset before and read after each run:
    A once and B three times a dispatch on the int8 route; and 5 clips of
    the batch, in every int8 layer (Conv_1 over 26 chunks), equal bit for
    bit to the same clips run alone in one chunk;
15. int8-static guitar: one 64 x 60 s batch through TabCNN (fullseq) with
    conv1-conv3 and dense1 in int8 behind the serving CQT (kernel D must
    run), in turns with bf16; the tablature cells and the notes it shares
    with bf16;
16. int8-static O&F2 (complexity 3, float32, acoustic stacks and LM
    projections in int8) on a short clip, card against CPU: every int8
    layer's int32 accumulators bit for bit on the CPU's int8 operands, the
    operands the two devices quantize differently counted by steps, the
    logits within ``INT8_LOGIT_TOL``;
17. the piano batch's int8 layers (Conv_1, Conv_2, Dense_0 at 128 x 60 s,
    bf16 in and out) timed against cuDNN's bf16 conv and a bf16
    ``F.linear`` at the same shapes;
18. kernel B with per-row lengths at the bucketed validation shape (8
    tracks padded to the 3840 frames of a 120 s track, H = 256, lengths
    spread over 20-120 s), float32 and bf16: against its masked plain
    version on the valid frames, padded outputs exactly 0, lengths = T bit
    for bit the unmasked launch; masked against unmasked time;
19. piano validation: O&F2 complexity 3 in float32 (the of_2 recipe)
    through ``evaluate.validate`` with the recipe's estimator and evaluator
    over 16 SyntheticPiano tracks of 20-120 s (HTK mels by kernel A on the
    card), bucketed by 128 frames, at batch sizes 1 and 8: kernel B masked
    three times a forward, every track scored alike by both passes, every
    track's notes equal to ``run_offline(bucket=0)``'s; tracks per second,
    audio-s per wall-s and the host's share;
20. guitar validation: TabCNN (fullseq, bf16) through ``validate`` with the
    tabcnn recipe's estimator and evaluator over 8 rendered guitar tracks of
    10-45 s (kernel D once a track); ``run_online`` on a 5 s track against
    ``run_offline``'s tablature in float32;
21. ``train()`` at the of_2 recipe (float32, 8 x 625 frames, complexity
    3) for 4 steps with ``checkpoints=2`` and a 4-track validation set: two
    validations, steps/s with and without them;
22. the velocity head: O&F2 complexity 3 with ``estimate_velocity`` in
    float32 through ``train()`` on SyntheticPiano(velocity_range=(0.3,
    1.0)) crops of 8 x 625, Adam: E and F four times a step, steps/s; 30
    steps on one batch, whose velocity loss must fall;
23. ``remat`` False, True, 'blocks' and False again, in turns, on that
    model and batch: the first step's loss bit for bit equal, the
    gradients within ``GRAD_TOL`` of each module's largest, the running
    statistics within ``STAT_TOL``; steps/s and
    ``torch.cuda.max_memory_allocated`` for each;
24. the synthetic_tabcnn recipe: TabCNN windowed, complexity 1, float32, on
    the full-bank CQT (192 bins, 24 an octave, exact=True: kernel C on its
    FFMA route, once a track) over 32 + 6 SyntheticGuitar tracks of 8 s,
    batch 8 x 128 frames, Adadelta 1.0, ``train()`` with 2 checkpoints,
    each validating with the recipe's estimator and evaluators; steps/s
    with and without the validations;
25. streaming: kernel B from a carry (25a: one row at T = 1, H = 512, and 8
    x 625 at H = 256, float32 and bf16) against its carried plain version,
    chunks bit for bit equal to one launch, timed in turns with the launch
    without a carry; then OnsetsFramesOnline complexity 3 on MelSpec at 16
    kHz through ``run_online_stateful`` over a 10 s track: B from the carry
    twice a frame, median and p99 ms a frame against the 32 ms hop, the
    logits within ``LOGIT_TOL`` of the CPU's, an ``AudioStream`` feeding
    the same steps giving the same maps; and the online model's
    whole-sequence training step (E and F twice a step);
26. real corpora, written under a temporary directory of the repository
    by the port's own writers (``write_wav``, ``write_notes_midi``,
    ``write_stacked_notes_jams``) in the layouts of
    ``tests/fixtures/corpora.py``: MAESTRO (16 train tracks of 30 s, 2
    validation and 2 test tracks of 60 s, the split CSV), MAPS (ENSTDkAm
    and ENSTDkCl, 2 tracks of 30 s each) and GuitarSet (6 players x 60
    tracks of 5 s at 22.05 kHz). The of_2 recipe on MAESTRO crops: O&F2
    complexity 3 float32 on HTK mels, ``MAESTRO_V3(store_data=False,
    save_data=True)`` on a fresh cache, 8 x 625 frames, 4 loader threads,
    Adam 6e-4, one pass of ``train()`` validating the validation split at
    its checkpoint; with the cache cold (the threads run kernel A once a
    track read, the npz files appear) and warm (A never runs, every
    track's features read back bit for bit the cold pass's); E and F three
    times a step; steps/s and the loader's host ms a batch; one track's
    features card against CPU; the notes MAESTRO loads against those
    written, within half a MIDI tick;
27. ``validate`` on the MAESTRO test split and the MAPS splits (their
    notes checked as in 26): kernel A and masked B once and three times a
    track; tracks/s;
28. the tabcnn recipe on GuitarSet fold 0: TabCNN paper width float32 on
    CQT(22050, 512, n_bins=192, bins_per_octave=24), players 01-05 cropped
    to 200 frames, batch 30, Adadelta 1.0, one pass of ``train()``
    validating player 00: kernel C on its FFMA route once a track (360)
    with the cache cold, never warm; steps/s;
29. ``AudioFileStream`` over a MAESTRO WAV through OnsetsFramesOnline
    complexity 3 (``run_online_stateful``): frames bit for bit an
    ``AudioStream``'s over ``load_normalize_audio`` of the file, A once
    and carried B twice a frame; ms a frame against the hop;
30. HCQT at DeepSalience's harmonics (22.05 kHz, hop 512, fmin C1, 72 bins
    at 12 an octave) over 8 clips of 30 s: C six times, the features
    against the CPU's; ``SignalPower`` and a ``FeatureCombo`` of a CQT and
    a two-harmonic HCQT beside it;
31. ``train(mesh=get_mesh())`` over NCCL at world size 1 in this process
    against ``train()`` (O&F2 complexity 3, float32, 8 x 625, dropout on,
    two Adam steps each, cuDNN's deterministic algorithms): losses,
    parameters and BatchNorm buffers bit for bit; E and F three times a
    step;
32. two ranks on the one card, spawned, through gloo (which does
    broadcast and all_reduce on CUDA tensors): one SGD step on 4 + 4 rows
    of a batch of 8 with dropout on against the one-process step: the
    loss, the averaged gradients (phase 12b's rule, with the ReLU and
    max-pool decisions each rank took otherwise counted) and the running
    statistics; E and F three times on each rank;
33. the same two ranks serve phase 5's bf16 piano batch (64 clips a rank)
    and phase 8's guitar batch (32 a rank) through the pipelines' ``mesh``:
    every rank's notes equal the one-process notes under PARITY.md's rule
    (and the tablature rule); A once and B three times, D once, a rank; each
    rank's peak memory;
34. over NCCL at world size 1, each bit for bit its unsharded counterpart:
    ``framify_time_sharded``, TabCNN on a time-sharded track,
    ``shard_params_tp`` then an O&F2 forward through B, ``pipeline_apply``
    at S = 1. Times of phases 32-33 are two processes sharing one card,
    not scaling figures;
35. kernels A-F and the conv epilogue through their custom ops
    (``torch.ops.amt_tools_tpu_torch``; B, E and F on their plain, masked
    and carried schemas, and grouped, plain and masked), each
    bit for bit its wrapper with one launch counted a call, then
    ``torch.library.opcheck`` of each on the card at small shapes;
36. phase 5's bf16 piano pipeline exported (``export.save_serving``, a
    symbolic batch) at 128 x 60 s and loaded: notes equal to the live
    pipeline's, A once and B three times a call, audio-s per wall-s in
    turns with the live pipeline; the same artifact at 8 clips; a float32
    artifact loaded with TF32 on (loading turns it off), its logits program
    bit for bit the live pipeline's; the int8-static artifact's notes
    equal to the live int8 pipeline's;
37. OnsetsFramesOnline complexity 3 exported as a streaming artifact: its
    maps over phase 25's 313 frames bit for bit ``run_online_stateful``'s,
    B from the carry twice a frame, ms a frame in turns with it;
38. ``profiling.mfu`` of the bf16 piano batch and of the float32 O&F2
    training step (FLOPs by op, kernels A-F through their ops' formulas),
    and the port's example scripts on the card: ``transcribe_file`` on a written WAV,
    ``export_artifact`` at 2 s clips, ``synthetic_demo`` and
    ``synthetic_tabcnn`` at 2 iterations;
39. grouped kernels B, E and F (``ops.lstm_kernel.lstm_scan_grouped``,
    ``lstm_scan_residuals_grouped``, ``lstm_bptt_grouped``: one launch for
    G sequences, the groups from ``reverse_from`` on reversed; one
    sequence is one group) at the
    recipe shapes (G = 4, 8 x 625, H = 256), float32 and bf16, against G
    per-stream launches of the ungrouped ops (bit for bit expected; else
    held to the plain tolerances) and their plain versions; masked in bf16;
    grouped E and F at the velocity plan (G = 6, float32); grouped B at
    the fused serving shape (G = 4, 64 x 1876, bf16) against its
    per-stream launches and its plain version; each timed beside its G
    per-stream launches, its plain version and the sum of the per-stream
    cuDNN ``nn.LSTM`` calls; the cluster plans of G = 4 and G = 6;
40. fused piano serving: phase 5's pipeline and its twin
    ``OnsetsFrames2(fused_heads=True, fused_lms=True)`` on the same weights
    (``fuse_acoustic_variables``, ``fuse_lm_variables``), 3 requests of
    ``FUSED_SERVING_CLIPS`` x 60 s: A once and grouped B twice a
    dispatch; bf16 logits within ``LAYOUT_TOL`` of the per-head ones and
    notes equal under phase 33's rule, with that bound as its band (the
    two run other cuDNN kernels channels-last); audio-s per wall-s in
    turns and peak memory a batch; a float32 pair at 8 clips within
    ``LOGIT_TOL``;
41. fused O&F2 training, float32, 8 x 625, Adam: the first step (no
    dropout) against the per-head step, losses within ``LOSS_TOL`` and
    gradients (mapped back by the converters) under phase 12b's rule;
    then ``train()`` in turns with the per-head model and with
    ``fused_lms`` alone (per-head acoustic stacks): E and F three times a
    step per-head and twice with either fused layout, every launch
    grouped; steps/s; E + F device ms a step;
42. the fused velocity model (G = 6): grouped E and F twice a step, its
    cluster plans, steps/s in turns with the per-head model;
43. phase 40's fused pipeline exported (``export.save_serving``, a
    symbolic batch) and loaded: notes equal to the live fused pipeline's,
    A once and grouped B twice a call; the same artifact at 8
    clips;
44. masked and carried kernels E and F (per-row lengths, a float32 carry)
    at the training shape, 8 x 625, H = 256, both directions, float32 and
    bf16, lengths spread over 313-625 with one row at 0 and one at 625, the
    carry a seeded random (c0, h0) and final-carry gradient: against their
    plain versions with phase 10's and phase 11's tolerances (the initial
    carry's gradient by ``CARRY_GRAD_TOL``), padded steps writing 0,
    lengths = T and a zero carry bit for bit the unmasked launches, the
    differentiable carried recurrence in chunks of 125 frames against one
    call, grouped masked E and F at G = 4 bit for bit four per-stream
    masked launches; each timed beside the unmasked launch, its plain
    version and cuDNN ``nn.LSTM`` (forward or backward) on a
    ``pack_padded_sequence`` batch (masked) or from ``(h0, c0)``
    (carried), the bound over this run's valid row-steps;
45. masked training at full width: O&F2 complexity 3, float32, Adam 6e-4,
    on SyntheticPiano tracks (HTK mels by kernel A) cut to 313-625 frames
    and padded to 625 with ``KEY_VALID_FRAMES``: lengths = T bit for bit
    the unmasked ``make_train_step`` step; ``train()`` 30 steps on one
    batch with masked E and F three times a step and B never, the loss
    falling; steps/s in turns with the unmasked batch; the first masked
    step (dropout off, SGD) against the CPU under phase 12b's rule; the
    same with ``fused_lms`` (grouped masked E and F twice a step); one bf16 step with a finite loss;
46. carried training: ``OnsetsFramesOnline`` complexity 3 on 8 x 625
    frames in 5 chunks that thread the carries, the gradient through the
    chain: carried E and F twice a chunk, ms a step; its onset language
    model over the chunks against one whole-sequence call (outputs bit for
    bit, gradients within ``CHUNK_LM_GRAD_TOL``) and against the CPU's
    plain versions;
47. the port's side of the convergence differential
    (``tests/test_torch_convergence.py``): O&F complexity 2, 500 Adam steps
    on the card from the port's seeded weights, then ``validate`` (masked
    B); frame and note F1 within 0.04 and 0.10 of the JAX package's run
    (``CONVERGENCE_JAX_F1``, which the slow test checks);
48. the conv blocks' eval epilogue (``ops/conv_epilogue.py``, a kernel of
    the port with no TPU counterpart) at the piano serving shape, 128 clips
    x 1876 frames, in NCHW and in the serving path's channels-last layout,
    for each block shape of an acoustic stack (48 channels x 229 bins
    unpooled and pooled, 96 x 114 pooled): bit for bit its plain version,
    timed beside it and its byte bound;
49. kernel G (``ops/gru_kernel.py``, the grouped GRU scan of the
    High-resolution Piano Transcription model, a kernel of the port with no
    TPU counterpart) at the ``hpt-serve-bf16`` cell's shapes, 64 clips x
    6,001 frames, H = 256, bf16: the launch of the four stacks' first (or
    second) layers, 8 directions, and that of a conditioning BiGRU, 2; each
    against its plain version (the card tests' bf16 bound), timed beside it,
    its bound and cuDNN ``torch.nn.GRU`` over the same recurrences (one
    bidirectional layer a stack, input projection included), with its
    cluster launch. ``python3 chip_smoke.py gru`` runs it alone, after the
    build;
50. one bf16 forward of the High-resolution Piano Transcription model
    (``models.RegressCRNN`` as ``serving.RegressionPipeline`` runs it,
    features included) over the ``hpt-serve-bf16`` cell's batch, 64
    rendered clips of 60 s: with the counters zeroed just before it, 4
    launches of kernel G, 36 of the conv epilogue and no ``torch.nn.GRU``
    call; then the epilogue's bias-free routes at that forward's
    channels-last block shapes (first convs unpooled, second convs
    average-pooled) bit for bit its plain version, timed beside its byte
    bound. ``python3 chip_smoke.py hpt`` runs phases 49 and 50 alone, after
    the build;
51. the O&F stacks' layout (``ops.layers.stack_layout``): channels-last,
    counted once a stack, against the same forward kept NCHW, in turns, on
    the serving pipelines' features: one bf16 acoustic stack of O&F2 at 128
    x 1876 frames; the fused stack and the fused and per-head O&F2 forwards
    at ``FUSED_SERVING_CLIPS`` x 1876; each's outputs within ``LAYOUT_TOL``
    of NCHW's, its ms a call and its device ms in cuDNN's NCHW<->NHWC
    conversions; OnsetsFramesOnline's median ms a streamed frame over a 10 s
    track in both layouts. ``python3 chip_smoke.py layout`` runs phases 48
    and 51 alone, after the build;
52. the post-LN add-and-norm kernel: a bf16 forward of the published-width
    hft model (2 clips x 300 frames) launches it 20 times and its plain
    version never, each launch recorded by its shapes and counted by call;
    then at the hft-serve-bf16 cell's bf16 shapes (the frequency encoder's
    61,440 x 256 rows, the first decoder sum's 61,440 x 88 rows on 88
    shared queries, the decoder's, the time encoder's 42,240 x 128), each
    within ``ADD_NORM_ROW_TOL`` of a row's largest output and one bf16 ulp
    of its plain version (PyTorch's add and ``F.layer_norm``), timed beside
    its byte bound and the plain version; float32 at a quarter of the
    frequency encoder's rows.
    ``python3 chip_smoke.py hft`` runs it alone, after the build;
9 and 13. one piano batch (bf16 and int8-static), one guitar batch, one
   float32 training step of O&F2, of O&F2 with the velocity head, of O&F
   online and of TabCNN, 10 streamed frames, a fused piano batch and a
   fused O&F2 training step, and one step each of the of_2
   and tabcnn recipes with their batch loaded from the corpora inside the
   range (the loader's host time in the busy share), and one masked O&F2
   training step (phase 45), under one
   ``profiling.trace`` run (``torch.profiler``; its TensorBoard trace must
   name kernels A and B): the device
   time by kernel and the busy share of each, whose path's kernels must
   appear in it.

Phases 22-25, 26-30 and 44-47 each end with a JSON line of their rates. The last
lines are phase 50's ``hpt_forward`` JSON line (its launches, the warm
forward's time and the bias-free epilogue's times beside their bounds,
summed over a forward's 32 conv launches), phase 51's ``stack_layout``
JSON line, the card, one ``kernels`` JSON line (A to F; A with its launches
on MAESTRO with the cache cold and warm and in the file stream; B with its
masked launches of phases 19 and 27, phase 18's times, its carried
launches of phases 25 and 29 and phase 25a's times; C with its launches in
the TabCNN recipes, cold and warm, and in the HCQT; E and F with their
launches a velocity step and a MAESTRO step; A, B and D with their
launches a rank in phase 33, E and F a step in phases 31 and 32; every
kernel with its op and its launches under opcheck, A and B with their
launches in the serving artifact, B in the streaming artifact, A, C, E and
F in the examples; B, E and F with their grouped launch's times (phase 39)
and its launches in the fused phases 40-43; E and F with their masked,
carried and grouped masked launches a step, times and bounds, phases
44-46; the conv epilogue with its phase 48 channels-last times, summed
over a batch's nine launches, and its launches in phase 5; kernel G with its phase 49
times, summed over a batch's four launches; the add-and-norm kernel with
its phase 52 times, each call's weighted by its launches counted in an
hFT forward), and one JSON
line
``{"ok": true, "device": {...}}``.
Every bound comes from the kernel's cost function (``stft_kernel.cost``,
``lstm_kernel.scan_cost`` and ``bptt_cost``, ``cqt_kernel.cost``,
``conv_epilogue.cost``, ``gru_kernel.gru_scan_cost``,
``add_layer_norm.cost``), the FLOP formula of its op.
"""

import copy
import json
import os
import subprocess
import sys
import time
import warnings

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
POWER_DB_TOL = 1e-4      # SignalPower in dB: float32 sums of squares
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
# Int8-static logits, card vs CPU (phase 16): the features differ by
# float32 sums in another order, so an activation at a rounding boundary
# may quantize one step apart on the two devices, which moves the logits
# further than float sums do (tests/test_torch_int8_pipeline.py: 1e-2 and
# 2e-4 on the mean between the port and the JAX package)
INT8_LOGIT_TOL = 1e-2
INT8_LOGIT_MEAN_TOL = 2e-4
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
# Bucketed validation (phases 18-21): whole tracks padded to multiples of
# 128 frames (amt_tools_tpu/train.py:263), a 120 s track to 3840
VAL_BUCKET = 128
VAL_BATCH = 8
VAL_DURATIONS = (20.0, 50.0, 80.0, 120.0)   # x4 piano tracks each
GUITAR_VAL_DURATIONS = (10.0, 15.0, 20.0, 25.0, 30.0, 35.0, 40.0, 45.0)
ONLINE_SECONDS = 5.0
TRAIN_VAL_TRACKS = 4
# Phases 22-25: the velocity head, remat, the TabCNN recipe, streaming
VELOCITY_RANGE = (0.3, 1.0)   # examples/papers/synthetic_demo.py stress
REMAT_STEPS = 5
TAB_TRACKS = 32               # examples/papers/synthetic_tabcnn.py
TAB_TEST_TRACKS = 6
TAB_SECONDS = 8.0
TAB_FRAMES = 128
TAB_ITERATIONS = 2            # passes, each of 32 / 8 steps
CARRY_CHUNK = 64              # frames a launch in the chunked carried check
STREAM_SECONDS = 10.0
RANGE_GAP_S = 0.05  # idle between profiled batches
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

    from amt_tools_tpu_torch.ops.conv_epilogue import conv_epilogue
    from amt_tools_tpu_torch.ops.cqt_kernel import cqt_mag, cqt_mag_grouped
    from amt_tools_tpu_torch.ops.lstm_kernel import (lstm_bptt, lstm_scan,
                                                     lstm_scan_residuals)
    from amt_tools_tpu_torch.ops.stft_kernel import stft_power

    return {'stft_power': stft_power, 'lstm_scan': lstm_scan,
            'cqt_mag': cqt_mag, 'cqt_mag_grouped': cqt_mag_grouped,
            'lstm_scan_residuals': lstm_scan_residuals,
            'lstm_bptt': lstm_bptt, 'conv_epilogue': conv_epilogue}


def route_counters():
    """(kernel, route, attribute) of every counter of a kernel's route:
    kernel A's FFT route, the masked launches (with lengths), carried ones
    (from a carry) and grouped ones (more than one group) of kernels B, E
    and F, kernels C and D by ``exact``."""

    from amt_tools_tpu_torch.ops.cqt_kernel import ROUTES

    return ([('stft_power', 'fft', 'fft_launches')] +
            [(name, route, f'{route}_launches')
             for name in ('lstm_scan', 'lstm_scan_residuals', 'lstm_bptt')
             for route in ('masked', 'carried', 'grouped')] +
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
    ``stft_power_fft`` (kernel A's FFT route), ``lstm_scan_masked`` (kernel
    B with lengths), ``lstm_scan_carried`` (kernel B from a carry),
    ``lstm_scan_grouped`` (kernel B over more than one group; every launch
    of B, grouped or not, counts in ``lstm_scan``), ``cqt_mag_bf16x3`` and
    the other routes of kernels C and D."""

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
    from amt_tools_tpu_torch.ops.stft_kernel import cost as stft_cost
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
    # and the twiddle table, and writes the power; the least work that
    # gives STFT power is a real FFT of each windowed frame (the kernel's
    # cost function, also its op's FLOP formula)
    table_bytes = fft_twiddles(N_FFT).nbytes
    fft_flops, num_bytes = stft_cost(batch, num_samples, N_FFT, HOP, n_bins)
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
    from amt_tools_tpu_torch.ops.lstm_kernel import (lstm_scan,
                                                     lstm_scan_plain,
                                                     scan_cost)

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

            flops, num_bytes = scan_cost(BATCH, frames, HIDDEN, dtype)
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
        lstm_scan, lstm_scan_residuals, lstm_scan_residuals_plain, scan_cost)

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

            flops, num_bytes = scan_cost(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN,
                                         dtype, residuals=True)
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
        _shift_prev, bptt_cost, lstm_bptt, lstm_bptt_plain, lstm_scan_grad,
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

            flops, num_bytes = bptt_cost(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN,
                                         dtype)
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

    from amt_tools_tpu_torch.ops.layers import stack_layout

    reset_launches()
    stacks = stack_layout.channels_last
    results, elapsed = serve_requests(pipeline, requests)
    launches = read_launches()
    stacks = stack_layout.channels_last - stacks

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
    require(launches['lstm_scan'] >= 3 * REQUESTS and
            launches['lstm_scan_grouped'] == launches['lstm_scan'],
            'the LSTM kernel did not run three times per dispatch, each '
            'launch both directions of a BiLSTM')
    require(launches['conv_epilogue'] == 9 * REQUESTS,
            'the conv epilogue did not run once a conv block of the three '
            'acoustic stacks per dispatch')
    require(stacks == 3 * REQUESTS,
            f'{stacks} acoustic stacks ran channels-last in {REQUESTS} '
            f'dispatches, not three a dispatch')
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

    # The one-process reference of phase 33: the weights, the first
    # request's notes and its logits
    reference = {'state': {k: v.cpu() for k, v in model.state_dict().items()},
                 'notes': results[0],
                 'raw': piano_logits(model, mel, requests[0])}

    return (launches, (f'piano batch of {BATCH} clips',
                       lambda: pipeline(requests[0]),
                       ('stft_power_fft_kernel', 'lstm_scan_kernel')),
            reference, (pipeline, requests))


def check_conv_epilogue():
    """Phase 48: the conv blocks' eval epilogue (``ops/conv_epilogue.py``)
    at the piano serving shape, in NCHW and in the serving path's
    channels-last layout (the main path): each of the three block shapes of an
    acoustic stack (48 channels at 229 bins unpooled and pooled, 96 at 114
    pooled) bit for bit its plain version on the card, timed beside it and
    its byte bound."""

    import torch

    from amt_tools_tpu_torch.ops.conv_epilogue import (conv_epilogue,
                                                       conv_epilogue_plain,
                                                       cost)

    device = torch.device('cuda')
    gen = torch.Generator(device=device).manual_seed(48)
    frames = 1 + int(CLIP_SECONDS * SAMPLE_RATE) // HOP
    blocks = []
    for layout in ('nchw', 'channels_last'):
        for channels, width, pool in ((48, N_MELS, False), (48, N_MELS, True),
                                      (96, N_MELS // 2, True)):
            x = torch.randn(BATCH, channels, frames, width, generator=gen,
                            device=device, dtype=torch.bfloat16)
            if layout == 'channels_last':
                x = x.contiguous(memory_format=torch.channels_last)
            var = torch.rand(channels, generator=gen, device=device) + 0.5
            vectors = (
                0.1 * torch.randn(channels, generator=gen, device=device,
                                  dtype=torch.bfloat16),
                0.3 * torch.randn(channels, generator=gen, device=device),
                torch.rsqrt(var + 1e-5) * torch.randn(
                    channels, generator=gen, device=device),
                0.2 * torch.randn(channels, generator=gen, device=device))

            got = conv_epilogue(x, *vectors, pool)
            want = conv_epilogue_plain(x, *vectors, pool)
            require(got.stride() == want.stride() and
                    torch.equal(got.view(torch.int16),
                                want.view(torch.int16)),
                    f'the conv epilogue at {tuple(x.shape)} {layout}, pool '
                    f'{pool}, differs from its plain version')
            del got, want
            ms = time_ms(lambda: conv_epilogue(x, *vectors, pool), reps=20)
            plain_ms = time_ms(
                lambda: conv_epilogue_plain(x, *vectors, pool), reps=3)
            _, num_bytes = cost(x.shape, x.dtype, pool)
            bound, bound_by = bound_ms(num_bytes, 0.0, PEAK_BF16_FLOPS)
            log(f'conv_epilogue at {tuple(x.shape)} bf16 {layout}, pool '
                f'{pool}: bit for bit the plain version; kernel {ms:.3f} ms, '
                f'plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({bound_by}: '
                f'{num_bytes / 1e9:.3f} GB), {100 * bound / ms:.1f}% of it')
            blocks.append({'layout': layout, 'shape': list(x.shape),
                           'pool': pool, 'ms': ms, 'plain_ms': plain_ms,
                           'bound_ms': bound})
            del x
            torch.cuda.empty_cache()

    # A piano batch runs each channels-last block shape once in each of the
    # three stacks: the serving path runs the stacks channels-last
    # (ops.layers.stack_layout, phase 51)
    main = [b for b in blocks if b['layout'] == 'channels_last']
    return {'name': 'conv_epilogue', 'route': 'cuda',
            'source': 'amt_tools_tpu_torch/csrc/conv_epilogue.cu',
            'replaces': None,
            'ms': 3 * sum(b['ms'] for b in main),
            'plain_ms': 3 * sum(b['plain_ms'] for b in main),
            'bound_ms': 3 * sum(b['bound_ms'] for b in main),
            'bound_by': 'bytes', 'library_ms': None, 'blocks': blocks,
            'design': 'a port kernel with no TPU counterpart: the conv '
                      'bias, eval BatchNorm, ReLU and (1, 2) max-pool of an '
                      'acoustic block in one pass over the bias-free conv '
                      'output, in its NCHW or channels-last layout'}


# The O&F stacks' layout (phase 51): ops.layers.stack_layout puts an eval
# stack on the card channels-last; its outputs against the same forward
# kept NCHW, max over the largest and mean over the mean magnitude (the
# card tests' LAYOUT_LOGIT_TOL: other cuDNN algorithms, whose float32 sums
# round to bf16 apart near a rounding boundary)
LAYOUT_TOL = (2.0 ** -5, 2.0 ** -9)
LAYOUT_REPS = 5
CUDNN_TRANSPOSES = ('nchwToNhwc', 'nhwcToNchw')


class StacksNCHW:
    """Within it the O&F stacks keep the layout their features arrive in:
    ``ops.layers.stack_layout`` as the stacks called it before the rule."""

    def __enter__(self):
        from amt_tools_tpu_torch.models import onsetsframes

        self.rule = onsetsframes.stack_layout
        onsetsframes.stack_layout = lambda x, *args: x

    def __exit__(self, *exc):
        from amt_tools_tpu_torch.models import onsetsframes

        onsetsframes.stack_layout = self.rule


def layout_gap(got, want, label):
    """Require ``got`` within ``LAYOUT_TOL`` of ``want``; the two gaps."""

    diff = (got.float() - want.float()).abs()
    worst = diff.max().item() / want.abs().max().item()
    mean = diff.mean().item() / want.abs().mean().item()
    require(worst <= LAYOUT_TOL[0] and mean <= LAYOUT_TOL[1],
            f'{label}: channels-last off NCHW by {worst:.3g} of the largest '
            f'and {mean:.3g} of the mean magnitude (tolerance {LAYOUT_TOL})')

    return worst, mean


def transposes_ms(fn):
    """Device ms of one call of ``fn`` in cuDNN's NCHW<->NHWC conversions,
    and in all its kernels, by ``torch.profiler``."""

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in events) / 1e3
    converting = sum(e.time_range.elapsed_us() for e in events
                     if any(k in e.name for k in CUDNN_TRANSPOSES)) / 1e3

    return converting, total


def layout_turns(label, fn, counted_per_call):
    """``fn`` channels-last and NCHW in turns (channels-last, NCHW, NCHW,
    channels-last), ``LAYOUT_REPS`` calls a turn, by CUDA events: the ms a
    call of each, the rule's count a channels-last call, the outputs' gaps
    and the conversions' device ms a call of each."""

    import torch

    from amt_tools_tpu_torch.ops import layers

    with torch.inference_mode():
        counted = layers.stack_layout.channels_last
        got = fn()
        require(layers.stack_layout.channels_last ==
                counted + counted_per_call,
                f'{label}: the rule counted '
                f'{layers.stack_layout.channels_last - counted} channels-last '
                f'stacks a call, not {counted_per_call}')
        with StacksNCHW():
            want = fn()
            counted = layers.stack_layout.channels_last
            fn()
            require(layers.stack_layout.channels_last == counted,
                    f'{label}: a stack kept NCHW was counted channels-last')
        outputs = (zip(got.values(), want.values()) if isinstance(got, dict)
                   else [(got, want)])
        gaps = [layout_gap(g, w, label) for g, w in outputs]
        del got, want

        times = {'channels_last': [], 'nchw': []}
        for turn in ('channels_last', 'nchw', 'nchw', 'channels_last'):
            if turn == 'nchw':
                with StacksNCHW():
                    times[turn].append(time_ms(fn, LAYOUT_REPS))
            else:
                times[turn].append(time_ms(fn, LAYOUT_REPS))
        converting = {'channels_last': transposes_ms(fn)}
        with StacksNCHW():
            converting['nchw'] = transposes_ms(fn)
    torch.cuda.empty_cache()

    ms = {turn: float(np.median(t)) for turn, t in times.items()}
    log(f'{label}: channels-last {times["channels_last"]} ms, NCHW '
        f'{times["nchw"]} ms a call ({ms["nchw"] / ms["channels_last"]:.3f}x)'
        f'; cuDNN NCHW<->NHWC conversions of all device time, channels-last '
        f'{converting["channels_last"][0]:.3f} of '
        f'{converting["channels_last"][1]:.3f} ms, NCHW '
        f'{converting["nchw"][0]:.3f} of {converting["nchw"][1]:.3f} ms; '
        f'outputs off NCHW by at most '
        f'{max(g[0] for g in gaps):.3g} of the largest, '
        f'{max(g[1] for g in gaps):.3g} of the mean magnitude')

    return {'ms': ms, 'turns_ms': times,
            'transposes_ms': {k: v[0] for k, v in converting.items()},
            'device_ms': {k: v[1] for k, v in converting.items()},
            'max_gap': max(g[0] for g in gaps),
            'mean_gap': max(g[1] for g in gaps)}


def check_stack_layout(card):
    """Phase 51: the O&F stacks' layout (``ops.layers.stack_layout``). An
    eval forward on the card runs each stack channels-last, counted once a
    stack, where the parent ran it as cuDNN found it, NCHW. In turns with
    the same forward kept NCHW, on the features as the serving pipelines
    hand them over (``pre_proc``'s transposed view), bf16, seeded random
    weights and statistics: one acoustic stack of O&F2 at complexity 3 at
    the piano batch, 128 clips x 1876 frames; the fused stack
    (``GroupedAcousticModel``, three heads) and the whole fused and
    per-head O&F2 forwards at phase 40's ``FUSED_SERVING_CLIPS``; then
    OnsetsFramesOnline (float32) through ``run_online_stateful`` over a
    10 s track, ms a frame as phase 25 reads it. Outputs within
    ``LAYOUT_TOL`` of the NCHW forward's; the device ms of cuDNN's
    NCHW<->NHWC conversions in one call of each."""

    import torch
    import torch.nn.functional as F

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.inference import run_online_stateful
    from amt_tools_tpu_torch.models import OnsetsFramesOnline
    from amt_tools_tpu_torch.ops import layers

    def settle(model):
        """Running statistics and conv biases away from their initial
        values, as a trained model's."""

        gen = torch.Generator().manual_seed(51)
        with torch.no_grad():
            for module in model.modules():
                if isinstance(module, layers.BatchNorm):
                    module.running_mean.normal_(0, 0.3, generator=gen)
                    module.running_var.uniform_(0.5, 1.5, generator=gen)
                    module.weight.normal_(1, 0.2, generator=gen)
                    module.bias.normal_(0, 0.2, generator=gen)
                if isinstance(module, torch.nn.Conv2d):
                    module.bias.normal_(0, 0.1, generator=gen)
        return model.cuda().eval()

    frames = 1 + int(CLIP_SECONDS * SAMPLE_RATE) // HOP
    gen = torch.Generator(device='cuda').manual_seed(51)
    per_head = settle(piano_model(torch.bfloat16, 51))
    fused = fused_twin(per_head).eval()
    readings = {}

    feats = torch.rand((BATCH, 1, N_MELS, frames), generator=gen,
                       device='cuda')
    x = per_head.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS]
    readings['stack'] = layout_turns(
        f'phase 51: one bf16 acoustic stack at {BATCH} x {frames}',
        lambda: per_head.pitch_am(x), 1)

    # Which of the channels-last stack's convs keep a conversion: each
    # alone on its channels-last bf16 input, bias-free as the stack runs it
    convs = {}
    with torch.inference_mode():
        y = x.permute(0, 3, 1, 2).to(torch.bfloat16,
                                     memory_format=torch.channels_last)
        for index, pool in enumerate((False, True, True)):
            weight = getattr(per_head.pitch_am,
                             f'Conv_{index}').weight.to(torch.bfloat16)
            convs[f'Conv_{index}'] = transposes_ms(
                lambda: F.conv2d(y, weight, padding=1))[0]
            y = F.conv2d(y, weight, padding=1)
            if pool:
                y = F.max_pool2d(y, (1, 2), stride=(1, 2))
        del y
    log(f'phase 51: cuDNN NCHW<->NHWC ms in each conv of the channels-last '
        f'stack alone: {convs}')
    readings['stack']['conv_transposes_ms'] = convs
    del feats, x
    torch.cuda.empty_cache()

    clips = FUSED_SERVING_CLIPS
    x = per_head.pre_proc({tools.KEY_FEATS: torch.rand(
        (clips, 1, N_MELS, frames), generator=gen,
        device='cuda')})[tools.KEY_FEATS]
    readings['fused_stack'] = layout_turns(
        f'phase 51: the fused bf16 stack (three heads) at {clips} x {frames}',
        lambda: fused.grouped_am(x), 1)
    readings['fused_forward'] = layout_turns(
        f'phase 51: the fused bf16 O&F2 forward at {clips} x {frames}',
        lambda: fused(x), 1)
    readings['per_head_forward'] = layout_turns(
        f'phase 51: the per-head bf16 O&F2 forward at {clips} x {frames}',
        lambda: per_head(x), 3)
    del per_head, fused, x
    torch.cuda.empty_cache()

    # Streaming: one frame a forward, through the V1 heads' two stacks
    profile = tools.PianoProfile()
    mel = MelSpec(n_mels=N_MELS)
    online = OnsetsFramesOnline(dim_in=N_MELS, profile=profile,
                                model_complexity=3,
                                generator=torch.Generator().manual_seed(25))
    audio = render_clips(profile, 1, STREAM_SECONDS)[0]
    track = {tools.KEY_FEATS: mel.process_audio(audio),
             tools.KEY_TIMES: mel.get_times(audio), tools.KEY_TRACK: 'stream'}
    streamed = track[tools.KEY_FEATS].shape[-1]
    stacks = len(online.head_names)

    def per_frame_ms():
        timer = FrameTimer()
        torch.cuda.synchronize()
        start = time.perf_counter()
        maps = run_online_stateful(dict(track), online, timer)
        return maps, np.diff([start] + timer.stamps) * 1e3

    stream = {'channels_last': [], 'nchw': []}
    maps = {}
    with tools.exact_fp32():
        run_online_stateful(dict(track), online)  # warm-up
        with StacksNCHW():
            run_online_stateful(dict(track), online)
        for turn in ('channels_last', 'nchw', 'nchw', 'channels_last'):
            counted = layers.stack_layout.channels_last
            if turn == 'nchw':
                with StacksNCHW():
                    maps[turn], ms = per_frame_ms()
            else:
                maps[turn], ms = per_frame_ms()
            require(layers.stack_layout.channels_last - counted ==
                    (stacks * streamed if turn == 'channels_last' else 0),
                    f'phase 51: streaming counted '
                    f'{layers.stack_layout.channels_last - counted} '
                    f'channels-last stacks over {streamed} frames')
            stream[turn].append(float(np.median(ms)))
    differ = sum(int((maps['channels_last'][k] != maps['nchw'][k]).sum())
                 for k in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS))
    log(f'phase 51: OnsetsFramesOnline float32 over {streamed} frames, '
        f'median ms a frame in turns: channels-last '
        f'{stream["channels_last"]}, NCHW {stream["nchw"]} ({card}); '
        f'{differ} map cells differ between the layouts')
    readings['streaming_median_ms'] = stream
    readings['streaming_map_cells_differ'] = differ

    return readings


# Kernel G at the hpt-serve-bf16 cell's shapes (phase 49)
GRU_BATCH = 64
GRU_FRAMES = 6001
GRU_HIDDEN = 256


def check_gru_scan():
    """Phase 49: kernel G at the hpt-serve-bf16 cell's shapes, bf16: a
    forward's launches of 8 directions (the stacks' first or second GRU
    layers) and of 2 (a conditioning BiGRU), each against its plain version,
    timed beside it, its bound and cuDNN ``nn.GRU`` over the same
    recurrences."""

    import torch

    from amt_tools_tpu_torch.ops.gru_kernel import (gru_launch_plan,
                                                    gru_scan_cost,
                                                    gru_scan_grouped,
                                                    gru_scan_plain)

    device = torch.device('cuda')
    dtype = torch.bfloat16
    hidden = GRU_HIDDEN
    gen = torch.Generator(device=device).manual_seed(49)
    launches = []
    for groups, dim_in in ((8, 768), (2, 176)):
        xw = (0.5 * torch.randn(groups, GRU_BATCH, GRU_FRAMES, 3 * hidden,
                                generator=gen, device=device)).to(dtype)
        bound = hidden ** -0.5
        w_h = ((2 * torch.rand(groups, hidden, 3 * hidden, generator=gen,
                               device=device) - 1) * bound).to(dtype)
        b_hn = (2 * torch.rand(groups, hidden, generator=gen,
                               device=device) - 1) * bound
        reverse_from = groups // 2

        got = gru_scan_grouped(xw, w_h, b_hn, reverse_from).float()
        start = time.perf_counter()
        want = gru_scan_plain(xw, w_h, b_hn, reverse_from).float()
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - start)
        err = (got - want).abs()
        worst, mean = float(err.max()), float(err.mean())
        require(worst <= 1e-2 and mean <= 1e-4,
                f'kernel G at G = {groups} differs from its plain version: '
                f'max {worst:.3g}, mean {mean:.3g}')
        del got, want, err

        ms = time_ms(lambda: gru_scan_grouped(xw, w_h, b_hn, reverse_from),
                     reps=3)
        flops, num_bytes = gru_scan_cost(GRU_BATCH, GRU_FRAMES, hidden,
                                         dtype, groups)
        least, bound_by = bound_ms(num_bytes, flops, PEAK_BF16_FLOPS)
        plan = gru_launch_plan(GRU_BATCH, hidden, dtype, device, groups)
        del xw, w_h, b_hn
        torch.cuda.empty_cache()

        # The library over the same recurrences: one bidirectional layer a
        # BiGRU of the launch, its input projection included
        gru = torch.nn.GRU(dim_in, hidden, batch_first=True,
                           bidirectional=True).to(device=device, dtype=dtype)
        x = torch.randn(GRU_BATCH, GRU_FRAMES, dim_in, generator=gen,
                        device=device, dtype=dtype)
        with torch.no_grad():
            library_ms = (groups // 2) * time_ms(lambda: gru(x), reps=1)
        del gru, x
        torch.cuda.empty_cache()

        log(f'gru_scan_grouped at G = {groups} x {GRU_BATCH} x {GRU_FRAMES}, '
            f'H {hidden}, bf16: max {worst:.3g}, mean {mean:.3g} from the '
            f'plain version; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, '
            f'bound {least:.3f} ms ({bound_by}), cuDNN nn.GRU '
            f'{library_ms:.3f} ms; {plan["clusters"]} clusters of '
            f'{plan["rows"]} rows, {plan["active_clusters"]} resident, '
            f'{plan["waves"]} wave(s), {plan["smem_bytes"]} bytes of shared '
            f'memory a CTA')
        require(ms < library_ms, f'kernel G at G = {groups} is not faster '
                f'than cuDNN nn.GRU ({ms:.3f} against {library_ms:.3f} ms)')
        launches.append({'groups': groups, 'ms': ms, 'plain_ms': plain_ms,
                         'bound_ms': least, 'bound_by': bound_by,
                         'library_ms': library_ms, 'max_err': worst,
                         'mean_err': mean, 'plan': plan})

    # A forward of the hpt model: two launches of 8 directions, two of 2
    weights = (2, 2)
    return {'name': 'gru_scan_grouped', 'route': 'cuda',
            'source': 'amt_tools_tpu_torch/csrc/gru_scan.cu',
            'replaces': None,
            **{key: sum(w * launch[key] for w, launch in zip(weights,
                                                             launches))
               for key in ('ms', 'plain_ms', 'bound_ms', 'library_ms')},
            'bound_by': 'bytes', 'launches': launches,
            'design': 'a port kernel with no TPU counterpart: kernel B\'s '
                      'clusters of 8 CTAs for three gates, W_h resident, h '
                      'exchanged each step, the groups on blockIdx.y'}



# The hpt-serve-bf16 cell's batch (phase 50)
HPT_BATCH = 64
HPT_HOP = 160
HPT_WIDTHS = (48, 64, 96, 128)


def check_hpt_forward():
    """Phase 50: one bf16 forward of the High-resolution Piano Transcription
    model (``models.RegressCRNN``, seeded random weights) as
    ``serving.RegressionPipeline`` runs it, features included, over the
    hpt-serve-bf16 cell's batch (64 rendered clips of 60 s, 6,001 frames):
    with the counters zeroed just before it, kernel G runs 4 times, the
    conv epilogue 36 (two a ConvBlock, one a stack's ``fc5``) and
    ``torch.nn.GRU`` never. Then the epilogue's bias-free routes at that
    forward's channels-last block shapes (each block's first conv
    unpooled, its second average-pooled) bit for bit its plain version,
    timed beside its byte bound."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import RegressCRNN
    from amt_tools_tpu_torch.ops.conv_epilogue import (conv_epilogue,
                                                       conv_epilogue_plain,
                                                       cost)
    from amt_tools_tpu_torch.ops.gru_kernel import gru_scan_grouped
    from amt_tools_tpu_torch.serving import RegressionPipeline

    device = torch.device('cuda')
    profile = tools.PianoProfile()
    mel = MelSpec(sample_rate=SAMPLE_RATE, hop_length=HPT_HOP, n_mels=N_MELS,
                  n_fft=N_FFT, fmin=30, fmax=8000, absolute_db=True,
                  pad_mode='reflect')
    model = RegressCRNN(dim_in=N_MELS, profile=profile, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(50))
    pipeline = RegressionPipeline(model, mel, device=device)
    require(not any(isinstance(m, torch.nn.GRU)
                    for m in pipeline.model.modules()),
            'phase 50: the hpt model holds a torch.nn.GRU')
    audio = torch.from_numpy(render_clips(profile, HPT_BATCH,
                                          CLIP_SECONDS)).to(device)

    def forward():
        with torch.inference_mode():
            feats = pipeline.data_proc.process(audio)
            batch = pipeline.model.pre_proc({tools.KEY_FEATS: feats})
            return pipeline.model(batch[tools.KEY_FEATS])

    library_calls = []
    library_forward = torch.nn.GRU.forward

    def counted(self, *args, **kwargs):
        library_calls.append(type(self).__name__)
        return library_forward(self, *args, **kwargs)

    torch.nn.GRU.forward = counted
    try:
        gru_scan_grouped.launches = 0
        conv_epilogue.launches = 0
        out = forward()
        torch.cuda.synchronize()
        launches = {'gru_scan_grouped': gru_scan_grouped.launches,
                    'conv_epilogue': conv_epilogue.launches,
                    'nn.GRU': len(library_calls)}
    finally:
        torch.nn.GRU.forward = library_forward
    frames = out['frame'].shape[1]
    require(frames == 1 + int(CLIP_SECONDS * SAMPLE_RATE) // HPT_HOP,
            f'phase 50: the forward gave {frames} frames')
    require(all(bool(torch.isfinite(v).all()) for v in out.values()),
            'phase 50: the bf16 forward gave a logit that is not finite')
    require(launches == {'gru_scan_grouped': 4, 'conv_epilogue': 36,
                         'nn.GRU': 0},
            f'phase 50: a forward launched {launches}, not G 4 times, the '
            f'epilogue 36 and nn.GRU never')
    del out
    forward_ms = time_ms(forward, reps=2)
    log(f'phase 50: RegressCRNN bf16 forward at {HPT_BATCH} x {frames} '
        f'frames: {launches}; {forward_ms:.1f} ms warm, features included')
    del pipeline, model, audio
    torch.cuda.empty_cache()

    gen = torch.Generator(device=device).manual_seed(50)
    blocks = []
    width = N_MELS
    for channels in HPT_WIDTHS:
        for pool in (False, True):
            x = torch.randn(HPT_BATCH, channels, frames, width, generator=gen,
                            device=device, dtype=torch.bfloat16).contiguous(
                                memory_format=torch.channels_last)
            var = torch.rand(channels, generator=gen, device=device) + 0.5
            vectors = (
                None, 0.3 * torch.randn(channels, generator=gen,
                                        device=device),
                torch.rsqrt(var + 1e-5) * torch.randn(
                    channels, generator=gen, device=device),
                0.2 * torch.randn(channels, generator=gen, device=device))

            got = conv_epilogue(x, *vectors, pool, avg=True)
            want = conv_epilogue_plain(x, *vectors, pool, avg=True)
            require(got.stride() == want.stride() and
                    torch.equal(got.view(torch.int16),
                                want.view(torch.int16)),
                    f'phase 50: the bias-free epilogue at {tuple(x.shape)} '
                    f'channels-last, average pool {pool}, differs from its '
                    f'plain version')
            del got, want
            ms = time_ms(lambda: conv_epilogue(x, *vectors, pool, avg=True),
                         reps=10)
            _, num_bytes = cost(x.shape, x.dtype, pool, conv_bias=False)
            bound, _ = bound_ms(num_bytes, 0.0, PEAK_BF16_FLOPS)
            log(f'conv_epilogue at {tuple(x.shape)} bf16 channels-last, no '
                f'conv bias, average pool {pool}: bit for bit the plain '
                f'version; kernel {ms:.3f} ms, bound {bound:.3f} ms, '
                f'{100 * bound / ms:.1f}% of it')
            blocks.append({'shape': list(x.shape), 'avg_pool': pool,
                           'ms': ms, 'bound_ms': bound})
            del x
            torch.cuda.empty_cache()
        width //= 2

    # A forward runs each block shape once in each of the four stacks
    return {'phase': 50, 'launches': launches, 'forward_ms': forward_ms,
            'epilogue_ms': 4 * sum(b['ms'] for b in blocks),
            'epilogue_bound_ms': 4 * sum(b['bound_ms'] for b in blocks),
            'blocks': blocks}


# The hft-serve-bf16 cell's add-and-norm calls (phase 52): y's shape and
# the residual's. A forward's launches of each are counted on the card
# (``forward_add_norm_calls``), each launch matched to its call by y's
# trailing dims and whether the residual has y's rows
ADD_NORM_CALLS = (
    ('frequency encoder', (61440, 256, 256), (61440, 256, 256)),
    ('first decoder sum', (61440, 88, 256), (88, 256)),
    ('decoder', (61440, 88, 256), (61440, 88, 256)),
    ('time encoder', (42240, 128, 256), (42240, 128, 256)),
)


def forward_add_norm_calls():
    """Phase 52: the add-and-norm launches of one bf16 forward of the
    published-width hft model (2 clips x 300 frames) under inference mode,
    each recorded by its (y, residual) shapes and matched to its
    ``ADD_NORM_CALLS`` entry: {call name: launches}. Requires 20 launches,
    every one matched, and no plain call."""

    import collections

    import torch

    from amt_tools_tpu_torch.models import HFTransformer
    from amt_tools_tpu_torch.ops import add_layer_norm as aln
    from amt_tools_tpu_torch.ops import attention

    def call_of(y_shape, r_shape):
        full = len(r_shape) == len(y_shape)
        for name, cell_y, cell_r in ADD_NORM_CALLS:
            if (y_shape[1:] == cell_y[1:] and
                    full == (len(cell_r) == len(cell_y))):
                return name
        return None

    device = torch.device('cuda')
    model = HFTransformer(dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(52))
    model = model.to(device).eval()
    gen = torch.Generator(device=device).manual_seed(52)
    feats = -18.0 + 6.0 * torch.rand(2, 1, 256, 300, generator=gen,
                                     device=device)

    launched = []
    kernel = attention.add_layer_norm

    def spy(y, residual, *args):
        launched.append(call_of(tuple(y.shape), tuple(residual.shape)))
        return kernel(y, residual, *args)

    attention.add_layer_norm = spy
    aln.add_layer_norm.fused, aln.add_layer_norm.plain = 0, 0
    try:
        with torch.inference_mode():
            model(feats)
        torch.cuda.synchronize()
    finally:
        attention.add_layer_norm = kernel
    counts = (aln.add_layer_norm.fused, aln.add_layer_norm.plain)
    require(counts == (20, 0) and len(launched) == 20,
            f'phase 52: an hft forward launched the add-and-norm kernel '
            f'{counts[0]} times and its plain version {counts[1]} (20 and 0 '
            f'expected) over {len(launched)} calls')
    require(None not in launched, f'phase 52: an hft forward\'s add-and-'
            f'norm call matches none of the cell\'s shapes: {launched}')
    per_forward = collections.Counter(launched)
    log(f'add_layer_norm in an hft forward: 20 launches, 0 plain; '
        + ', '.join(f'{name} {per_forward[name]}'
                    for name, _, _ in ADD_NORM_CALLS))
    del model, feats
    torch.cuda.empty_cache()

    return dict(per_forward)


# The add-and-norm kernel against its plain version (phase 52): float32
# within 1e-6 of the row's largest output (float32 statistics in another
# order of sums); bf16 within that and one bf16 ulp of each output (each
# rounds once a float32 value that lies as far from the plain version's as a
# float32 output does, which near zero is many ulps of the output)
ADD_NORM_ROW_TOL = 1e-6


def add_norm_gaps(got, want):
    """The largest gap of the kernel's output from the plain version's over
    its bound (at most 1 passes), and over one bf16 ulp of the larger
    magnitude alone (bf16; None for float32), over chunks of rows."""

    import torch

    bf16 = got.dtype == torch.bfloat16
    got, want = got.view(-1, got.shape[-1]), want.view(-1, want.shape[-1])
    worst, ulps = 0.0, 0.0
    for start in range(0, got.shape[0], 1 << 20):
        a = got[start:start + (1 << 20)].float()
        b = want[start:start + (1 << 20)].float()
        gap = (a - b).abs()
        allowed = ADD_NORM_ROW_TOL * b.abs().amax(dim=1, keepdim=True)
        if bf16:
            _, exponent = torch.frexp(torch.maximum(a.abs(), b.abs())
                                      .clamp_min(1e-30))
            ulp = torch.ldexp(torch.ones_like(a), exponent - 8)
            ulps = max(ulps, float((gap / ulp).max()))
            allowed = allowed + ulp
        worst = max(worst, float((gap / allowed).max()))

    return worst, (ulps if bf16 else None)


def check_add_layer_norm():
    """Phase 52: the post-LN add-and-norm kernel (``ops/add_layer_norm.py``):
    its launches in an hft forward, counted by call
    (``forward_add_norm_calls``); at the hft-serve-bf16 cell's bf16 shapes
    (H 256), each within ``ADD_NORM_ROW_TOL`` of a row's largest output and
    one bf16 ulp of its plain version, timed beside its byte bound and the
    plain version; and float32 at a quarter of the frequency encoder's rows
    against its plain version, within ``ADD_NORM_ROW_TOL`` of each row's
    largest output. The totals of a forward weigh each call's times by its
    counted launches."""

    import torch

    from amt_tools_tpu_torch.ops.add_layer_norm import (add_layer_norm,
                                                        add_layer_norm_plain,
                                                        cost)

    device = torch.device('cuda')
    gen = torch.Generator(device=device).manual_seed(52)
    eps = 1e-5

    def inputs(y_shape, r_shape, dtype):
        y = torch.randn(y_shape, generator=gen, device=device, dtype=dtype)
        residual = torch.randn(r_shape, generator=gen, device=device,
                               dtype=dtype)
        weight = (1.0 + 0.1 * torch.randn(y_shape[-1], generator=gen,
                                          device=device)).to(dtype)
        bias = (0.1 * torch.randn(y_shape[-1], generator=gen,
                                  device=device)).to(dtype)
        return y.mul_(2.0).add_(0.5), residual.mul_(3.0).sub_(1.0), weight, \
            bias

    per_forward = forward_add_norm_calls()
    calls = []
    for name, y_shape, r_shape in ADD_NORM_CALLS:
        args = inputs(y_shape, r_shape, torch.bfloat16)
        launches = add_layer_norm.fused
        got = add_layer_norm(*args, eps)
        want = add_layer_norm_plain(*args, eps)
        require(add_layer_norm.fused == launches + 1,
                f'phase 52: add_layer_norm at {name} did not count its '
                f'launch')
        worst, ulps = add_norm_gaps(got, want)
        require(worst <= 1.0, f'phase 52: add_layer_norm at {name} '
                f'{y_shape} lies {worst:.3g} of its bound from its plain '
                f'version')
        del got, want
        torch.cuda.empty_cache()

        y, residual, weight, bias = args
        ms = time_ms(lambda: add_layer_norm(*args, eps), reps=20)
        # The plain version is PyTorch's add and F.layer_norm, so it is
        # also the library yardstick
        plain_ms = time_ms(lambda: add_layer_norm_plain(*args, eps), reps=5)
        rows = y.numel() // y.shape[-1]
        _, num_bytes = cost(rows, residual.numel() // y.shape[-1],
                            y.shape[-1], y.dtype)
        bound, bound_by = bound_ms(num_bytes, 0.0, PEAK_BF16_FLOPS)
        log(f'add_layer_norm at {name} {y_shape} + {r_shape} bf16: '
            f'{worst:.3g} of its bound from the plain version ({ulps:.3g} '
            f'bf16 ulps of an output at most); kernel '
            f'{ms:.3f} ms, plain (add + F.layer_norm) {plain_ms:.3f} ms, '
            f'bound {bound:.3f} ms ({bound_by}: '
            f'{num_bytes / 1e9:.3f} GB), {100 * bound / ms:.1f}% of it')
        calls.append({'call': name, 'shape': list(y_shape),
                      'residual': list(r_shape),
                      'per_forward': per_forward.get(name, 0),
                      'ms': ms, 'plain_ms': plain_ms,
                      'library_ms': plain_ms, 'bound_ms': bound,
                      'max_gap_of_bound': worst, 'max_ulps': ulps})
        del args, y, residual, weight, bias
        torch.cuda.empty_cache()

    name, y_shape, r_shape = ADD_NORM_CALLS[0]
    y_shape = (y_shape[0] // 4, *y_shape[1:])
    args = inputs(y_shape, y_shape, torch.float32)
    worst, _ = add_norm_gaps(add_layer_norm(*args, eps),
                             add_layer_norm_plain(*args, eps))
    require(worst <= 1.0, f'phase 52: float32 add_layer_norm at {y_shape} '
            f'lies {worst:.3g} of its bound from its plain version')
    log(f'add_layer_norm at {y_shape} float32: {worst:.3g} of its bound '
        f'({ADD_NORM_ROW_TOL:g} of a row\'s largest output) from the plain '
        f'version')
    del args
    torch.cuda.empty_cache()

    # A forward's 20 launches: each call's times by its counted launches
    return {'name': 'add_layer_norm', 'route': 'cuda',
            'source': 'amt_tools_tpu_torch/csrc/add_layer_norm.cu',
            'op': 'torch.ops.amt_tools_tpu_torch.add_layer_norm',
            'replaces': None,
            **{key: sum(c['per_forward'] * c[key] for c in calls)
               for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms')},
            'bound_by': 'bytes', 'calls': calls,
            'float32_max_gap_of_bound': worst,
            'design': 'a port kernel with no TPU counterpart: the residual '
                      'add and LayerNorm of a post-LN sublayer in one pass, '
                      'a warp a row, a block for every 8 rows, the '
                      'statistics by warp shuffles in float32'}


def piano_logits(model, mel, audio):
    """The bf16 multi-pitch and onset logits of an audio batch, on the
    host."""

    import torch

    from amt_tools_tpu_torch import tools

    with torch.inference_mode():
        feats = mel.process(audio)
        raw = model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])

    return {key: raw[key].cpu() for key in (tools.KEY_MULTIPITCH,
                                            tools.KEY_ONSETS)}


def tablature_logits(model, cqt, audio):
    """The bf16 tablature logits of an audio batch, on the host."""

    import torch

    from amt_tools_tpu_torch import tools

    with torch.inference_mode():
        feats = cqt.process(audio)
        raw = model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])

    return raw[tools.KEY_TABLATURE].cpu()


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


def profile_batches(batches, trace_dir):
    """Device time by kernel over one batch of each path.

    ``batches`` holds (label, run, kernel name fragments), ``run`` a
    callable that does one batch's work. All batches run in one
    ``torch.profiler`` session, after every kernel's library is loaded: a
    kernel whose module was loaded after an earlier session ended went
    missing from a later session's trace, and a second session in one
    process named none of the hand kernels. The session is
    ``profiling.trace`` (phase 38), whose TensorBoard trace in
    ``trace_dir`` must name kernels A and B. Each batch runs in its own
    ``record_function`` range, and a device event belongs to the range its
    start falls in (the profiler keeps host and device events on one
    clock), or within half the idle gap left between ranges of it: in one
    run the device clock stood far enough ahead of the host's to put the
    next range's first kernel into the range before. Each path's kernels
    must appear in its range.
    """

    import glob

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    from amt_tools_tpu_torch import profiling

    labels = [label for label, _, _ in batches]
    walls = {}
    with profiling.trace(trace_dir) as prof:
        for label, run, _ in batches:
            torch.cuda.synchronize()
            # An idle gap between the ranges, wider than any offset of the
            # device clock against the host's: a device event within half
            # of it outside its range still counts to that range
            time.sleep(RANGE_GAP_S)
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
        margin = RANGE_GAP_S / 2 * 1e6
        for e in events:
            if (e.device_type == DeviceType.CUDA and e.name not in labels and
                    span.start - margin <= e.time_range.start <=
                    span.end + margin):
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

    names = set()
    for path in glob.glob(os.path.join(trace_dir, '*.json')):
        with open(path) as handle:
            names |= {e.get('name', '') for e in json.load(handle).get(
                'traceEvents', []) if e.get('cat') == 'kernel'}
    for kernel in ('stft_power', 'lstm_scan'):
        require(any(kernel in name for name in names),
                f'the trace of profiling.trace does not name {kernel}')
    log(f'profiling.trace of the session wrote its TensorBoard trace: '
        f'{len(names)} kernel names, A and B among them')


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


def train_run(model, loader, iterations, label, log_dir=None, checkpoints=0,
              recurrences=3):
    """One ``train()`` run on the card with fresh launch counts: E and F
    ``recurrences`` times a step (three for O&F2, one launch a BiLSTM; four
    with the velocity head; two for O&F online's two LSTMs), B never; every loss finite. Returns (result,
    launches, steps per second)."""

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
    require(launches['lstm_scan_residuals'] == recurrences * steps and
            launches['lstm_bptt'] == recurrences * steps,
            f'{label}: kernels E and F did not run {recurrences} times a '
            f'step')
    require(launches['lstm_scan'] == 0,
            f'{label}: kernel B ran inside a training step')
    require(launches['conv_epilogue'] == 0,
            f'{label}: the eval conv epilogue ran inside a training step')
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

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2

    rng = np.random.RandomState(seed)
    batch = {
        tools.KEY_FEATS: rng.rand(2, 1, N_MELS, 128).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(2, 88, 128) < 0.05).astype(
            np.float32),
    }
    model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                          model_complexity=2, dropout=False,
                          generator=torch.Generator().manual_seed(seed + 1))

    return step_both(model, batch)


def step_both(model, batch):
    """One float32 ``run_on_batch(train=True)`` and SGD step of ``model``
    on ``batch`` (numpy arrays) on the CPU and on the card: losses,
    gradients, state after the step and pre-ReLU values, by device."""

    import copy

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import run_on_batch

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
    ``TRAIN_CHECK_SEEDS``, the card (kernels) vs the CPU (plain versions),
    by :func:`compare_step`."""

    for seed in TRAIN_CHECK_SEEDS:
        compare_step(f'seed {seed}', *train_step_both(seed))


def compare_step(label, cpu, gpu):
    """A training step on the card against the CPU's (results of
    :func:`step_both`):
    the losses, every gradient against the largest gradient of its module,
    the parameters and statistics after one SGD step (tolerances above),
    and the ReLU and max-pool decisions each acoustic block took on the two
    devices. A conv block is held to ``GRAD_TOL`` unless a decision of its
    stack differs in it or after it."""

    import torch

    eps = torch.finfo(torch.float32).eps
    cpu_loss, cpu_grads, cpu_state, cpu_pre = cpu
    gpu_loss, gpu_grads, gpu_state, gpu_pre = gpu
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

    log(f'training step float32 card vs CPU, {label}: losses within '
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

    from amt_tools_tpu_torch.ops.cqt_kernel import cost

    # The kernel's cost function (its op's FLOP formula): a multi-rate FFT
    # CQT over the bank's wavelets, the audio and bank read and the
    # magnitudes written once
    grouped = bank.shape[0] != cqt._support  # the groups' stacked banks
    fft_flops, num_bytes = cost(
        audio.shape[0], audio.shape[1], HOP, bank,
        *((cqt._group_supports, cqt._group_bins) if grouped else ()))
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

    reference = {'state': {k: v.cpu() for k, v in model.state_dict().items()},
                 'notes': results[0],
                 'raw': tablature_logits(model, pipeline.data_proc,
                                         requests[0])}

    return ({'cqt_mag_grouped': launches['cqt_mag_grouped'],
             'cqt_mag': full_launches['cqt_mag']},
            (f'guitar batch of {GUITAR_BATCH} clips',
             lambda: pipeline(requests[0]), ('cqt_mag_tc_kernel',)),
            reference)


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


def note_agreement(notes, reference):
    """Precision, recall and F1 of ``notes`` against ``reference``: per
    clip, sets of (pitch, onset, offset) rounded to 4 decimals
    (``bench.py:242-271``); guitar clips carry one set per string."""

    def note_set(clip):
        if isinstance(clip, dict):
            return {(string,) + note for string, notes in clip.items()
                    for note in note_set(notes)}
        pitches, intervals = clip
        return {(int(p), round(float(on), 4), round(float(off), 4))
                for p, (on, off) in zip(pitches, intervals)}

    matched = total = total_ref = 0
    for clip, ref in zip(notes, reference):
        got, want = note_set(clip), note_set(ref)
        matched += len(got & want)
        total += len(got)
        total_ref += len(want)
    precision = matched / max(1, total)
    recall = matched / max(1, total_ref)

    return (precision, recall,
            2 * precision * recall / max(1e-12, precision + recall),
            total, total_ref)


def batch_peaks(pipeline, requests):
    """Peak device memory (GB) of each request served alone."""

    import torch

    peaks = []
    for request in requests:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pipeline(request)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)

    return peaks


def check_int8_chunks(model, mel, audio, picks):
    """Every int8 layer of ``model`` over the whole batch ``audio``, against
    the same layer run alone on the clips ``picks``: static scales do not
    depend on the batch, so each picked clip's output must be equal bit for
    bit. Over 128 x 60 s Conv_1 runs in chunks of 5 clips, Conv_2 of 11 and
    Dense_0 of about 26, so the picks sit in first, later, straddling and
    last chunks. Returns the layers' chunk counts."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.qconv import int8_layers

    index = torch.tensor(picks, device=audio.device)
    seen, chunks = {}, {}

    def keep(layer, args, out, name):
        x = args[0]
        rows = x.shape[0] if x.dim() == 4 else x[..., 0].numel()
        flat = x if x.dim() == 4 else x.reshape(-1, x.shape[-1])
        chunks[name] = -(-rows // layer.chunk_rows(flat))
        seen[name] = (x.index_select(0, index).clone(),
                      out.index_select(0, index).clone())

    hooks = [layer.register_forward_hook(
                 lambda layer, args, out, name=name: keep(layer, args, out,
                                                          name))
             for name, layer in int8_layers(model)]
    try:
        with torch.inference_mode():
            feats = mel.process(audio)
            model(model.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS])
    finally:
        for hook in hooks:
            hook.remove()

    layers = dict(int8_layers(model))
    require(len(seen) == len(layers), 'an int8 layer did not run')
    for name, (x, out) in seen.items():
        with torch.inference_mode():
            alone = layers[name](x)
        require(torch.equal(alone, out),
                f'{name}: clips {picks} of the batch differ from the same '
                f'clips run alone')

    return chunks


def serve_int8(clips, profile, card):
    """Phase 14: int8-static piano serving at the JAX headline recipe
    (``bench.py:52-113`` with ``quant='static'``): O&F2 complexity 3 in
    bf16 with Conv_1, Conv_2 and Dense_0 of each acoustic stack in int8,
    scales calibrated on 4 clips, then activity; 3 requests of 128 x 60 s
    with overlapped dispatch/finalize, beside the bf16 pipeline on the same
    weights in this process; the note agreement with bf16 as ``bench.py``
    computes it; each batch's peak memory; A and B must launch on the int8
    route; picked clips of the batch equal, layer by layer, the same clips
    run alone (:func:`check_int8_chunks`)."""

    import torch

    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.serving import (TranscriptionPipeline,
                                             calibrate_activity,
                                             calibrate_quant_stats)

    mel = MelSpec(sample_rate=SAMPLE_RATE, hop_length=HOP, n_mels=N_MELS)
    model = OnsetsFrames2(dim_in=N_MELS, profile=profile, model_complexity=3,
                          dtype=torch.bfloat16, quant_acoustic='static',
                          generator=torch.Generator().manual_seed(0))
    scales = calibrate_quant_stats(model, mel, clips[:4])
    log(f'int8-static scales {({k: round(v, 4) for k, v in scales.items()})}')
    require(len(scales) == 9 and min(scales.values()) > 0,
            'calibration did not fill the 9 scales')
    shifts = calibrate_activity(model, mel, clips[:4])
    log(f'int8-static: calibrated head biases by {shifts}')

    # The bf16 reference serves the same (calibrated) weights
    bf16_model = OnsetsFrames2(dim_in=N_MELS, profile=profile,
                               model_complexity=3, dtype=torch.bfloat16)
    bf16_model.load_state_dict({k: v for k, v in model.state_dict().items()
                                if not k.endswith('act_amax')})

    pipeline = TranscriptionPipeline(model, mel, capacity=CAPACITY)
    reference = TranscriptionPipeline(bf16_model, mel, capacity=CAPACITY)
    audio = torch.from_numpy(clips).cuda()
    requests = [torch.roll(audio, shifts=43 * r, dims=0)
                for r in range(REQUESTS)]
    for pipe in (pipeline, reference):
        pipe(requests[0][:8])  # warm-up
    torch.cuda.synchronize()

    audio_seconds = REQUESTS * BATCH * CLIP_SECONDS
    rates, notes = {}, {}
    for label, pipe in (('bf16', reference), ('int8-static', pipeline),
                        ('int8-static again', pipeline),
                        ('bf16 again', reference)):
        reset_launches()
        results, elapsed = serve_requests(pipe, requests)
        launches = read_launches()
        rates[label] = audio_seconds / elapsed
        notes.setdefault(label.split()[0], results)
        log(f'{label}: {REQUESTS} requests of {BATCH} x {CLIP_SECONDS:.0f} s '
            f'in {elapsed:.3f} s: {rates[label]:.1f} audio-s per wall-s '
            f'({card}); launches {launches}')
        if label.startswith('int8'):
            int8_launches = launches
    require(int8_launches['stft_power_fft'] == REQUESTS,
            'kernel A did not run once per int8 dispatch on its FFT route')
    require(int8_launches['lstm_scan'] == 3 * REQUESTS,
            'kernel B did not run three times per int8 dispatch')

    flat = [clip for result in notes['int8-static'] for clip in result]
    flat_ref = [clip for result in notes['bf16'] for clip in result]
    precision, recall, f1, total, total_ref = note_agreement(flat, flat_ref)
    counts = [len(p) for p, _ in flat]
    log(f'int8-static vs bf16 note agreement: P {precision:.4f} R '
        f'{recall:.4f} F1 {f1:.4f} ({total} vs {total_ref} notes; per clip '
        f'min {min(counts)} median {int(np.median(counts))} max '
        f'{max(counts)})')
    require(len(counts) == REQUESTS * BATCH and min(counts) > 0,
            'an int8 clip decoded no notes')
    picks = [0, 5, 26, 64, BATCH - 1]
    chunks = check_int8_chunks(model, mel, requests[0], picks)
    log(f'int8-static chunks: clips {picks} of the {BATCH}-clip batch equal '
        f'bit for bit, in every int8 layer, the same clips run alone; chunks '
        f'a layer over the batch {chunks}')
    require(max(chunks.values()) > 1,
            'no int8 layer ran in more than one chunk over the batch')

    peaks = batch_peaks(pipeline, requests)
    ref_peaks = batch_peaks(reference, requests)
    log(f'peak device memory a batch, GB: int8-static '
        f'{[round(p, 3) for p in peaks]}, bf16 '
        f'{[round(p, 3) for p in ref_peaks]} ({card})')
    log(f'int8-static / bf16 audio-s per wall-s, in turns: '
        f'{rates["bf16"]:.1f}, {rates["int8-static"]:.1f}, '
        f'{rates["int8-static again"]:.1f}, {rates["bf16 again"]:.1f}')

    return ({'stft_power': int8_launches['stft_power'],
             'lstm_scan': int8_launches['lstm_scan']},
            ('int8-static piano batch of 128 clips',
             lambda: pipeline(requests[0]),
             ('stft_power_fft_kernel', 'lstm_scan_kernel')))


def serve_guitar_int8(clips, card):
    """Phase 15: one int8-static guitar batch of 64 x 60 s (TabCNN
    fullseq with conv1-conv3 and dense1 in int8, behind the serving CQT,
    kernel D) beside the bf16 pipeline on the same weights; the tablature
    cells and the notes it shares with bf16."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.serving import (TablaturePipeline,
                                             calibrate_quant_stats,
                                             calibrate_tablature_activity)

    profile = tools.GuitarProfile(num_frets=19)
    cqt = guitar_cqt(grouped='auto')
    model = TabCNN(dim_in=cqt.get_feature_size(), profile=profile,
                   fullseq=True, dtype=torch.bfloat16,
                   quant_acoustic='static',
                   generator=torch.Generator().manual_seed(0))
    scales = calibrate_quant_stats(model, cqt, clips[:4])
    require(len(scales) == 4 and min(scales.values()) > 0,
            'calibration did not fill the 4 TabCNN scales')
    calibrate_tablature_activity(model, cqt, clips[:4])
    bf16_model = TabCNN(dim_in=cqt.get_feature_size(), profile=profile,
                        fullseq=True, dtype=torch.bfloat16)
    bf16_model.load_state_dict({k: v for k, v in model.state_dict().items()
                                if not k.endswith('act_amax')})

    pipeline = TablaturePipeline(model, cqt, capacity=GUITAR_CAPACITY)
    reference = TablaturePipeline(bf16_model, cqt, capacity=GUITAR_CAPACITY)
    audio = torch.from_numpy(clips).cuda()
    for pipe in (pipeline, reference):
        pipe(audio[:8])  # warm-up
    torch.cuda.synchronize()

    rates, notes = {}, {}
    for label, pipe in (('bf16', reference), ('int8-static', pipeline),
                        ('int8-static again', pipeline),
                        ('bf16 again', reference)):
        reset_launches()
        results, elapsed = serve_requests(pipe, [audio])
        launches = read_launches()
        rates[label] = GUITAR_BATCH * CLIP_SECONDS / elapsed
        notes.setdefault(label.split()[0], results[0])
        log(f'guitar {label}: 1 request of {GUITAR_BATCH} x '
            f'{CLIP_SECONDS:.0f} s in {elapsed:.3f} s: {rates[label]:.1f} '
            f'audio-s per wall-s ({card}); launches {launches}')
        if label.startswith('int8'):
            require(launches['cqt_mag_grouped_bf16x3'] == 1,
                    'kernel D did not run on the int8 guitar batch')
            int8_launches = launches

    with torch.inference_mode():
        feats = cqt.process(audio[:16])
        logits = {name: m(m.pre_proc({tools.KEY_FEATS: feats})[
            tools.KEY_FEATS])[tools.KEY_TABLATURE]
            for name, m in (('int8', model), ('bf16', bf16_model))}
    head = model.tablature_out
    tab, tab_ref = (head.finalize_output(logits[k]) for k in ('int8', 'bf16'))
    cells = (tab == tab_ref).float().mean().item()
    precision, recall, f1, total, total_ref = note_agreement(
        notes['int8-static'], notes['bf16'])
    log(f'guitar int8-static vs bf16: tablature cells equal {cells:.4f} '
        f'(16 clips); notes P {precision:.4f} R {recall:.4f} F1 {f1:.4f} '
        f'({total} vs {total_ref}); in turns {rates["bf16"]:.1f}, '
        f'{rates["int8-static"]:.1f}, {rates["int8-static again"]:.1f}, '
        f'{rates["bf16 again"]:.1f} audio-s per wall-s')
    require(total > 0, 'the int8 guitar batch decoded no notes')

    return {'cqt_mag_grouped': int8_launches['cqt_mag_grouped']}


def int8_against_cpu(clips, profile):
    """Phase 16: a short clip through the int8-static O&F2 (complexity 3,
    float32, acoustic stacks and LM projections in int8) on the card and on
    the CPU: every int8 layer's accumulator bit for bit on the CPU's int8
    operands, the operands that differ between the two devices counted by
    steps, and the logits within ``INT8_LOGIT_TOL``."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.ops.qconv import int8_layers
    from amt_tools_tpu_torch.serving import calibrate_quant_stats

    audio = np.ascontiguousarray(clips[:2, :10 * SAMPLE_RATE])
    mel = MelSpec(n_mels=N_MELS)
    model = OnsetsFrames2(dim_in=N_MELS, profile=profile, model_complexity=3,
                          quant_acoustic='static', quant_lm='static',
                          generator=torch.Generator().manual_seed(3))
    calibrate_quant_stats(model, mel, audio, device='cpu')

    inputs, raw = {}, {}
    for device in ('cpu', 'cuda'):
        model = model.to(device)
        hooks = [layer.register_forward_pre_hook(
                     lambda layer, args, name=name:
                     inputs.setdefault(device, {}).__setitem__(
                         name, args[0].detach().float().cpu()))
                 for name, layer in int8_layers(model)]
        with torch.inference_mode(), tools.exact_fp32():
            feats = mel.process(torch.from_numpy(audio).to(device))
            out = model(model.pre_proc({tools.KEY_FEATS: feats})[
                tools.KEY_FEATS])
        raw[device] = {k: v.float().cpu() for k, v in out.items()}
        for hook in hooks:
            hook.remove()

    layers = int8_layers(model)  # on the card now
    one_step = more = values = 0
    for name, layer in layers:
        cpu_layer = copy.deepcopy(layer).cpu()
        with torch.inference_mode():
            x8_cpu, _ = cpu_layer.quantize(inputs['cpu'][name])
            x8_gpu, _ = layer.quantize(inputs['cuda'][name].cuda())
            acc_cpu = cpu_layer.accumulate(x8_cpu)
            acc_gpu = layer.accumulate(x8_cpu.cuda()).cpu()
        steps = (x8_cpu.int() - x8_gpu.cpu().int()).abs()
        one_step += int((steps == 1).sum())
        more += int((steps > 1).sum())
        values += steps.numel()
        require(torch.equal(acc_gpu, acc_cpu),
                f'{name}: the int32 accumulators differ between the card and '
                f'the CPU on identical int8 operands')

    worst = max((raw['cuda'][k] - raw['cpu'][k]).abs().max().item()
                for k in raw['cpu'])
    mean = max((raw['cuda'][k] - raw['cpu'][k]).abs().mean().item()
               for k in raw['cpu'])
    log(f'int8-static card vs CPU: the {len(layers)} int8 layers\' int32 '
        f'accumulators equal bit for bit on the CPU\'s operands; of '
        f'{values} int8 operands {one_step} differ by one step and {more} by '
        f'more (their float inputs differ by float32 sums in another order '
        f'upstream); logits within {worst:.3g} (tolerance {INT8_LOGIT_TOL}), '
        f'mean {mean:.3g} (tolerance {INT8_LOGIT_MEAN_TOL})')
    require(worst <= INT8_LOGIT_TOL and mean <= INT8_LOGIT_MEAN_TOL,
            'int8-static logits on the card disagree with the CPU')


def time_int8_layers(card):
    """Phase 17: the int8 layers of the piano batch (quantize, im2col,
    ``torch._int_mm``, rescale) against cuDNN's bf16 conv and a bf16
    ``F.linear`` at the same shapes: O&F2 complexity 3's Conv_1, Conv_2
    and Dense_0 over 128 x 60 s, static scales, bf16 in and out."""

    import torch
    import torch.nn.functional as F

    from amt_tools_tpu_torch.ops.qconv import Int8Conv, Int8Dense

    frames = 1 + int(CLIP_SECONDS * SAMPLE_RATE) // HOP
    g = torch.Generator().manual_seed(0)
    rows = []
    for name, layer, shape in (
            ('Conv_1', Int8Conv(48, 48, dtype=torch.bfloat16,
                                static_scale=True, generator=g),
             (BATCH, 48, frames, N_MELS)),
            ('Conv_2', Int8Conv(48, 96, dtype=torch.bfloat16,
                                static_scale=True, generator=g),
             (BATCH, 48, frames, N_MELS // 2)),
            ('Dense_0', Int8Dense(96 * (N_MELS // 4), 768,
                                  dtype=torch.bfloat16, static_scale=True,
                                  generator=g),
             (BATCH, frames, 96 * (N_MELS // 4)))):
        layer = layer.cuda()
        x = torch.rand(shape, device='cuda', dtype=torch.bfloat16)
        layer.act_amax.fill_(1.0)
        weight = layer.weight.to(torch.bfloat16)
        bias = layer.bias.to(torch.bfloat16)
        if isinstance(layer, Int8Conv):
            def library(x=x, weight=weight, bias=bias):
                return F.conv2d(x, weight, bias, padding=1)
        else:
            def library(x=x, weight=weight, bias=bias):
                return F.linear(x, weight, bias)
        with torch.inference_mode():
            ms = time_ms(lambda: layer(x), reps=3)
            library_ms = time_ms(library, reps=3)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            layer(x)
            extra = (torch.cuda.max_memory_allocated() - base) / 1e9
            parts = int8_parts(layer, x)
        rows.append((name, shape, ms, library_ms, extra, parts))
        del x
        torch.cuda.empty_cache()
    for name, shape, ms, library_ms, extra, parts in rows:
        log(f'int8 {name} {shape}: {ms:.3f} ms ({extra:.3f} GB above its '
            f'input), bf16 library {library_ms:.3f} ms ({card}); one chunk '
            f'of {parts.pop("rows")} rows: ' +
            ', '.join(f'{part} {part_ms:.3f} ms'
                      for part, part_ms in parts.items()))


def int8_parts(layer, x):
    """Device ms of each step of the first chunk of an int8 layer's forward
    (:meth:`chunk_rows` of ``x``): the float32 quantize, the im2col (convs),
    ``torch._int_mm`` and the float32 rescale with the cast to bf16."""

    import torch

    from amt_tools_tpu_torch.ops import qconv

    conv = isinstance(layer, qconv.Int8Conv)
    if not conv:
        x = x.reshape(-1, x.shape[-1])
    rows = layer.chunk_rows(x)
    chunk = x[:rows]
    w8, s_w = layer.quantized_weights()
    x8, scale = layer.quantize(chunk)
    cols = layer.operand(x8)
    acc = qconv.int8_matmul(cols, w8)

    parts = {'rows': rows,
             'quantize': time_ms(lambda: layer.quantize(chunk), reps=3)}
    if conv:
        parts['im2col'] = time_ms(lambda: layer.operand(x8), reps=3)
    parts['_int_mm'] = time_ms(lambda: qconv.int8_matmul(cols, w8), reps=3)
    parts['rescale'] = time_ms(
        lambda: layer.rescale(acc, rows, scale, s_w).to(torch.bfloat16),
        reps=3)

    return parts


def check_masked_lstm(card):
    """Phase 18: kernel B with per-row lengths at the bucketed validation
    shape (8 tracks padded to the 3840 frames of a 120 s track, H = 256),
    float32 and bf16: against its masked plain version on the valid
    frames, padded outputs exactly 0, lengths = T bit for bit the unmasked
    launch, and masked against unmasked time."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.lstm import lengths_to_mask
    from amt_tools_tpu_torch.ops.lstm_kernel import (lstm_scan,
                                                     lstm_scan_plain,
                                                     scan_cost)

    frames = -(-(1 + int(VAL_DURATIONS[-1] * SAMPLE_RATE) // HOP) //
               VAL_BUCKET) * VAL_BUCKET
    # Spread evenly over 20-120 s of frames
    seconds = np.linspace(VAL_DURATIONS[0], VAL_DURATIONS[-1], VAL_BATCH)
    lengths = torch.from_numpy(np.minimum(
        np.round(seconds * SAMPLE_RATE / HOP), frames)).int().cuda()
    valid = lengths_to_mask(lengths, frames)
    full = torch.full_like(lengths, frames)
    result = {}
    with tools.exact_fp32():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            _, _, _, xw, wh = lstm_inputs(VAL_BATCH, frames, dtype, seed=18)
            err = mean_err = 0.0
            for reverse in (False, True):
                got = lstm_scan(xw, wh, reverse=reverse, lengths=lengths)
                ref = lstm_scan_plain(xw, wh, reverse=reverse,
                                      lengths=lengths)
                diff = (got.float() - ref.float()).abs()[valid]
                err = max(err, diff.max().item())
                mean_err = max(mean_err, diff.mean().item())
                require(not bool(got[~valid].any()),
                        f'masked lstm_scan {name} wrote a padded frame')
                require(torch.equal(
                    lstm_scan(xw, wh, reverse=reverse, lengths=full),
                    lstm_scan(xw, wh, reverse=reverse)),
                    f'masked lstm_scan {name} with lengths = T is not the '
                    f'unmasked launch bit for bit')
            log(f'masked lstm_scan {name} at B={VAL_BATCH}, T={frames}, '
                f'H={HIDDEN}, lengths {lengths.tolist()}: |kernel - plain| '
                f'on valid frames max {err:.6g} (tolerance {LSTM_TOL[name]}), '
                f'mean {mean_err:.6g} (tolerance {LSTM_MEAN_TOL[name]}), '
                f'worse direction; lengths = T equal the unmasked launch')
            require(err <= LSTM_TOL[name] and
                    mean_err <= LSTM_MEAN_TOL[name],
                    f'masked lstm_scan {name} disagrees with its plain '
                    f'version')

            # In turns (unmasked, masked, masked, unmasked), so a drift of
            # the clocks does not fall on one side
            def unmasked():
                return time_ms(lambda: lstm_scan(xw, wh), reps=10)

            def masked():
                return time_ms(lambda: lstm_scan(xw, wh, lengths=lengths),
                               reps=10)

            turns = [unmasked(), masked(), masked(), unmasked()]
            unmasked_ms = (turns[0] + turns[3]) / 2
            masked_ms = (turns[1] + turns[2]) / 2
            log(f'masked lstm_scan {name} a direction at B={VAL_BATCH}, '
                f'T={frames}, in turns unmasked, masked, masked, unmasked: '
                + ', '.join(f'{ms:.3f}' for ms in turns) +
                f' ms; masked {100 * (masked_ms / unmasked_ms - 1):+.1f}% '
                f'({card})')
            result[name] = {'masked_ms': masked_ms,
                            'unmasked_ms': unmasked_ms,
                            'masked_max_abs_err': err}

    return result


class ValidationTracks:
    """A duck-typed validation set: whole tracks of unequal lengths from
    one dataset a duration (each with a split of its own, so its own
    notes), features computed by the dataset on the card when first read.
    """

    def __init__(self, datasets):
        self.sets = {}
        for dataset in datasets:
            for track in dataset.tracks:
                self.sets[track] = dataset
        self.tracks = list(self.sets)

    def get_track_data(self, track_id):
        return self.sets[track_id].get_track_data(track_id)

    def get_track_frames(self, track_id):
        return self.sets[track_id].get_track_frames(track_id)


def piano_val_set(mel, durations, per_duration):
    from amt_tools_tpu_torch.datasets import SyntheticPiano

    return ValidationTracks([
        SyntheticPiano(splits=[f'val{int(d)}'], num_tracks=per_duration,
                       track_duration=d, notes_per_track=int(2 * d),
                       data_proc=mel)
        for d in durations])


def of2_recipe():
    """The of_2 recipe's validation estimator and evaluator
    (``examples/papers/of_2.py:135-144``)."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                              MultipitchEvaluator,
                                              NoteEvaluator)
    from amt_tools_tpu_torch.transcribe import (ComboEstimator,
                                                NoteTranscriber,
                                                PitchListWrapper)

    profile = tools.PianoProfile()
    estimator = ComboEstimator([NoteTranscriber(profile=profile),
                                PitchListWrapper(profile=profile)])
    evaluator = ComboEvaluator([
        LossWrapper(), MultipitchEvaluator(),
        NoteEvaluator(results_key=tools.KEY_NOTE_ON),
        NoteEvaluator(offset_ratio=0.2, results_key=tools.KEY_NOTE_OFF)])
    evaluator.set_patterns(['loss', 'pr', 're', 'f1'])

    return estimator, evaluator


class HostTimer:
    """Wraps the estimator's and evaluator's ``process_track``: the host
    seconds spent in them, each track's estimates and scores."""

    def __init__(self, estimator, evaluator):
        self.seconds = 0.0
        self.estimates = {}
        self.scores = {}
        self._wrap(estimator, self.estimates, index=1)
        self._wrap(evaluator, self.scores, index=2)

    def _wrap(self, obj, store, index):
        process = obj.process_track

        def timed(*args):
            start = time.perf_counter()
            out = process(*args)
            self.seconds += time.perf_counter() - start
            track = args[index] if len(args) > index else None
            store[track] = out
            return out

        obj.process_track = timed


def validate_timed(model, dataset, estimator, evaluator, batch_size):
    """One validation pass on the card with fresh launch counts: (averaged
    results, launches, wall seconds, host seconds, per-track notes and
    scores)."""

    import torch

    from amt_tools_tpu_torch.evaluate import validate

    timer = HostTimer(estimator, evaluator)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    results = validate(model, dataset, evaluator, estimator,
                       bucket=VAL_BUCKET, batch_size=batch_size)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start

    return results, read_launches(), elapsed, timer


def without_loss(scores):
    from amt_tools_tpu_torch import tools

    return {key: value for key, value in scores.items()
            if key != tools.KEY_LOSS}


def validate_piano(card):
    """Phase 19: O&F2 complexity 3 in float32 (the of_2 recipe) validates
    16 SyntheticPiano tracks of 20-120 s, bucketed by 128 frames, at batch
    sizes 1 and 8, through the recipe's estimator and evaluator. The two
    passes score every track alike; every track's notes equal
    ``run_offline(bucket=0)``'s. Returns kernel B's masked launches in the
    batch-8 pass."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.inference import run_offline
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.serving import calibrate_activity

    mel = MelSpec(n_mels=N_MELS, htk=True)
    dataset = piano_val_set(mel, VAL_DURATIONS, 4)
    model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                          model_complexity=3,
                          generator=torch.Generator().manual_seed(19))
    probe_samples = int(min(10.0, VAL_DURATIONS[0]) * SAMPLE_RATE)
    probe = np.stack([dataset.sets[t].load(t)[tools.KEY_AUDIO][:probe_samples]
                      for t in dataset.tracks[:4]])
    calibrate_activity(model, mel, probe)
    model.eval()

    audio_s = sum(dataset.sets[t].track_duration for t in dataset.tracks)
    passes = {}
    for batch_size in (1, VAL_BATCH):
        estimator, evaluator = of2_recipe()
        passes[batch_size] = validate_timed(model, dataset, estimator,
                                            evaluator, batch_size)
        results, launches, elapsed, timer = passes[batch_size]
        log(f'validate O&F2 complexity 3 float32, {len(dataset.tracks)} '
            f'tracks ({audio_s:.0f} s of audio), bucket {VAL_BUCKET}, batch '
            f'{batch_size}: {elapsed:.3f} s, '
            f'{len(dataset.tracks) / elapsed:.3f} tracks/s, '
            f'{audio_s / elapsed:.1f} audio-s per wall-s, host estimators '
            f'and metrics {timer.seconds:.3f} s '
            f'({100 * timer.seconds / elapsed:.1f}% of the wall time; the '
            f'rest: features, forwards, transfers) ({card}); launches '
            f'{launches}')
        for group, scores in sorted(results.items()):
            log(f'  {group}: ' + ', '.join(f'{k} {v:.6g}'
                                           for k, v in sorted(scores.items())))

    one, eight = passes[1], passes[VAL_BATCH]
    require(one[1]['stft_power'] == len(dataset.tracks),
            'the validation features did not run kernel A once a track')
    require(one[1]['lstm_scan_masked'] == 3 * len(dataset.tracks) and
            one[1]['lstm_scan'] == one[1]['lstm_scan_masked'],
            'the batch-1 pass did not run masked kernel B three times a '
            'track')
    groups = sum(-(-4 // VAL_BATCH) for _ in VAL_DURATIONS)
    require(eight[1]['lstm_scan_masked'] == 3 * groups,
            f'the batch-{VAL_BATCH} pass did not run masked kernel B three '
            f'times a bucket group')
    for track in dataset.tracks:
        require(without_loss(one[3].scores[track]) ==
                without_loss(eight[3].scores[track]),
                f'{track}: batch 1 and batch {VAL_BATCH} score differently')

    # Every track's notes against the unbucketed forward's
    notes = 0
    for track in dataset.tracks:
        want = run_offline(dataset.get_track_data(track), model)
        got = eight[3].estimates[track][tools.KEY_NOTES]
        unbucketed = notes_of(want, model)
        require(np.array_equal(got, unbucketed),
                f'{track}: bucketed notes differ from run_offline(bucket=0)')
        notes += len(got)
    require(notes > 0, 'no validation track decoded a note')
    log(f'bucketed notes equal run_offline(bucket=0) on all '
        f'{len(dataset.tracks)} tracks ({notes} notes); the batch-1 and '
        f'batch-{VAL_BATCH} passes score every track alike')

    return eight[1]['lstm_scan_masked'], one[1]['lstm_scan_masked']


def notes_of(predictions, model):
    """The of_2 estimator's notes of a prediction dict."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.transcribe import NoteTranscriber

    return NoteTranscriber(profile=model.profile).process_track(
        dict(predictions))[tools.KEY_NOTES]


def render_guitar_track(cqt, profile, seconds, seed):
    """A guitar track from random tablature: per string, notes of random
    frets one after another, rendered as harmonic tones at 22.05 kHz; the
    tablature and multi-pitch ground truth on the CQT's frame grid."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import render_notes

    rng = np.random.RandomState(seed)
    tuning = profile.get_midi_tuning()
    notes = []
    for string, low in enumerate(tuning):
        start = rng.uniform(0, 1.0)
        while start < seconds - 0.3:
            end = min(seconds, start + rng.uniform(0.2, 1.2))
            notes.append((string, rng.randint(0, profile.num_pitches), start,
                          end))
            start = end + rng.uniform(0.05, 1.5)
    audio = render_notes(np.array([tuning[s] + f for s, f, _, _ in notes],
                                  float),
                         np.array([(a, b) for _, _, a, b in notes]),
                         GUITAR_SAMPLE_RATE, seconds, seed=seed)
    times = cqt.get_times(audio)
    tablature = np.full((len(tuning), len(times)), -1)
    for string, fret, start, end in notes:
        tablature[string, (times >= start) & (times < end)] = fret
    stacked = tools.tablature_to_stacked_multi_pitch(tablature, profile)

    return {tools.KEY_AUDIO: audio, tools.KEY_TIMES: times,
            tools.KEY_TABLATURE: tablature,
            tools.KEY_MULTIPITCH:
                tools.stacked_multi_pitch_to_multi_pitch(stacked)}


class GuitarTracks:
    """A duck-typed guitar validation set whose features the serving CQT
    computes on the card each time a track is read."""

    def __init__(self, cqt, profile, durations):
        self.cqt = cqt
        self.data = {f'guitar_{i}': render_guitar_track(cqt, profile, d, i)
                     for i, d in enumerate(durations)}
        self.tracks = list(self.data)

    def get_track_data(self, track_id):
        from amt_tools_tpu_torch import tools

        data = dict(self.data[track_id], **{tools.KEY_TRACK: track_id})
        data[tools.KEY_FEATS] = self.cqt.process_audio(
            data[tools.KEY_AUDIO])
        require(data[tools.KEY_FEATS].shape[-1] == len(data[tools.KEY_TIMES]),
                'the CQT frames do not match the tablature frames')
        return data

    def get_track_frames(self, track_id):
        from amt_tools_tpu_torch import tools

        return len(self.data[track_id][tools.KEY_TIMES])


def validate_guitar(card):
    """Phase 20: TabCNN (fullseq, bf16) validates 8 rendered guitar tracks
    of 10-45 s through the tabcnn recipe's estimator and evaluator
    (``examples/papers/tabcnn.py:106-113``), bucketed by 128 frames, the
    features by kernel D; then ``run_online`` (windowed, one 9-frame
    window a step) on one 5 s track against ``run_offline``'s tablature,
    in float32."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                              MultipitchEvaluator,
                                              SoftmaxAccuracy,
                                              TablatureEvaluator)
    from amt_tools_tpu_torch.inference import run_offline, run_online
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.serving import calibrate_tablature_activity
    from amt_tools_tpu_torch.transcribe import (ComboEstimator,
                                                StackedMultiPitchCollapser,
                                                TablatureWrapper)

    profile = tools.GuitarProfile(num_frets=19)
    cqt = guitar_cqt(grouped='auto')
    dataset = GuitarTracks(cqt, profile, GUITAR_VAL_DURATIONS)
    model = TabCNN(dim_in=cqt.get_feature_size(), profile=profile,
                   fullseq=True, dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(20))
    probe_samples = int(min(10.0, *GUITAR_VAL_DURATIONS[:4]) *
                        GUITAR_SAMPLE_RATE)
    probe = np.stack([dataset.data[t][tools.KEY_AUDIO][:probe_samples]
                      for t in dataset.tracks[:4]])
    calibrate_tablature_activity(model, cqt, probe)
    model.eval()

    estimator = ComboEstimator([TablatureWrapper(profile=profile),
                                StackedMultiPitchCollapser(profile=profile)])
    evaluator = ComboEvaluator([LossWrapper(), MultipitchEvaluator(),
                                TablatureEvaluator(profile=profile),
                                SoftmaxAccuracy()])
    results, launches, elapsed, timer = validate_timed(
        model, dataset, estimator, evaluator, VAL_BATCH)
    audio_s = sum(GUITAR_VAL_DURATIONS)
    log(f'validate TabCNN fullseq bf16, {len(dataset.tracks)} guitar tracks '
        f'({audio_s:.0f} s), bucket {VAL_BUCKET}, batch {VAL_BATCH}: '
        f'{elapsed:.3f} s, {len(dataset.tracks) / elapsed:.3f} tracks/s, '
        f'{audio_s / elapsed:.1f} audio-s per wall-s, host estimators and '
        f'metrics {100 * timer.seconds / elapsed:.1f}% ({card}); launches '
        f'{launches}')
    for group, scores in sorted(results.items()):
        log(f'  {group}: ' + ', '.join(f'{k} {v:.6g}'
                                       for k, v in sorted(scores.items())))
    require(launches['cqt_mag_grouped_bf16x3'] == len(dataset.tracks),
            'the guitar validation features did not run kernel D once a '
            'track on its bf16x3 route')
    require(all(np.isfinite(v) for scores in results.values()
                for v in scores.values()), 'a guitar score is not finite')
    require(results[tools.KEY_TABLATURE][tools.KEY_PRECISION] > 0,
            'no tablature cell was predicted right')

    # run_online, windowed, against run_offline in float32
    track = render_guitar_track(cqt, profile, ONLINE_SECONDS, 99)
    track[tools.KEY_FEATS] = cqt.process_audio(track.pop(tools.KEY_AUDIO))
    track[tools.KEY_TRACK] = 'online'
    state = {k: v.float() for k, v in model.state_dict().items()}
    offline_model = TabCNN(dim_in=cqt.get_feature_size(), profile=profile,
                           fullseq=True)
    online_model = TabCNN(dim_in=cqt.get_feature_size(), profile=profile,
                          online=True)
    for m in (offline_model, online_model):
        m.load_state_dict(state)
        m.eval()
    with tools.exact_fp32():
        offline = run_offline(dict(track), offline_model)
        online = run_online({k: track[k] for k in (tools.KEY_FEATS,
                                                   tools.KEY_TIMES)},
                            online_model)
        with torch.no_grad():
            feats = torch.from_numpy(track[tools.KEY_FEATS][None]).to(
                next(offline_model.parameters()).device)
            logits = offline_model(offline_model.pre_proc(
                {tools.KEY_FEATS: feats})[tools.KEY_FEATS])[
                    tools.KEY_TABLATURE][0].float().cpu()
    top2 = logits.reshape(logits.shape[0], 6, -1).topk(2, dim=-1).values
    close = (top2[..., 0] - top2[..., 1]).T.numpy() <= TAB_MARGIN
    differ = online[tools.KEY_TABLATURE] != offline[tools.KEY_TABLATURE]
    require(online[tools.KEY_TABLATURE].shape ==
            offline[tools.KEY_TABLATURE].shape, 'run_online shape')
    require(not bool((differ & ~close).any()),
            'run_online tablature differs from run_offline where the top '
            f'two logits are more than {TAB_MARGIN} apart')
    log(f'run_online on {ONLINE_SECONDS:.0f} s ({differ.shape[-1]} windows): '
        f'tablature equal to run_offline in {differ.size - differ.sum()} of '
        f'{differ.size} cells ({differ.sum()} differ, all within the '
        f'{TAB_MARGIN} top-two margin)')

    return launches['cqt_mag_grouped']


def train_with_validation(card):
    """Phase 21: ``train()`` at the of_2 recipe (float32, O&F2 complexity
    3, 8 x 625-frame crops, Adam 6e-4) for 4 steps with ``checkpoints=2``
    and a 4-track validation set: it validates twice (``finalize`` at
    iterations 2 and 4); steps/s with and without the validations, and
    whether the losses of the runs agree bit for bit (a second run without
    validation shows the card's own run-to-run spread)."""

    import tempfile

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import DataLoader, SyntheticPiano
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.train import train

    mel = MelSpec(n_mels=N_MELS, htk=True)
    crops = SyntheticPiano(num_tracks=TRAIN_BATCH, track_duration=30.0,
                           num_frames=TRAIN_FRAMES, data_proc=mel)
    batch = next(iter(DataLoader(crops, batch_size=TRAIN_BATCH, seed=0)))
    val_set = piano_val_set(mel, (20.0,), TRAIN_VAL_TRACKS)
    for track in val_set.tracks:
        val_set.get_track_data(track)  # features cached before timing

    class Writer:
        def __init__(self):
            self.steps = set()

        def add_scalar(self, tag, value, global_step=None):
            if tag.startswith(tools.VAL):
                self.steps.add(global_step)

    runs = {}
    for validated in (False, True, False):
        model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                              model_complexity=3,
                              generator=torch.Generator().manual_seed(21))
        optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        estimator, evaluator = of2_recipe() if validated else (None, None)
        writer = Writer()
        with tempfile.TemporaryDirectory(prefix='_chip_smoke_train_',
                                         dir=ROOT) as log_dir:
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            result = train(model, FixedLoader([batch]), optimizer, 4,
                           checkpoints=2, log_dir=log_dir,
                           val_set=val_set if validated else None,
                           estimator=estimator, evaluator=evaluator,
                           writer=writer)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
        launches = read_launches()
        runs.setdefault(validated, []).append(result['losses'])
        label = 'with' if validated else 'without'
        log(f'train() 4 float32 steps, checkpoints=2, {label} validation: '
            f'{elapsed:.3f} s, {result["step"] / elapsed:.3f} steps/s '
            f'({card}); launches {launches}')
        if validated:
            require(writer.steps == {2, 4},
                    f'train() validated at {sorted(writer.steps)}, not at '
                    f'iterations 2 and 4')
            require(launches['lstm_scan_masked'] ==
                    2 * 3 * TRAIN_VAL_TRACKS,
                    'the validations did not run masked kernel B three '
                    'times a track')
        require(launches['lstm_scan_residuals'] == 3 * 4,
                'kernel E did not run three times a step')

    # Two runs without validation tell the card's own run-to-run spread
    # (cuDNN's backward may sum in another order each run) from an effect
    # of the validation
    plain, validated = runs[False], runs[True][0]
    log(f'training losses bit for bit equal: with and without validation '
        f'{validated == plain[0]}, the two runs without validation '
        f'{plain[0] == plain[1]}; totals with '
        f'{validated[tools.KEY_LOSS_TOTAL]}, without '
        f'{plain[0][tools.KEY_LOSS_TOTAL]} and '
        f'{plain[1][tools.KEY_LOSS_TOTAL]}')


def velocity_model(seed, remat=False):
    """O&F2 at complexity 3 with the velocity head, float32."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2

    return OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                         model_complexity=3, estimate_velocity=True,
                         remat=remat,
                         generator=torch.Generator().manual_seed(seed))


def train_velocity(card):
    """Phase 22: O&F2 complexity 3 with the velocity head (a fourth
    acoustic stack and BiLSTM, ``RegressionBank``) through ``train()`` on
    SyntheticPiano(velocity_range=(0.3, 1.0)) crops of 625 frames, batch 8,
    Adam 6e-4, float32: kernels E and F four times a step, steps/s; then
    30 steps on one batch, whose velocity loss must fall. Returns E's and
    F's launches a step, a fixed batch and a profiler entry."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import DataLoader, SyntheticPiano
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.train import (_place_batch, make_train_step,
                                           step_generator)

    tools.use_exact_fp32()
    dataset = SyntheticPiano(num_tracks=2 * TRAIN_BATCH, track_duration=30.0,
                             num_frames=TRAIN_FRAMES,
                             velocity_range=VELOCITY_RANGE,
                             data_proc=MelSpec(n_mels=N_MELS, htk=True))
    loader = DataLoader(dataset, batch_size=TRAIN_BATCH, seed=0)

    result, launches, rate = train_run(
        velocity_model(22), loader, TRAIN_PASSES,
        f'training O&F2 complexity 3 with the velocity head in float32, '
        f'{TRAIN_PASSES} passes over {len(dataset)} tracks ({card})',
        recurrences=4)
    require(tools.KEY_LOSS_VELOCITY in result['losses'],
            'the velocity head took no loss')

    batch = next(iter(loader))
    require(float(np.max(batch[tools.KEY_VELOCITY])) > 0,
            'the crops carry no velocity ground truth')
    fixed, _, _ = train_run(velocity_model(23), FixedLoader([batch]),
                            FIT_STEPS, f'{FIT_STEPS} velocity steps on one '
                                       f'batch', recurrences=4)
    losses = fixed['losses'][tools.KEY_LOSS_VELOCITY]
    log(f'fixed batch: velocity loss {losses[0]:.6g} -> {losses[-1]:.6g}, '
        f'total {fixed["losses"][tools.KEY_LOSS_TOTAL][0]:.6g} -> '
        f'{fixed["losses"][tools.KEY_LOSS_TOTAL][-1]:.6g}')
    require(losses[-1] < losses[0], 'the velocity loss did not fall on a '
                                    'fixed batch')

    profiled = velocity_model(24).cuda()
    step = make_train_step(profiled, torch.optim.Adam(profiled.parameters(),
                                                      lr=LEARNING_RATE))
    device_batch = _place_batch(batch, torch.device('cuda'))
    step(device_batch, step_generator(0, 0, 'cuda'))

    per_step = {name: launches[name] / result['step']
                for name in ('lstm_scan_residuals', 'lstm_bptt')}
    return per_step, rate, batch, (
        f'float32 velocity training step of {TRAIN_BATCH} x {TRAIN_FRAMES} '
        f'frames',
        lambda: step(device_batch, step_generator(0, 1, 'cuda')),
        ('lstm_scan_kernel', 'lstm_bptt_kernel'))


def module_scale(grads, name):
    """The largest gradient of the module that holds ``name``."""

    module = name.rsplit('.', 1)[0]
    return max(float(g.abs().max()) for key, g in grads.items()
               if key.rsplit('.', 1)[0] == module)


def remat_turns(batch, card):
    """Phase 23: the velocity model of phase 22 with ``remat`` False,
    True, 'blocks' and False again, in turns, on one batch: the first
    step's loss bit for bit equal, its gradients within ``GRAD_TOL`` of
    each module's largest (cuDNN's backward may sum in another order each
    run; the second False run shows that spread), the running statistics
    within ``STAT_TOL``; then steps/s and the peak device memory of
    ``REMAT_STEPS`` steps for each."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import run_on_batch
    from amt_tools_tpu_torch.train import (_place_batch, make_train_step,
                                           step_generator)

    device_batch = _place_batch(batch, torch.device('cuda'))
    runs = []
    for remat in (False, True, 'blocks', False):
        torch.cuda.empty_cache()
        model = velocity_model(23, remat).cuda()
        optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)

        optimizer.zero_grad(set_to_none=True)
        loss = run_on_batch(model, device_batch, train=True,
                            generator=step_generator(0, 0, 'cuda'))[
                                tools.KEY_LOSS][tools.KEY_LOSS_TOTAL]
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if k.endswith(('running_mean', 'running_var'))}
        optimizer.step()

        step = make_train_step(model, optimizer)
        step(device_batch, step_generator(0, 1, 'cuda'))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        for i in range(REMAT_STEPS):
            step(device_batch, step_generator(0, 2 + i, 'cuda'))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated()
        runs.append({'remat': remat, 'loss': loss.item(), 'grads': grads,
                     'stats': stats, 'rate': REMAT_STEPS / elapsed,
                     'peak_gb': peak / 1e9})
        log(f'remat={remat!r}: first loss {loss.item()!r}, '
            f'{REMAT_STEPS / elapsed:.3f} steps/s, peak '
            f'{peak / 1e9:.3f} GB ({card})')
        del model, optimizer, step, grads

    base = runs[0]
    for run in runs[1:]:
        worst = max(float((run['grads'][n] - g).abs().max()) /
                    max(module_scale(base['grads'], n), 1e-30)
                    for n, g in base['grads'].items())
        stat_err = max(float((run['stats'][k] - v).abs().max())
                       for k, v in base['stats'].items())
        run['grad_err'], run['stat_err'] = worst, stat_err
        log(f'remat={run["remat"]!r} against False: loss equal '
            f'{run["loss"] == base["loss"]}, gradients within {worst:.3g} of '
            f'their module\'s largest, running statistics within '
            f'{stat_err:.3g}')
        require(run['loss'] == base['loss'],
                f'remat={run["remat"]!r} changed the first step\'s loss')
        require(worst <= GRAD_TOL, f'remat={run["remat"]!r} moved a '
                                   f'gradient past {GRAD_TOL}')
        require(stat_err <= STAT_TOL, f'remat={run["remat"]!r} moved a '
                                      f'running statistic')

    return [{k: run[k] for k in ('remat', 'rate', 'peak_gb')}
            for run in runs]


def train_tabcnn(card):
    """Phase 24: the synthetic_tabcnn recipe (``examples/papers/
    synthetic_tabcnn.py``): TabCNN windowed at complexity 1 in float32 on
    CQT(22050, 512, n_bins=192, bins_per_octave=24) (exact=True, the full
    bank: kernel C on its float32 FFMA route), 32 SyntheticGuitar tracks of
    8 s cropped to 128 frames, batch 8, Adadelta 1.0, through ``train()``
    with 2 checkpoints, each validating 6 test tracks with the recipe's
    estimator and evaluators; C once a track; steps/s with and without the
    validations. Returns C's launches, the rates and a profiler entry for
    one training step."""

    import tempfile

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import DataLoader, SyntheticGuitar
    from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                              MultipitchEvaluator,
                                              SoftmaxAccuracy,
                                              TablatureEvaluator)
    from amt_tools_tpu_torch.features import CQT
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.train import (_place_batch, make_train_step,
                                           step_generator, train)
    from amt_tools_tpu_torch.transcribe import (ComboEstimator,
                                                StackedMultiPitchCollapser,
                                                TablatureWrapper)

    tools.use_exact_fp32()
    profile = tools.GuitarProfile(num_frets=19)
    cqt = CQT(sample_rate=GUITAR_SAMPLE_RATE, hop_length=HOP, n_bins=192,
              bins_per_octave=24)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    train_set = SyntheticGuitar(data_proc=cqt, num_frames=TAB_FRAMES,
                                profile=profile, num_tracks=TAB_TRACKS,
                                track_duration=TAB_SECONDS,
                                notes_per_track=24, seed=0)
    test_set = SyntheticGuitar(data_proc=cqt, profile=profile,
                               num_tracks=TAB_TEST_TRACKS,
                               track_duration=TAB_SECONDS,
                               notes_per_track=24, seed=1, splits=['test'])
    for track in test_set.tracks:
        test_set.get_track_data(track)
    loader = DataLoader(train_set, batch_size=TRAIN_BATCH, shuffle=True,
                        drop_last=True, seed=0)
    log(f'{len(train_set.tracks)} + {len(test_set.tracks)} guitar tracks of '
        f'{TAB_SECONDS:.0f} s rendered in {time.perf_counter() - start:.1f} '
        f's')

    estimator = ComboEstimator([TablatureWrapper(profile=profile),
                                StackedMultiPitchCollapser(profile=profile)])
    evaluator = ComboEvaluator([LossWrapper(), MultipitchEvaluator(),
                                TablatureEvaluator(profile=profile),
                                SoftmaxAccuracy()])
    evaluator.set_patterns(['loss', 'f1', 'tdr', 'acc'])

    scores = {}

    class Writer:
        def add_scalar(self, tag, value, global_step=None):
            if tag.startswith(tools.VAL):
                scores.setdefault(global_step, {})[tag] = value

    rates = {}
    for validated in (True, False):
        model = TabCNN(dim_in=cqt.get_feature_size(), profile=profile,
                       generator=torch.Generator().manual_seed(24))
        optimizer = torch.optim.Adadelta(model.parameters(), lr=1.0)
        with tempfile.TemporaryDirectory(prefix='_chip_smoke_train_',
                                         dir=ROOT) as log_dir:
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = train(model, loader, optimizer, TAB_ITERATIONS,
                           checkpoints=2, log_dir=log_dir,
                           val_set=test_set if validated else None,
                           estimator=estimator, evaluator=evaluator,
                           writer=Writer())
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
        rates[validated] = result['step'] / elapsed
        losses = result['losses'][tools.KEY_LOSS_TOTAL]
        log(f'TabCNN recipe, {result["step"]} Adadelta steps '
            f'{"with" if validated else "without"} validation: '
            f'{elapsed:.3f} s, {rates[validated]:.3f} steps/s ({card}); '
            f'loss {losses[0]:.6g} -> {losses[-1]:.6g}')
        require(all(np.isfinite(losses)), 'a TabCNN loss is not finite')
        require(result['step'] == TAB_ITERATIONS * len(loader),
                'the TabCNN run took another number of steps')
    launches = read_launches()
    log(f'launches over the recipe (features of every track, training, '
        f'validation): {launches}')
    for step, values in sorted(scores.items()):
        log(f'  validation at {step}: ' + ', '.join(
            f'{k} {v:.6g}' for k, v in sorted(values.items())))
    require(sorted(scores) == [TAB_ITERATIONS // 2, TAB_ITERATIONS],
            f'train() validated at {sorted(scores)}')
    tracks = len(train_set.tracks) + len(test_set.tracks)
    require(launches['cqt_mag'] == tracks and
            launches['cqt_mag_ffma'] == tracks,
            'the recipe features did not run kernel C once a track on its '
            'FFMA route')
    require(launches['cqt_mag_grouped'] == 0, 'kernel D ran in the recipe')
    require(launches['lstm_scan'] == launches['lstm_scan_residuals'] == 0,
            'an LSTM kernel ran in TabCNN')

    step = make_train_step(model, torch.optim.Adadelta(model.parameters(),
                                                       lr=1.0))
    device_batch = _place_batch(next(iter(loader)), torch.device('cuda'))
    step(device_batch, step_generator(0, 0, 'cuda'))

    return launches['cqt_mag_ffma'], rates, (
        f'float32 TabCNN training step of {TRAIN_BATCH} x {TAB_FRAMES} '
        f'frames', lambda: step(device_batch, step_generator(0, 1, 'cuda')),
        ('implicit_gemm',))


def check_carried_lstm(card):
    """Phase 25a: kernel B with a carry at the streaming shape (one row,
    T = 1, H = 512: O&F-online at complexity 3) and at the training shape
    (8 x 625, H = 256), float32 and bf16: against its carried plain
    version, the whole sequence cut into chunks that thread the carry bit
    for bit equal to one launch, and timed in turns with the launch
    without a carry and the carried launch from a zero carry (the same
    arithmetic on the same data as the launch without one)."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.lstm_kernel import (lstm_scan,
                                                     lstm_scan_plain,
                                                     scan_cost)

    result = {}
    with tools.exact_fp32():
        for label, (batch, frames, hidden) in (('t1', (1, 1, 512)),
                                               ('train', (TRAIN_BATCH,
                                                          TRAIN_FRAMES,
                                                          HIDDEN))):
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split('.')[-1]
                g = torch.Generator().manual_seed(25)
                xw = (torch.randn(batch, frames, 4 * hidden, generator=g) *
                      0.5).to('cuda', dtype)
                wh = torch.nn.init.orthogonal_(
                    torch.empty(hidden, 4 * hidden), generator=g).to('cuda',
                                                                     dtype)
                carry = (torch.randn(batch, hidden, generator=g).cuda(),
                         (torch.rand(batch, hidden, generator=g) * 2 - 1)
                         .cuda())
                got, (c, h) = lstm_scan(xw, wh, initial_carry=carry,
                                        return_carry=True)
                ref, (ref_c, ref_h) = lstm_scan_plain(
                    xw, wh, initial_carry=carry, return_carry=True)
                err = max(float((got.float() - ref.float()).abs().max()),
                          float((h - ref_h).abs().max()))
                require(err <= LSTM_TOL[name], f'carried B ({label}, {name}) '
                        f'off its plain version by {err}')
                state, pieces = carry, []
                for start in range(0, frames, CARRY_CHUNK):
                    piece, state = lstm_scan(
                        xw[:, start: start + CARRY_CHUNK].contiguous(), wh,
                        initial_carry=state, return_carry=True)
                    pieces.append(piece)
                require(torch.equal(torch.cat(pieces, 1), got) and
                        torch.equal(state[0], c) and torch.equal(state[1], h),
                        f'carried B ({label}, {name}): chunks differ from '
                        f'one launch')
                reps = 200 if frames == 1 else 20
                zeros = tuple(torch.zeros_like(x) for x in carry)
                runs = {'plain': lambda: lstm_scan(xw, wh),
                        'carried': lambda: lstm_scan(
                            xw, wh, initial_carry=carry, return_carry=True),
                        'zero_carry': lambda: lstm_scan(
                            xw, wh, initial_carry=zeros, return_carry=True)}
                times = {}
                for turn in ('plain', 'carried', 'zero_carry', 'zero_carry',
                             'carried', 'plain'):
                    times.setdefault(turn, []).append(time_ms(runs[turn],
                                                              reps))
                # xw and W_h read, h written, the carry read and written
                flops, num_bytes = scan_cost(batch, frames, hidden, dtype,
                                             carried=True)
                least, bound_by = bound_ms(
                    num_bytes, flops, PEAK_BF16_FLOPS
                    if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
                entry = {'shape': [batch, frames, hidden],
                         'carried_ms': float(np.mean(times['carried'])),
                         'zero_carry_ms': float(np.mean(times['zero_carry'])),
                         'uncarried_ms': float(np.mean(times['plain'])),
                         'bound_ms': least, 'bound_by': bound_by,
                         'max_abs_err': err}
                result[f'{label}_{name}'] = entry
                log(f'carried B {label} {name} {tuple(entry["shape"])}: '
                    f'{entry["carried_ms"]:.4f} ms, from a zero carry '
                    f'{entry["zero_carry_ms"]:.4f}, without a carry '
                    f'{entry["uncarried_ms"]:.4f} (in turns {times}), bound '
                    f'{least:.5f} ({bound_by}), max error {err:.3g}, chunks '
                    f'of {CARRY_CHUNK} bit for bit ({card})')

    return result


class FrameTimer:
    """An estimator stand-in that records when each frame's predictions
    reach the host, and the raw maps it is given."""

    def __init__(self):
        self.stamps = []

    def process_track(self, predictions, track_id=None):
        self.stamps.append(time.perf_counter())
        return {}

    def reset_state(self):
        pass


def carried_frames(model, frames, device):
    """The online model fed one (C, F, 1) frame a forward with its carries
    threaded: the raw logits (T, O) and the finalized maps (O, T) of each
    key, on the host."""

    import torch

    from amt_tools_tpu_torch import tools

    model = model.to(device).eval()
    carries = model.init_carries(1, device)
    logits, maps = {}, {}
    with torch.no_grad():
        for frame in frames:
            feats = model.pre_proc({tools.KEY_FEATS: torch.as_tensor(
                frame[None]).to(device)})[tools.KEY_FEATS]
            raw, carries = model(feats, carries=carries)
            final = model.post_proc({tools.KEY_OUTPUT: raw})
            for key, value in raw.items():
                logits.setdefault(key, []).append(value[0].float().cpu())
                maps.setdefault(key, []).append(final[key][0].float().cpu())

    return ({key: torch.cat(v).numpy() for key, v in logits.items()},
            {key: torch.cat(v, -1).numpy() for key, v in maps.items()})


def stream_online(card, batch):
    """Phase 25: OnsetsFramesOnline at complexity 3 (float32, random
    weights) on MelSpec at 16 kHz, through ``run_online_stateful`` over a
    10 s track, one frame a step: kernel B from the carry twice a frame;
    median and p99 ms a frame (from a frame's dispatch to its predictions
    on the host) against the 32 ms hop; the card's logits against the
    CPU's within ``LOGIT_TOL``; an ``AudioStream`` over the track's audio
    feeding the same steps gives the maps ``run_online_stateful`` gives on
    the stream's frames; then the online model's whole-sequence training
    step (kernels E and F twice a step). Returns B's carried launches,
    the timings and profiler entries for 10 streamed frames and for the
    training step."""

    import copy

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import AudioStream, MelSpec
    from amt_tools_tpu_torch.inference import run_online_stateful
    from amt_tools_tpu_torch.models import OnsetsFramesOnline
    from amt_tools_tpu_torch.train import (_place_batch, make_train_step,
                                           step_generator)

    profile = tools.PianoProfile()
    mel = MelSpec(n_mels=N_MELS)
    model = OnsetsFramesOnline(dim_in=N_MELS, profile=profile,
                               model_complexity=3,
                               generator=torch.Generator().manual_seed(25))
    audio = render_clips(profile, 1, STREAM_SECONDS)[0]
    feats = mel.process_audio(audio)
    track = {tools.KEY_FEATS: feats, tools.KEY_TIMES: mel.get_times(audio),
             tools.KEY_TRACK: 'stream'}
    frames = feats.shape[-1]

    with tools.exact_fp32():
        run_online_stateful(dict(track), model)  # warm-up
        timer = FrameTimer()
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        predictions = run_online_stateful(dict(track), model, timer)
        elapsed = time.perf_counter() - start
        launches = read_launches()
        per_frame = np.diff([start] + timer.stamps) * 1e3
        median, p99 = np.percentile(per_frame, [50, 99])
        log(f'run_online_stateful, O&F online complexity 3 float32, '
            f'{frames} frames of {STREAM_SECONDS:.0f} s: {elapsed:.3f} s, '
            f'median {median:.3f} ms a frame, p99 {p99:.3f}, max '
            f'{per_frame.max():.3f} against the {1e3 * HOP / SAMPLE_RATE:.0f} '
            f'ms hop ({card}); launches {launches}')
        require(launches['lstm_scan'] == 2 * frames and
                launches['lstm_scan_carried'] == 2 * frames,
                'streaming did not run kernel B from the carry twice a frame')
        require(launches['lstm_scan_residuals'] == launches['lstm_bptt'] == 0,
                'kernel E or F ran while streaming')
        require(predictions[tools.KEY_MULTIPITCH].shape == (profile.
                                                             get_range_len(),
                                                             frames),
                'run_online_stateful shape')

        columns = [feats[..., t: t + 1] for t in range(frames)]
        card_logits, card_maps = carried_frames(model, columns, 'cuda')
        cpu_logits, _ = carried_frames(copy.deepcopy(model), columns, 'cpu')
        err = max(float(np.abs(card_logits[k] - cpu_logits[k]).max())
                  for k in cpu_logits)
        log(f'streaming logits, card against CPU over {frames} frames: max '
            f'{err:.3g} (tolerance {LOGIT_TOL})')
        require(err <= LOGIT_TOL, 'the streaming logits on the card are off '
                                  'the CPU\'s')
        for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
            require(np.array_equal(card_maps[key], predictions[key]),
                    f'run_online_stateful\'s {key} differs from the same '
                    f'steps run frame by frame')

        stream = AudioStream(mel, audio=audio)
        stream.start_streaming()
        stream_frames = []
        while not stream.query_finished():
            stream_frames.append(stream.extract_frame_features())
        stream.stop_streaming()
        require(len(stream_frames) == frames,
                f'the stream gave {len(stream_frames)} frames, the track '
                f'{frames}')
        _, fed = carried_frames(model, stream_frames, 'cuda')
        stacked = run_online_stateful(
            {tools.KEY_FEATS: np.concatenate(stream_frames, -1),
             tools.KEY_TIMES: track[tools.KEY_TIMES]}, model)
        for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
            require(np.array_equal(fed[key], stacked[key]),
                    f'the stream fed frame by frame gave other {key} maps '
                    f'than run_online_stateful on its frames')
        log(f'AudioStream: {len(stream_frames)} frames fed one a step, maps '
            f'equal to run_online_stateful on the stacked frames')

    # The online model's whole-sequence training step: E and F twice a step
    trained = OnsetsFramesOnline(dim_in=N_MELS, profile=profile,
                                 model_complexity=3,
                                 generator=torch.Generator().manual_seed(26))
    train_run(trained, FixedLoader([batch]), 3,
              f'3 float32 steps of O&F online (unidirectional LMs) on one '
              f'batch ({card})', recurrences=2)
    profiled = copy.deepcopy(trained).cuda()
    step = make_train_step(profiled, torch.optim.Adam(profiled.parameters(),
                                                      lr=LEARNING_RATE))
    device_batch = _place_batch(batch, torch.device('cuda'))
    step(device_batch, step_generator(0, 0, 'cuda'))

    ten = {tools.KEY_FEATS: feats[..., :10],
           tools.KEY_TIMES: track[tools.KEY_TIMES][:10]}
    return launches['lstm_scan_carried'], {
        'frames': frames, 'median_ms': float(median), 'p99_ms': float(p99),
        'max_logit_err': err}, (
        '10 streamed frames of O&F online',
        lambda: run_online_stateful(dict(ten), model),
        ('lstm_scan_kernel',)), (
        f'float32 O&F online training step of {TRAIN_BATCH} x '
        f'{TRAIN_FRAMES} frames',
        lambda: step(device_batch, step_generator(0, 1, 'cuda')),
        ('lstm_scan_kernel', 'lstm_bptt_kernel'))



# Phases 26-30: real corpora. The corpora are written by the port's own
# writers in the layouts of tests/fixtures/corpora.py, under a temporary
# directory of the repository (git-ignored)
MAESTRO_TRAIN_TRACKS = 16
MAESTRO_TRAIN_SECONDS = 30.0
MAESTRO_EVAL_TRACKS = 2       # validation and test, each
MAESTRO_EVAL_SECONDS = 60.0
MAPS_SPLITS = ('ENSTDkAm', 'ENSTDkCl')
MAPS_TRACKS = 2               # a split
MAPS_SECONDS = 30.0
LOADER_WORKERS = 4
GSET_PLAYERS = 6
GSET_TRACKS = 60              # a player: the loader's block of tracks
GSET_SECONDS = 5.0
GSET_BATCH = 30               # examples/papers/tabcnn.py
GSET_FRAMES = 200
HCQT_CLIPS = 8
HCQT_SECONDS = 30.0
HCQT_HARMONICS = (0.5, 1, 2, 3, 4, 5)   # DeepSalience's
HCQT_BINS = 72
# tools.write_notes_midi's grid: 480 ticks a beat at 120 bpm
MIDI_TICK_S = 0.5 / 480


def piano_piece(rng, seconds, profile):
    """About 2 notes a second, velocities 30-120, and no two notes of a
    pitch closer than 50 ms, so that the MIDI file pairs each note on with
    its own note off: (batched notes (N, 3) in onset order, velocities)."""

    notes, spans = [], {}
    while len(notes) < int(2 * seconds):
        pitch = int(rng.randint(profile.low + 12, profile.high - 11))
        onset = rng.uniform(0.05, seconds - 0.6)
        offset = onset + rng.uniform(0.1, 0.5)
        if any(onset < off + 0.05 and on < offset + 0.05
               for on, off in spans.get(pitch, [])):
            continue
        spans.setdefault(pitch, []).append((onset, offset))
        notes.append((onset, offset, pitch, rng.randint(30, 121)))
    notes = np.array(sorted(notes))

    return notes[:, :3], notes[:, 3].astype(int)


def write_piano_track(directory, stem, extension, rng, seconds):
    """A rendered piece as ``<stem>.wav`` and ``<stem>.<extension>``; its
    written notes and velocities."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import render_notes

    notes, velocities = piano_piece(rng, seconds, tools.PianoProfile())
    audio = render_notes(notes[:, 2], notes[:, :2], SAMPLE_RATE, seconds,
                         seed=int(rng.randint(2 ** 31)),
                         velocities=velocities / 127)
    path = os.path.join(directory, stem)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tools.write_wav(f'{path}.wav', audio, SAMPLE_RATE)
    tools.write_notes_midi(f'{path}.{extension}', notes, velocities)

    return notes, velocities


def write_corpora(root):
    """MAESTRO-, MAPS- and GuitarSet-layout corpora under ``root`` (the
    layouts of ``tests/fixtures/corpora.py``), by the port's writers.
    Returns their directories and the notes written, by track."""

    import csv

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import render_notes

    rng = np.random.RandomState(26)
    written = {}

    maestro = os.path.join(root, 'MAESTRO_V3')
    rows = []
    for split, count, seconds in (
            ('train', MAESTRO_TRAIN_TRACKS, MAESTRO_TRAIN_SECONDS),
            ('validation', MAESTRO_EVAL_TRACKS, MAESTRO_EVAL_SECONDS),
            ('test', MAESTRO_EVAL_TRACKS, MAESTRO_EVAL_SECONDS)):
        for index in range(count):
            stem = f'2018/MIDI-Unprocessed_{split}_{index:02d}'
            written[stem] = write_piano_track(maestro, stem, tools.MIDI_EXT,
                                              rng, seconds)
            # A title with a comma: the CSV's quoting is read
            rows.append([f'Sonata, Op. {index}', split, f'{stem}.wav'])
    with open(os.path.join(maestro, 'maestro-v3.0.0.csv'), 'w',
              newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['canonical_title', 'split', 'audio_filename'])
        writer.writerows(rows)

    maps = os.path.join(root, 'MAPS')
    for piano in MAPS_SPLITS:
        for index in range(MAPS_TRACKS):
            stem = f'MAPS_MUS-piece{index}_{piano}'
            directory = os.path.join(maps, piano, 'MUS')
            written[stem] = write_piano_track(directory, stem, tools.MID_EXT,
                                              rng, MAPS_SECONDS)
            open(os.path.join(directory, f'{stem}.txt'), 'w').close()

    gset = os.path.join(root, 'GuitarSet')
    profile = tools.GuitarProfile(num_frets=19)
    tuning = profile.get_midi_tuning()
    for folder in ('annotation', 'audio_mono-mic'):
        os.makedirs(os.path.join(gset, folder))
    num_samples = int(GSET_SECONDS * GUITAR_SAMPLE_RATE)
    for player in range(GSET_PLAYERS):
        for index in range(GSET_TRACKS):
            track = f'{player:02d}_Smoke{index:02d}-{player}_solo'
            stacked, audio = {}, np.zeros(num_samples, np.float32)
            for string, open_pitch in enumerate(tuning):
                count = rng.randint(2, 5)
                onsets = np.sort(rng.uniform(0.05, GSET_SECONDS - 0.6, count))
                offsets = np.minimum(onsets + rng.uniform(0.2, 0.6, count),
                                     np.append(onsets[1:] - 0.02,
                                               GSET_SECONDS - 0.05))
                pitches = (open_pitch + rng.randint(0, profile.num_pitches,
                                                    count)).astype(float)
                intervals = np.stack([onsets, offsets], axis=-1)
                stacked[string] = (pitches, intervals)
                audio += render_notes(pitches, intervals, GUITAR_SAMPLE_RATE,
                                      GSET_SECONDS, harmonics=2 + string,
                                      decay=2.0 + 0.7 * string,
                                      seed=int(rng.randint(2 ** 31)))
            tools.write_stacked_notes_jams(
                stacked, os.path.join(gset, 'annotation', f'{track}.jams'),
                duration=GSET_SECONDS)
            tools.write_wav(os.path.join(gset, 'audio_mono-mic',
                                         f'{track}_mic.wav'),
                            audio / max(1.0, np.abs(audio).max()),
                            GUITAR_SAMPLE_RATE)

    return {'root': root, 'maestro': maestro, 'maps': maps, 'gset': gset,
            'notes': written}


def check_written_notes(dataset, written):
    """The notes (and MIDI velocities) ``dataset`` loads for each of its
    tracks equal the notes written, within half a tick of the MIDI grid;
    the velocity map holds each note's velocity on the MIDI scale."""

    from amt_tools_tpu_torch import tools

    for track in dataset.tracks:
        data = dataset.load(track)
        # Both in the order of their onsets' ticks, then pitch: two onsets
        # may round to one tick
        got = data[tools.KEY_NOTES]
        got = got[np.lexsort((got[:, 2], np.round(got[:, 0] / MIDI_TICK_S)))]
        notes, velocities = written[track]
        order = np.lexsort((notes[:, 2], np.round(notes[:, 0] / MIDI_TICK_S)))
        notes, velocities = notes[order], velocities[order]
        require(got.shape == notes.shape,
                f'{track}: {len(got)} notes read, {len(notes)} written')
        require(np.array_equal(got[:, 2], notes[:, 2]),
                f'{track}: the pitches read are not the ones written')
        err = float(np.abs(got[:, :2] - notes[:, :2]).max())
        require(err <= MIDI_TICK_S / 2 + 1e-9,
                f'{track}: note times {err:.3g} s off the written ones')
        # Each onset frame holds the note's velocity, or a louder
        # neighbour's of the same pitch (the map keeps the louder)
        times = dataset.data_proc.get_times(data[tools.KEY_AUDIO])
        frames = np.searchsorted(times, got[:, 0], side='right') - 1
        rows = got[:, 2].astype(int) - dataset.profile.low
        held = data[tools.KEY_VELOCITY][rows, frames]
        require(np.all(held >= velocities / 127 - 1e-6) and
                np.mean(np.isclose(held, velocities / 127)) > 0.9,
                f'{track}: the velocity map does not hold the written '
                f'velocities')

    return len(dataset.tracks)


class RecordedFeatures:
    """Wraps a dataset's ``calculate_feats``: the features each track got,
    by track (loader threads write their own tracks)."""

    def __init__(self, dataset):
        from amt_tools_tpu_torch.tools import KEY_FEATS, KEY_TRACK

        self.feats = {}
        calculate = dataset.calculate_feats

        def record(data):
            out = calculate(data)
            self.feats[out[KEY_TRACK]] = out[KEY_FEATS]
            return out

        dataset.calculate_feats = record


class LoaderTimer:
    """Wraps a loader's ``_make_batch``, which its worker threads run: the
    host seconds each batch took to load (crops, ground truth, features
    from the cache or the card) and collate."""

    def __init__(self, loader):
        self.seconds = []
        make_batch = loader._make_batch

        def timed(*args):
            start = time.perf_counter()
            batch = make_batch(*args)
            self.seconds.append(time.perf_counter() - start)
            return batch

        loader._make_batch = timed


class ValidationTimer:
    """Wraps ``train``'s ``validate``: the seconds its validations took."""

    def __init__(self):
        from amt_tools_tpu_torch import train as train_module

        self.module = train_module
        self.validate = train_module.validate
        self.seconds = 0.0

    def __enter__(self):
        def timed(*args, **kwargs):
            start = time.perf_counter()
            out = self.validate(*args, **kwargs)
            self.seconds += time.perf_counter() - start
            return out

        self.module.validate = timed
        return self

    def __exit__(self, *_):
        self.module.validate = self.validate


def of2_on_maestro(card, corpora):
    """Phase 26: the of_2 recipe (``examples/papers/of_2.py``) on the
    MAESTRO-layout corpus: O&F2 at complexity 3 in float32 on HTK mels at
    16 kHz, ``MAESTRO_V3(store_data=False, save_data=True)`` on a fresh
    cache, 625-frame crops, ``DataLoader(batch_size=8, drop_last=True,
    num_workers=4)``, Adam 6e-4, one pass through ``train()`` with one
    checkpoint that validates the validation split. First with the cache
    cold: the loader's threads compute every train track's features on the
    card (kernel A once a track read, plus once a validation track) and
    write the npz files. Then with it warm, on new datasets: kernel A never
    runs, and every track's features read back equal the cold pass's bit
    for bit. E and F three times a step; steps/s and the loader's host ms a
    batch in each pass. Then one track's features on the card against the
    CPU's, and the notes MAESTRO loads against the notes written. Returns
    the model, the launches and rates, and the step the profiler runs."""

    import tempfile

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import MAESTRO_V3, DataLoader
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.train import (_place_batch, make_train_step,
                                           step_generator, train)

    profile = tools.PianoProfile()
    mel = MelSpec(sample_rate=SAMPLE_RATE, hop_length=HOP, n_mels=N_MELS,
                  htk=True)
    save_loc = os.path.join(corpora['root'], 'cache')

    def partition(split, num_frames):
        return MAESTRO_V3(base_dir=corpora['maestro'], splits=[split],
                          hop_length=HOP, sample_rate=SAMPLE_RATE,
                          num_frames=num_frames, data_proc=mel,
                          profile=profile, store_data=False, save_data=True,
                          save_loc=save_loc)

    model = OnsetsFrames2(dim_in=N_MELS, profile=profile, model_complexity=3,
                          generator=torch.Generator().manual_seed(26))
    optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
    passes = {}
    for cache in ('cold', 'warm'):
        train_set = partition('train', TRAIN_FRAMES)
        val_set = partition('validation', None)
        recorded = RecordedFeatures(train_set)
        recorded_val = RecordedFeatures(val_set)
        loader = DataLoader(train_set, batch_size=TRAIN_BATCH, shuffle=True,
                            drop_last=True, seed=0,
                            num_workers=LOADER_WORKERS)
        timer = LoaderTimer(loader)
        estimator, evaluator = of2_recipe()
        with tempfile.TemporaryDirectory(prefix='_chip_smoke_train_',
                                         dir=ROOT) as log_dir, \
                ValidationTimer() as validation:
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            result = train(model, loader, optimizer, 1, checkpoints=1,
                           log_dir=log_dir, val_set=val_set,
                           estimator=estimator, evaluator=evaluator,
                           resume=False)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
        launches = read_launches()
        steps = result['step']
        training = elapsed - validation.seconds
        passes[cache] = {
            'steps_per_s': steps / training,
            'loader_host_ms_a_batch': 1e3 * float(np.mean(timer.seconds)),
            'validation_s': validation.seconds, 'launches': launches,
            'feats': recorded.feats, 'val_feats': recorded_val.feats}
        log(f'of_2 recipe on MAESTRO crops, {cache} cache, '
            f'{LOADER_WORKERS} loader threads: {steps} steps in '
            f'{training:.3f} s ({steps / training:.3f} steps/s), the '
            f'loader\'s host {passes[cache]["loader_host_ms_a_batch"]:.1f} '
            f'ms a batch ({len(timer.seconds)} batches, in its threads), '
            f'validation of {len(val_set.tracks)} tracks '
            f'{validation.seconds:.3f} s ({card}); launches {launches}')
        for key, values in sorted(result['losses'].items()):
            log(f'  {key}: ' + ' '.join(f'{v:.6g}' for v in values))
        require(steps == MAESTRO_TRAIN_TRACKS // TRAIN_BATCH,
                f'{steps} steps, not one pass')
        require(all(np.isfinite(v).all() for v in result['losses'].values()),
                'a MAESTRO training loss is not finite')
        require(launches['lstm_scan_residuals'] == 3 * steps and
                launches['lstm_bptt'] == 3 * steps,
                'kernels E and F did not run three times a step')
        require(launches['lstm_scan_masked'] == 3 * len(val_set.tracks) and
                launches['lstm_scan'] == launches['lstm_scan_masked'],
                'the validation did not run masked kernel B three times a '
                'track')
        require(validation.seconds > 0, 'train() did not validate')
        read = len(recorded.feats) + len(recorded_val.feats)
        require(len(recorded.feats) == MAESTRO_TRAIN_TRACKS and
                len(recorded_val.feats) == len(val_set.tracks),
                'a track was not read in the pass')
        if cache == 'cold':
            require(launches['stft_power'] == read and
                    launches['stft_power_fft'] == read,
                    f'kernel A ran {launches["stft_power"]} times for '
                    f'{read} tracks read with the cache cold')
            cached = sorted(
                os.path.relpath(os.path.join(d, f), train_set.get_feats_dir())
                for d, _, files in os.walk(train_set.get_feats_dir())
                for f in files)
            require(cached == sorted(f'{t}.npz' for t in
                                     train_set.tracks + val_set.tracks),
                    f'the feature cache holds {cached}')
        else:
            require(launches['stft_power'] == 0,
                    'kernel A ran with the cache warm')
            for track, feats in recorded.feats.items():
                cold = passes['cold']['feats'][track]
                require(feats.dtype == cold.dtype and
                        np.array_equal(feats, cold),
                        f'{track}: the warm cache\'s features differ from '
                        f'the cold pass\'s')

    # One track's features on the card against the CPU's
    test_set = partition('test', None)
    audio = test_set.load(test_set.tracks[0])[tools.KEY_AUDIO]
    err = float(np.abs(mel.process_audio(audio) -
                       mel.process_audio(audio, device='cpu')).max())
    log(f'MAESTRO features of {test_set.tracks[0]} '
        f'({len(audio) / SAMPLE_RATE:.0f} s), card against CPU: max {err:.3g} '
        f'(tolerance {MEL_FEATURE_TOL})')
    require(err <= MEL_FEATURE_TOL, 'the corpus features on the card are '
                                    'off the CPU\'s')
    checked = check_written_notes(partition('train', None),
                                  corpora['notes'])
    log(f'MAESTRO ground truth: the notes and velocities of {checked} '
        f'tracks as written, within half a MIDI tick '
        f'({1e3 * MIDI_TICK_S / 2:.3f} ms)')

    # The profiler's step: a batch from the warm cache in the main thread
    # (the loader's host time inside the range), then the step
    loader = DataLoader(partition('train', TRAIN_FRAMES),
                        batch_size=TRAIN_BATCH, shuffle=True, drop_last=True,
                        seed=1)
    step = make_train_step(model, optimizer)

    def profiled():
        batch = next(iter(loader))
        step(_place_batch(batch, torch.device('cuda')),
             step_generator(0, 0, 'cuda'))

    rates = {cache: {key: passes[cache][key] for key in
                     ('steps_per_s', 'loader_host_ms_a_batch',
                      'validation_s')} for cache in passes}
    return model, passes, rates, (
        f'of_2 step on {TRAIN_BATCH} MAESTRO crops of {TRAIN_FRAMES} frames '
        f'(warm npz cache, the batch loaded inside the range)', profiled,
        ('lstm_scan_kernel', 'lstm_bptt_kernel'))


def validate_corpora(card, corpora, model):
    """Phase 27: ``validate`` on the MAESTRO test split and the MAPS-layout
    ENSTDkAm and ENSTDkCl splits (MIDI ground truth through
    ``load_notes_midi`` and its sustain-pedal pairing; notes checked
    against those written), the of_2 recipe's estimator and evaluator,
    bucketed by 128 frames: kernel A once a track (the caches cold), masked
    B three times a track; tracks/s. Returns masked B's launches."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import MAESTRO_V3, MAPS
    from amt_tools_tpu_torch.features import MelSpec

    profile = tools.PianoProfile()
    mel = MelSpec(sample_rate=SAMPLE_RATE, hop_length=HOP, n_mels=N_MELS,
                  htk=True)
    save_loc = os.path.join(corpora['root'], 'cache')
    sets = {
        'MAESTRO test': MAESTRO_V3(base_dir=corpora['maestro'],
                                   splits=['test'], data_proc=mel,
                                   profile=profile, store_data=False,
                                   save_loc=save_loc),
        'MAPS ENSTDkAm + ENSTDkCl': MAPS(base_dir=corpora['maps'],
                                         splits=list(MAPS_SPLITS),
                                         data_proc=mel, profile=profile,
                                         store_data=False,
                                         save_loc=save_loc)}
    checked = check_written_notes(sets['MAPS ENSTDkAm + ENSTDkCl'],
                                  corpora['notes'])
    log(f'MAPS ground truth: the notes and velocities of {checked} tracks as '
        f'written, within half a MIDI tick')

    model.eval()
    masked = {}
    for name, dataset in sets.items():
        estimator, evaluator = of2_recipe()
        results, launches, elapsed, timer = validate_timed(
            model, dataset, estimator, evaluator, 1)
        tracks = len(dataset.tracks)
        masked[name] = launches['lstm_scan_masked']
        log(f'validate {name}, {tracks} tracks: {elapsed:.3f} s, '
            f'{tracks / elapsed:.3f} tracks/s, host estimators and metrics '
            f'{timer.seconds:.3f} s ({card}); launches {launches}')
        for group, scores in sorted(results.items()):
            log(f'  {group}: ' + ', '.join(f'{k} {v:.6g}'
                                           for k, v in sorted(scores.items())))
        require(launches['stft_power'] == tracks,
                f'{name}: kernel A did not run once a track')
        require(launches['lstm_scan_masked'] == 3 * tracks and
                launches['lstm_scan'] == 3 * tracks,
                f'{name}: masked kernel B did not run three times a track')
    torch.cuda.synchronize()

    return masked


def tabcnn_on_guitarset(card, corpora):
    """Phase 28: the tabcnn recipe (``examples/papers/tabcnn.py``) on the
    GuitarSet-layout corpus, fold 0: TabCNN at paper width in float32 on
    CQT(22050, 512, n_bins=192, bins_per_octave=24) (exact, the full bank:
    kernel C on its FFMA route), players 01-05 cropped to 200 frames,
    batch 30, Adadelta 1.0, one pass of ``train()`` validating player 00
    once with the recipe's estimator and evaluators. With the cache cold C
    runs once a track (360); then new datasets on the warm cache train one
    more pass without validation and C never runs. Returns C's launches,
    the rates and the step the profiler runs."""

    import tempfile

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import DataLoader, GuitarSet
    from amt_tools_tpu_torch.evaluate import (ComboEvaluator, LossWrapper,
                                              MultipitchEvaluator,
                                              SoftmaxAccuracy,
                                              TablatureEvaluator)
    from amt_tools_tpu_torch.features import CQT
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.train import (_place_batch, make_train_step,
                                           step_generator, train)
    from amt_tools_tpu_torch.transcribe import (ComboEstimator,
                                                StackedMultiPitchCollapser,
                                                TablatureWrapper)

    tools.use_exact_fp32()
    profile = tools.GuitarProfile(num_frets=19)
    cqt = CQT(sample_rate=GUITAR_SAMPLE_RATE, hop_length=HOP, n_bins=192,
              bins_per_octave=24)
    save_loc = os.path.join(corpora['root'], 'cache')
    splits = GuitarSet.available_splits()
    train_splits, test_splits = splits[1:], splits[:1]

    def partitions():
        train_set = GuitarSet(base_dir=corpora['gset'], splits=train_splits,
                              hop_length=HOP, sample_rate=GUITAR_SAMPLE_RATE,
                              num_frames=GSET_FRAMES, data_proc=cqt,
                              profile=profile, save_loc=save_loc)
        test_set = GuitarSet(base_dir=corpora['gset'], splits=test_splits,
                             hop_length=HOP, sample_rate=GUITAR_SAMPLE_RATE,
                             num_frames=None, data_proc=cqt, profile=profile,
                             store_data=True, save_loc=save_loc)
        return train_set, test_set

    estimator = ComboEstimator([TablatureWrapper(profile=profile),
                                StackedMultiPitchCollapser(profile=profile)])
    evaluator = ComboEvaluator([LossWrapper(), MultipitchEvaluator(),
                                TablatureEvaluator(profile=profile),
                                SoftmaxAccuracy()])
    evaluator.set_patterns(['loss', 'pr', 're', 'f1', 'tdr', 'acc'])

    model = TabCNN(dim_in=cqt.get_feature_size(), profile=profile,
                   in_channels=cqt.get_num_channels(),
                   generator=torch.Generator().manual_seed(28))
    optimizer = torch.optim.Adadelta(model.parameters(), lr=1.0)
    rates, launches = {}, {}
    for cache in ('cold', 'warm'):
        start = time.perf_counter()
        train_set, test_set = partitions()
        log(f'GuitarSet fold 0, {cache} cache: {len(train_set.tracks)} + '
            f'{len(test_set.tracks)} tracks\' ground truth in '
            f'{time.perf_counter() - start:.1f} s')
        require(len(train_set.tracks) == 5 * GSET_TRACKS and
                len(test_set.tracks) == GSET_TRACKS,
                'the players\' blocks are not 60 tracks each')
        loader = DataLoader(train_set, batch_size=GSET_BATCH, shuffle=True,
                            drop_last=True, seed=0)
        validated = cache == 'cold'
        with tempfile.TemporaryDirectory(prefix='_chip_smoke_train_',
                                         dir=ROOT) as log_dir, \
                ValidationTimer() as validation:
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            result = train(model, loader, optimizer, 1, checkpoints=1,
                           log_dir=log_dir, resume=False,
                           val_set=test_set if validated else None,
                           estimator=estimator, evaluator=evaluator)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
        launches[cache] = read_launches()
        steps = result['step']
        training = elapsed - validation.seconds
        rates[cache] = {'steps_per_s': steps / training,
                        'validation_s': validation.seconds}
        losses = result['losses'][tools.KEY_LOSS_TOTAL]
        log(f'tabcnn recipe on GuitarSet crops, {cache} cache: {steps} '
            f'Adadelta steps of {GSET_BATCH} x {GSET_FRAMES} frames in '
            f'{training:.3f} s ({steps / training:.3f} steps/s, features '
            f'included when cold), validation {validation.seconds:.3f} s '
            f'({card}); loss {losses[0]:.6g} -> {losses[-1]:.6g}; launches '
            f'{launches[cache]}')
        require(steps == 5 * GSET_TRACKS // GSET_BATCH,
                f'{steps} steps, not one pass')
        require(all(np.isfinite(losses)), 'a TabCNN loss is not finite')
        tracks = len(train_set.tracks) + (len(test_set.tracks)
                                          if validated else 0)
        want = tracks if cache == 'cold' else 0
        require(launches[cache]['cqt_mag'] == want and
                launches[cache]['cqt_mag_ffma'] == want,
                f'kernel C ran {launches[cache]["cqt_mag"]} times with the '
                f'cache {cache}, not {want}')
        require(launches[cache]['cqt_mag_grouped'] == 0,
                'kernel D ran in the recipe')
        require((validation.seconds > 0) == validated,
                'train() validated otherwise than asked')

    step = make_train_step(model, optimizer)
    loader = DataLoader(train_set, batch_size=GSET_BATCH, shuffle=True,
                        drop_last=True, seed=1)

    def profiled():
        batch = next(iter(loader))
        step(_place_batch(batch, torch.device('cuda')),
             step_generator(0, 0, 'cuda'))

    return launches, rates, (
        f'tabcnn step on {GSET_BATCH} GuitarSet crops of {GSET_FRAMES} '
        f'frames (RAM cache, the batch loaded inside the range)', profiled,
        ('implicit_gemm',))


def stream_from_file(card, corpora):
    """Phase 29: ``AudioFileStream`` over one of the MAESTRO corpus's WAVs
    (30 s at 16 kHz) feeds OnsetsFramesOnline at complexity 3 (float32,
    random weights) through ``run_online_stateful``: its frames equal an
    ``AudioStream``'s over ``load_normalize_audio`` of the same file bit for
    bit, kernel A once a frame, carried B twice a frame; ms a frame (the
    frame's features, then its step) against the 32 ms hop. Returns A's and
    carried B's launches and the timings."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import (AudioFileStream, AudioStream,
                                              MelSpec)
    from amt_tools_tpu_torch.inference import run_online_stateful
    from amt_tools_tpu_torch.models import OnsetsFramesOnline

    track = sorted(t for t in corpora['notes'] if '_train_' in t)[0]
    path = os.path.join(corpora['maestro'], f'{track}.{tools.WAV_EXT}')
    mel = MelSpec(n_mels=N_MELS)
    model = OnsetsFramesOnline(dim_in=N_MELS, profile=tools.PianoProfile(),
                               model_complexity=3,
                               generator=torch.Generator().manual_seed(29))

    def frames_of(stream, stamps=None):
        stream.start_streaming()
        frames = []
        while not stream.query_finished():
            frames.append(stream.extract_frame_features())
            if stamps is not None:
                stamps.append(time.perf_counter())
        stream.stop_streaming()
        return frames

    audio, _ = tools.load_normalize_audio(path, fs=SAMPLE_RATE)
    want = frames_of(AudioStream(mel, audio=audio))
    with tools.exact_fp32():
        run_online_stateful({tools.KEY_FEATS: want[0],
                             tools.KEY_TIMES: np.zeros(1)}, model)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        stamps = []
        start = time.perf_counter()
        got = frames_of(AudioFileStream(mel, audio_path=path), stamps)
        feature_launches = read_launches()
        timer = FrameTimer()
        steps_start = time.perf_counter()
        run_online_stateful({tools.KEY_FEATS: np.concatenate(got, -1),
                             tools.KEY_TIMES: mel.get_times(audio)}, model,
                            timer)
        launches = read_launches()
    frames = len(got)
    feature_ms = np.diff([start] + stamps) * 1e3
    step_ms = np.diff([steps_start] + timer.stamps) * 1e3
    per_frame = feature_ms + step_ms
    median, p99 = np.percentile(per_frame, [50, 99])
    log(f'AudioFileStream over {track}.wav ({len(audio) / SAMPLE_RATE:.0f} '
        f's), {frames} frames through OnsetsFramesOnline complexity 3 '
        f'float32: median {median:.3f} ms a frame (features '
        f'{np.median(feature_ms):.3f}, step {np.median(step_ms):.3f}), p99 '
        f'{p99:.3f}, against the {1e3 * HOP / SAMPLE_RATE:.0f} ms hop '
        f'({card}); launches {launches}')
    require(frames == len(want) and all(
        np.array_equal(g, w) for g, w in zip(got, want)),
        'the file stream\'s frames differ from the AudioStream\'s')
    require(feature_launches['stft_power'] == frames,
            'the stream did not run kernel A once a frame')
    require(launches['lstm_scan_carried'] == 2 * frames and
            launches['lstm_scan'] == 2 * frames,
            'streaming from the file did not run kernel B from the carry '
            'twice a frame')

    return feature_launches['stft_power'], launches['lstm_scan_carried'], {
        'frames': frames, 'median_ms': float(median), 'p99_ms': float(p99),
        'feature_median_ms': float(np.median(feature_ms)),
        'step_median_ms': float(np.median(step_ms))}


def check_hcqt(card):
    """Phase 30: HCQT at DeepSalience's harmonics [0.5, 1, 2, 3, 4, 5],
    22,050 Hz, hop 512, fmin C1, 72 bins at 12 an octave (the top bin of
    harmonic 5 at 9.9 kHz) over 8 rendered clips of 30 s: kernel C once a
    harmonic on its FFMA route, the [0, 1] features within
    ``CQT_FEATURE_TOL`` of the CPU's (plain versions); beside it
    ``SignalPower`` (torch ops) against the CPU and a ``FeatureCombo`` of a
    CQT and a two-harmonic HCQT (kernel C three times). Returns C's
    launches."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import (CQT, HCQT, FeatureCombo,
                                              SignalPower)

    clips = render_clips(tools.GuitarProfile(num_frets=19), HCQT_CLIPS,
                         HCQT_SECONDS, GUITAR_SAMPLE_RATE)
    audio = torch.from_numpy(clips)
    card_audio = audio.cuda()
    hcqt = HCQT(sample_rate=GUITAR_SAMPLE_RATE, hop_length=HOP,
                harmonics=list(HCQT_HARMONICS), n_bins=HCQT_BINS,
                bins_per_octave=12)
    top = hcqt.modules[-1].fmin * 2 ** ((HCQT_BINS - 1) / 12)
    combo = FeatureCombo([
        CQT(sample_rate=GUITAR_SAMPLE_RATE, hop_length=HOP, n_bins=HCQT_BINS),
        HCQT(sample_rate=GUITAR_SAMPLE_RATE, hop_length=HOP, harmonics=[1, 2],
             n_bins=HCQT_BINS)])
    power = SignalPower(sample_rate=GUITAR_SAMPLE_RATE, hop_length=HOP)

    with torch.inference_mode():
        hcqt.process(card_audio[:1, :GUITAR_SAMPLE_RATE])  # warm-up
    results = {}
    for name, module, kernels in (('HCQT', hcqt, len(HCQT_HARMONICS)),
                                  (combo.features_name(), combo, 3),
                                  ('SignalPower', power, 0)):
        with torch.inference_mode():
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            got = module.process(card_audio)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
            launches = read_launches()
            start = time.perf_counter()
            want = module.process(audio)
            cpu_ms = (time.perf_counter() - start) * 1e3
        err = float((got.cpu() - want).abs().max())
        tol = POWER_DB_TOL if name == 'SignalPower' else CQT_FEATURE_TOL
        results[name] = launches['cqt_mag']
        log(f'{name} of {HCQT_CLIPS} x {HCQT_SECONDS:.0f} s at '
            f'{GUITAR_SAMPLE_RATE} Hz -> {tuple(got.shape)}: {ms:.1f} ms on '
            f'the card (host clock), {cpu_ms:.0f} ms on the CPU; card against '
            f'CPU max {err:.3g} (tolerance {tol}) ({card}); launches '
            f'{launches}')
        require(err <= tol, f'{name} on the card is off the CPU\'s')
        require(launches['cqt_mag'] == kernels and
                launches['cqt_mag_ffma'] == kernels and
                launches['cqt_mag_grouped'] == 0,
                f'{name} did not run kernel C {kernels} times on its FFMA '
                f'route')
    require(top < GUITAR_SAMPLE_RATE / 2, 'the top bin exceeds Nyquist')
    log(f'HCQT top bin {top:.0f} Hz, under the {GUITAR_SAMPLE_RATE // 2} Hz '
        f'Nyquist frequency')

    return results['HCQT']

# Phases 31-34: parallel/ on the one card. NCCL at world size 1 in this
# process (31, 34); two ranks in spawned processes through gloo (32, 33),
# which on CUDA tensors does broadcast and all_reduce only. No timing of
# the two-rank phases is a scaling figure: two processes share one card
PARALLEL_RANKS = 2
PARALLEL_TIMEOUT = 420.0      # seconds for the spawned ranks, start to join
DP_STEPS = 2
# Phase 33, bf16 two ranks vs one process: a thresholded piano map may
# differ only where the one-process logit is within this of the threshold,
# a tablature cell only where its top-two margin is within twice this (the
# int8 pipelines' bound, tests/test_torch_int8_pipeline.py)
BF16_LOGIT_TOL = 1e-2


def dp_batch(seed):
    """A float32 O&F2 batch at the recipe's shape: features in [0, 1] and
    a sparse multi-pitch map, from ``seed``."""

    from amt_tools_tpu_torch import tools

    rng = np.random.RandomState(seed)
    return {
        tools.KEY_FEATS: rng.rand(TRAIN_BATCH, 1, N_MELS,
                                  TRAIN_FRAMES).astype(np.float32),
        tools.KEY_MULTIPITCH: (rng.rand(TRAIN_BATCH, 88, TRAIN_FRAMES) <
                               0.05).astype(np.float32),
    }


def of2_model(seed, dtype=None):
    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2

    return OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                         model_complexity=3, dtype=dtype,
                         generator=torch.Generator().manual_seed(seed))


def dp_world_one(card):
    """Phase 31: ``train(mesh=get_mesh())`` over NCCL at world size 1
    against ``train()``: O&F2 complexity 3, float32, 8 x 625, dropout on,
    Adam, two steps each, in turns (plain, mesh, mesh, plain) under
    cuDNN's deterministic algorithms; each mesh run's losses, parameters
    and BatchNorm buffers bit for bit the first plain run's, E and F three
    times a step. Returns E's and F's launches a step."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.parallel import get_mesh
    from amt_tools_tpu_torch.train import train

    mesh = get_mesh()
    batch = dp_batch(31)
    runs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for label, run_mesh in (('train()', None), ('train(mesh)', mesh),
                                ('train(mesh) again', mesh),
                                ('train() again', None)):
            model = of2_model(31)
            optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            result = train(model, FixedLoader([batch]), optimizer, DP_STEPS,
                           log_dir=None, seed=0, mesh=run_mesh)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            launches = read_launches()
            runs.append((result['losses'],
                         {k: v.cpu() for k, v in model.state_dict().items()},
                         launches))
            log(f'phase 31 {label}: {DP_STEPS} steps in {elapsed:.3f} s '
                f'({card}); totals {result["losses"][tools.KEY_LOSS_TOTAL]}; '
                f'launches {launches}')
            require(launches['lstm_scan_residuals'] == 3 * DP_STEPS and
                    launches['lstm_bptt'] == 3 * DP_STEPS,
                    f'phase 31 {label}: kernels E and F did not run three '
                    f'times a step')

    def equal(run, other):
        return run[0] == other[0] and all(torch.equal(run[1][k], v)
                                          for k, v in other[1].items())

    plain, meshed, meshed_again, plain_again = runs
    same = equal(meshed, plain) and equal(meshed_again, plain)
    log(f'phase 31: both train(mesh) runs at world size 1 (NCCL) bit for '
        f'bit train(): {same}; the two train() runs bit for bit: '
        f'{equal(plain_again, plain)} (the first train(mesh) run includes '
        f'NCCL\'s setup at its first collective)')
    require(same, 'train(mesh) at world size 1 differs from train()')

    return runs[1][2]['lstm_scan_residuals'] / DP_STEPS


def world_one_paths(card):
    """Phase 34: the paths with no two-rank run on one card, through NCCL
    at world size 1, each bit for bit its unsharded counterpart:
    ``framify_time_sharded`` at the guitar features' shape, TabCNN (paper
    width, windowed, float32) on a time-sharded 60 s track,
    ``shard_params_tp`` then a bf16 O&F2 complexity 3 forward through
    kernel B (three launches), and ``pipeline_apply`` at S = 1."""

    import copy

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.ops import frames as frame_ops
    from amt_tools_tpu_torch.parallel import (framify_time_sharded, get_mesh,
                                              pipeline_apply, shard_params_tp,
                                              shard_time)

    mesh = get_mesh()
    generator = torch.Generator(device='cuda').manual_seed(34)
    frames = 1 + int(CLIP_SECONDS * GUITAR_SAMPLE_RATE) // HOP

    feats = torch.rand((GUITAR_BATCH, 1, 192, frames), generator=generator,
                       device='cuda')
    got = framify_time_sharded(shard_time(feats, mesh), 9, mesh)
    framed = torch.equal(got, frame_ops.framify(feats, 9, pad=True))
    del feats, got

    model = TabCNN(dim_in=192, profile=tools.GuitarProfile(num_frets=19),
                   generator=torch.Generator().manual_seed(34)).cuda().eval()
    track = torch.rand((1, 1, 192, frames), generator=generator,
                       device='cuda')
    with torch.inference_mode(), tools.exact_fp32():
        want = model(model.pre_proc({tools.KEY_FEATS: track})[
            tools.KEY_FEATS])[tools.KEY_TABLATURE]
        windows = framify_time_sharded(shard_time(track, mesh),
                                       model.frame_width, mesh)
        got = model(windows.permute(0, 3, 1, 2, 4))[tools.KEY_TABLATURE]
    tabcnn = torch.equal(got, want)

    plain = of2_model(34, torch.bfloat16).cuda().eval()
    sharded = copy.deepcopy(plain)
    names = shard_params_tp(sharded, get_mesh(axis_names=('model',)))
    feats = torch.rand((8, 1, N_MELS, 1 + int(CLIP_SECONDS * SAMPLE_RATE) //
                        HOP), generator=generator, device='cuda')
    with torch.inference_mode():
        x = plain.pre_proc({tools.KEY_FEATS: feats})[tools.KEY_FEATS]
        want = plain(x)
        reset_launches()
        got = sharded(x)
        tp_launches = read_launches()
    tp = all(torch.equal(got[k], want[k]) for k in want)
    del plain, sharded, feats, x, got, want

    def stage(params, y):
        return y + torch.tanh(y @ params['w'] + params['b'])

    params = {'w': 0.03 * torch.randn((1024, 1024), generator=generator,
                                      device='cuda'),
              'b': torch.randn(1024, generator=generator, device='cuda')}
    micro = torch.randn((8, 64, 1024), generator=generator, device='cuda')
    with torch.inference_mode():
        got = pipeline_apply(params, micro, stage,
                             get_mesh(axis_names=('pipe',)))
        want = torch.stack([stage(params, m) for m in micro])
    pipelined = torch.equal(got, want)

    log(f'phase 34 (NCCL, world size 1; {card}): framify_time_sharded bit '
        f'for bit {framed}; time-sharded TabCNN {tabcnn}; shard_params_tp '
        f'({len(names)} kernels) forward {tp}, launches {tp_launches}; '
        f'pipeline_apply at S = 1 {pipelined}')
    require(framed and tabcnn and tp and pipelined,
            'a world-size-1 parallel path differs from its unsharded '
            'counterpart')
    require(tp_launches['lstm_scan'] == 3,
            'the tensor-parallel forward did not run kernel B three times')
    require(len(names) > 0, 'shard_params_tp sharded no kernel')


def parallel_rank(rank, world, directory):
    """Phases 32 and 33 on one of two ranks sharing the card, through
    gloo: one data-parallel SGD step, then data-parallel piano and guitar
    serving. Writes ``rank<n>.pt`` into ``directory``."""

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(directory, 'store'), world)
    dist.init_process_group('gloo', store=store, rank=rank, world_size=world)
    try:
        from amt_tools_tpu_torch.parallel import get_mesh

        inputs = torch.load(os.path.join(directory, 'inputs.pt'),
                            weights_only=False)
        mesh = get_mesh(backend='gloo')
        out = {'train': rank_train_step(rank, mesh, inputs),
               'piano': rank_serve(rank, mesh, directory, inputs, 'piano'),
               'guitar': rank_serve(rank, mesh, directory, inputs,
                                    'guitar')}
        torch.save(out, os.path.join(directory, f'rank{rank}.pt'))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def block_decisions(pre):
    """The ReLU and 1x2 max-pool decisions of an acoustic block from its
    pre-ReLU values (B, C, T, F), as ``decision_flips`` reads them: the
    ReLU's pass (B, C, T, F), and each frequency pair's pick and whether
    either member is live (B, C, T, F // 2)."""

    x = pre.clamp(min=0)
    width = 2 * (x.shape[-1] // 2)
    first, second = x[..., 0:width:2], x[..., 1:width:2]

    return pre > 0, first >= second, (first > 0) | (second > 0)


def record_decisions(model, store):
    """Forward hooks that keep each acoustic block's decisions
    (``block_decisions``) on the host, by BatchNorm name."""

    def keep(name):
        return lambda _module, _inputs, out: store.__setitem__(
            name, tuple(d.cpu() for d in block_decisions(out.detach())))

    return [module.register_forward_hook(keep(name))
            for name, module in model.named_modules()
            if '_am.BatchNorm_' in name]


def pack_bits(mask):
    """A bool tensor as (shape, numpy bits): an eighth of its bytes."""

    return tuple(mask.shape), np.packbits(mask.numpy().reshape(-1))


def unpack_bits(packed):
    import torch

    shape, bits = packed
    return torch.from_numpy(np.unpackbits(
        bits, count=int(np.prod(shape))).reshape(shape).astype(bool))


def count_flips(got, ref, rows):
    """(ReLU, max-pool) decisions of each acoustic block that ``got`` (a
    rank's rows) took otherwise than ``ref`` (the whole batch's, packed)
    on those ``rows``, by (stack, block)."""

    flips = {}
    for name, (relu, pick, live) in got.items():
        ref_relu, ref_pick, ref_live = (unpack_bits(d)[rows]
                                        for d in ref[name])
        pooled = conv_block(name)[1] > 0
        pool_flips = int(((pick != ref_pick) & (live | ref_live)).sum())
        flips[conv_block(name)] = (int((relu != ref_relu).sum()),
                                   pool_flips if pooled else 0)

    return flips


def rank_train_step(rank, mesh, inputs):
    """Phase 32 on a rank: one SGD step of O&F2 complexity 3 (float32,
    dropout on) on its 4 rows of the global batch of 8, and the ReLU and
    max-pool decisions its rows took otherwise than the one-process
    step's."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.parallel import shard_batch
    from amt_tools_tpu_torch.train import make_train_step, step_generator

    tools.use_exact_fp32()
    batch = shard_batch(inputs['train_batch'], mesh)
    model = of2_model(inputs['train_seed']).cuda()
    step = make_train_step(model, torch.optim.SGD(model.parameters(),
                                                  lr=SGD_LR), mesh=mesh)
    decisions = {}
    hooks = record_decisions(model, decisions)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    loss = step(batch, step_generator(0, 0, 'cuda'))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = read_launches()
    for hook in hooks:
        hook.remove()
    rows = batch[tools.KEY_FEATS].shape[0]

    return {'loss': {k: v.item() for k, v in loss.items()},
            'grads': ({n: p.grad.cpu() for n, p in model.named_parameters()}
                      if rank == 0 else None),
            'stats': {k: v.cpu() for k, v in model.state_dict().items()
                      if k.endswith(('running_mean', 'running_var'))},
            'flips': count_flips(decisions, inputs['train_decisions'],
                                 slice(rank * rows, (rank + 1) * rows)),
            'rows': rows, 'launches': launches, 'seconds': elapsed}


def rank_serve(rank, mesh, directory, inputs, kind):
    """Phase 33 on a rank: the bf16 piano (or guitar) pipeline of phase 5
    (or 8) with the mesh, on the whole batch; this rank serves half of it.
    Returns the notes (every clip's, on rank 0), this rank's logits, its
    launches, seconds and peak memory."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.serving import (TablaturePipeline,
                                             TranscriptionPipeline)

    audio = np.load(os.path.join(directory, f'{kind}.npy'), mmap_mode='c')
    if kind == 'piano':
        model = of2_model(0, torch.bfloat16)
        model.load_state_dict(inputs['piano_state'])
        data_proc = MelSpec(sample_rate=SAMPLE_RATE, hop_length=HOP,
                            n_mels=N_MELS)
        pipeline = TranscriptionPipeline(model, data_proc, capacity=CAPACITY,
                                         mesh=mesh)
    else:
        data_proc = guitar_cqt(grouped='auto')
        model = TabCNN(dim_in=data_proc.get_feature_size(),
                       profile=tools.GuitarProfile(num_frets=19),
                       fullseq=True, dtype=torch.bfloat16)
        model.load_state_dict(inputs['guitar_state'])
        pipeline = TablaturePipeline(model, data_proc,
                                     capacity=GUITAR_CAPACITY, mesh=mesh)

    pipeline(audio[:8])  # warm-up: cuDNN and allocator first use
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = time.perf_counter()
    notes = pipeline(audio)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9

    rows = audio.shape[0] // PARALLEL_RANKS
    own = torch.from_numpy(np.ascontiguousarray(
        audio[rank * rows:(rank + 1) * rows])).cuda()
    if kind == 'piano':
        raw = piano_logits(model, data_proc, own)
    else:
        raw = tablature_logits(model, data_proc, own)

    return {'notes': notes if rank == 0 else len(notes), 'raw': raw,
            'launches': launches, 'seconds': elapsed, 'peak_gb': peak,
            'clips': rows}


def join_ranks(context, timeout):
    """Join spawned ranks; a rank that raised raises here, and ranks that
    outlast ``timeout`` seconds are killed and raise."""

    deadline = time.monotonic() + timeout
    while not context.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.kill()
            for process in context.processes:
                process.join(10)
            raise RuntimeError(f'the spawned ranks outlasted {timeout} s')


def one_process_step(train_seed, batch):
    """Phase 32's reference: the same SGD step in this process on the
    whole batch: (losses, gradients, running statistics, the acoustic
    blocks' decisions)."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.train import make_train_step, step_generator

    tools.use_exact_fp32()
    model = of2_model(train_seed).cuda()
    step = make_train_step(model, torch.optim.SGD(model.parameters(),
                                                  lr=SGD_LR))
    decisions = {}
    hooks = record_decisions(model, decisions)
    loss = step({k: torch.from_numpy(v).cuda() for k, v in batch.items()},
                step_generator(0, 0, 'cuda'))
    for hook in hooks:
        hook.remove()

    return ({k: v.item() for k, v in loss.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()},
            {k: v.cpu() for k, v in model.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))},
            {name: tuple(pack_bits(d) for d in masks)
             for name, masks in decisions.items()})


def check_two_rank_step(ranks, reference, card):
    """Phase 32's comparison with the one-process step: the loss within
    ``LOSS_TOL`` relative; each averaged gradient within ``GRAD_TOL`` of
    its module's largest (a conv bias ahead of a train-mode BatchNorm has
    a gradient of rounding noise), a conv block's within
    ``CONV_BLOCK_GRAD_TOL`` where a ReLU or max-pool decision of its stack
    at or after it went the other way on a rank (the rule of phase 12b:
    the BatchNorm statistics and the convolutions of 4 rows round apart
    from those of 8, and an element whose decision flips routes its whole
    gradient elsewhere); the running statistics within 1e-5; E and F three
    times a step on each rank. Returns E's launches a step a rank."""

    from amt_tools_tpu_torch import tools

    ref_loss, ref_grads, ref_stats, _ = reference
    key = tools.KEY_LOSS_TOTAL
    loss_err = stat_err = 0.0
    flips = {}
    for rank, result in enumerate(ranks):
        step = result['train']
        require(step['rows'] == TRAIN_BATCH // PARALLEL_RANKS,
                f'rank {rank} did not take its {TRAIN_BATCH // 2} rows')
        loss_err = max(loss_err, abs(step['loss'][key] - ref_loss[key]) /
                       abs(ref_loss[key]))
        stat_err = max(stat_err, max((step['stats'][k] - v).abs().max().item()
                                     for k, v in ref_stats.items()))
        for block, (relu, pool) in step['flips'].items():
            total = flips.get(block, (0, 0))
            flips[block] = (total[0] + relu, total[1] + pool)
        log(f'phase 32 rank {rank}: step {step["seconds"]:.3f} s (the first '
            f'step, two processes sharing one card, not a scaling figure; '
            f'{card}); loss {step["loss"][key]!r} (one process '
            f'{ref_loss[key]!r}); launches {step["launches"]}')
        require(step['launches']['lstm_scan_residuals'] == 3 and
                step['launches']['lstm_bptt'] == 3,
                f'phase 32 rank {rank}: E and F did not run three times')

    grads = ranks[0]['train']['grads']
    ratios = []
    for name, ref in ref_grads.items():
        err = (grads[name] - ref).abs().max().item() / module_scale(
            ref_grads, name)
        tol = GRAD_TOL
        block = conv_block(name)
        if block is not None and any(
                sum(counts) for (stack, later), counts in flips.items()
                if stack == block[0] and later >= block[1]):
            tol = CONV_BLOCK_GRAD_TOL
        ratios.append((err / tol, err, name))
    ratio, err, name = max(ratios)
    strict, strict_name = max((r[1], r[2]) for r in ratios
                              if conv_block(r[2]) is None)
    log(f'phase 32: two ranks (gloo) vs one process, one SGD step with '
        f'dropout on: loss within {loss_err:.3g} relative (tolerance '
        f'{LOSS_TOL}); ReLU/max-pool decisions taken otherwise in blocks '
        f'0-2: ' + ', '.join(
            f'{stack} ' + ' '.join(f'{flips[stack, i][0]}/{flips[stack, i][1]}'
                                   for i in range(3))
            for stack in sorted({s for s, _ in flips})) +
        f'; gradients at most {ratio:.3g} of their tolerance (worst {name}, '
        f'{err:.3g} of its module\'s largest; outside the conv blocks '
        f'{strict:.3g}, {strict_name}); running statistics within '
        f'{stat_err:.3g} (tolerance 1e-5)')
    require(loss_err <= LOSS_TOL, 'phase 32: the loss differs')
    require(ratio <= 1.0, 'phase 32: a gradient differs')
    require(stat_err <= 1e-5, 'phase 32: a running statistic differs')

    return ranks[0]['train']['launches']['lstm_scan_residuals']


def check_two_rank_piano(ranks, reference, profile, card):
    """Phase 33, piano: every rank's notes for all 128 clips equal the
    one-process pipeline's (phase 5) in every pitch row whose thresholded
    maps agree, the maps differing only within ``BF16_LOGIT_TOL`` of the
    threshold; A once and B three times a rank."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops import decode

    notes = ranks[0]['piano']['notes']
    require(len(notes) == BATCH and all(r['piano']['notes'] == BATCH
                                        for r in ranks[1:]),
            'phase 33: a rank did not return every clip')
    rows = torch.zeros(BATCH, 88, dtype=torch.bool)
    differ_cells, worst = 0, 0.0
    for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
        ref = reference['raw'][key]
        got = torch.cat([r['piano']['raw'][key] for r in ranks])
        worst = max(worst, (got.float() - ref.float()).abs().max().item())
        differ = (decode.threshold(decode.sigmoid(got.transpose(-1, -2))) !=
                  decode.threshold(decode.sigmoid(ref.transpose(-1, -2))))
        require(bool((ref.transpose(-1, -2)[differ].float().abs() <=
                      BF16_LOGIT_TOL).all()),
                f'phase 33: {key} maps differ away from the threshold')
        differ_cells += int(differ.sum())
        rows |= differ.any(dim=-1)
    compared = 0
    for b, ((p_got, i_got), (p_ref, i_ref)) in enumerate(
            zip(notes, reference['notes'])):
        keep_got = ~rows[b].numpy()[p_got.astype(int) - profile.low]
        keep_ref = ~rows[b].numpy()[p_ref.astype(int) - profile.low]
        require(np.array_equal(p_got[keep_got], p_ref[keep_ref]) and
                np.array_equal(i_got[keep_got], i_ref[keep_ref]),
                f'phase 33: clip {b}: two-rank notes differ')
        compared += int(keep_ref.sum())
    require(compared > 0, 'phase 33: no notes compared')
    for rank, result in enumerate(ranks):
        piano = result['piano']
        log(f'phase 33 piano rank {rank}: {piano["clips"]} clips of '
            f'{CLIP_SECONDS:.0f} s in {piano["seconds"]:.3f} s (two '
            f'processes sharing one card, not a scaling figure; {card}); '
            f'peak {piano["peak_gb"]:.3f} GB; launches {piano["launches"]}')
        require(piano['launches']['stft_power'] == 1 and
                piano['launches']['lstm_scan'] == 3,
                f'phase 33 rank {rank}: A did not run once and B three '
                f'times')
    log(f'phase 33 piano: two ranks vs one process: logits within '
        f'{worst:.3g}; {differ_cells} map cells differ (each within '
        f'{BF16_LOGIT_TOL} of the threshold); notes identical in '
        f'{88 * BATCH - int(rows.sum())} of {88 * BATCH} pitch rows, '
        f'{compared} of {sum(len(p) for p, _ in reference["notes"])} notes '
        f'compared')

    return ranks[0]['piano']['launches']


def check_two_rank_guitar(ranks, reference, card):
    """Phase 33, guitar: the tablature of the two ranks may differ from the
    one-process pipeline's (phase 8) only where the one-process top-two
    margin is within ``2 * BF16_LOGIT_TOL``; every string whose tablature
    agrees has the same notes; D once a rank."""

    import torch

    notes = ranks[0]['guitar']['notes']
    require(len(notes) == GUITAR_BATCH, 'phase 33: a guitar clip is missing')
    ref_raw = reference['raw'].float()
    got_raw = torch.cat([r['guitar']['raw'] for r in ranks]).float()
    worst = (got_raw - ref_raw).abs().max().item()
    shape = ref_raw.shape[:2] + (6, 21)
    ref_tab = ref_raw.reshape(shape).argmax(-1)
    got_tab = got_raw.reshape(shape).argmax(-1)
    top2 = ref_raw.reshape(shape).topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = ref_tab != got_tab
    require(bool((margin[differ] <= 2 * BF16_LOGIT_TOL).all()),
            'phase 33: tablature differs away from a top-two tie')
    compared = 0
    for b in range(GUITAR_BATCH):
        for string in range(6):
            if bool(differ[b, :, string].any()):
                continue
            (p_got, i_got), (p_ref, i_ref) = (notes[b][string],
                                              reference['notes'][b][string])
            require(np.array_equal(p_got, p_ref) and
                    np.array_equal(i_got, i_ref),
                    f'phase 33: guitar clip {b} string {string} differs')
            compared += 1
    for rank, result in enumerate(ranks):
        guitar = result['guitar']
        log(f'phase 33 guitar rank {rank}: {guitar["clips"]} clips of '
            f'{CLIP_SECONDS:.0f} s in {guitar["seconds"]:.3f} s (two '
            f'processes sharing one card, not a scaling figure; {card}); '
            f'peak {guitar["peak_gb"]:.3f} GB; launches {guitar["launches"]}')
        require(guitar['launches']['cqt_mag_grouped'] == 1,
                f'phase 33 rank {rank}: D did not run once')
    log(f'phase 33 guitar: two ranks vs one process: logits within '
        f'{worst:.3g}; {int(differ.sum())} tablature cells differ; notes '
        f'identical on {compared} of {6 * GUITAR_BATCH} strings')

    return ranks[0]['guitar']['launches']


def parallel_phases(card, directory, piano_reference, guitar_reference):
    """Phases 31-34. Returns the per-rank launch counts for the kernels
    line."""

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from amt_tools_tpu_torch import tools

    phases_start = time.perf_counter()
    store = dist.FileStore(os.path.join(directory, 'nccl_store'), 1)
    dist.init_process_group('nccl', store=store, rank=0, world_size=1)
    try:
        e_per_step_world_one = dp_world_one(card)
        torch.cuda.empty_cache()
        world_one_paths(card)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    train_seed = 32
    batch = dp_batch(32)
    reference = one_process_step(train_seed, batch)
    torch.cuda.empty_cache()
    torch.save({'train_seed': train_seed, 'train_batch': batch,
                'train_decisions': reference[3],
                'piano_state': piano_reference['state'],
                'guitar_state': guitar_reference['state']},
               os.path.join(directory, 'inputs.pt'))
    start = time.perf_counter()
    context = mp.start_processes(parallel_rank,
                                 args=(PARALLEL_RANKS, directory),
                                 nprocs=PARALLEL_RANKS, join=False,
                                 start_method='spawn')
    join_ranks(context, PARALLEL_TIMEOUT)
    log(f'phases 32-33: {PARALLEL_RANKS} spawned ranks done in '
        f'{time.perf_counter() - start:.1f} s')
    ranks = [torch.load(os.path.join(directory, f'rank{rank}.pt'),
                        weights_only=False) for rank in range(PARALLEL_RANKS)]

    # Every comparison runs and logs before any failure is raised
    checks = {'32': lambda: check_two_rank_step(ranks, reference, card),
              '33 piano': lambda: check_two_rank_piano(
                  ranks, piano_reference, tools.PianoProfile(), card),
              '33 guitar': lambda: check_two_rank_guitar(
                  ranks, guitar_reference, card)}
    results, failures = {}, []
    for name, check in checks.items():
        try:
            results[name] = check()
        except RuntimeError as error:
            failures.append(f'phase {name}: {error}')
    require(not failures, '; '.join(failures))
    e_per_step, piano, guitar = (results['32'], results['33 piano'],
                                 results['33 guitar'])
    log(f'phases 31-34 in {time.perf_counter() - phases_start:.1f} s')

    return {'e_f_per_step_world_one': e_per_step_world_one,
            'e_f_per_step_two_ranks': e_per_step,
            'a_per_rank': piano['stft_power'],
            'b_per_rank': piano['lstm_scan'],
            'd_per_rank': guitar['cqt_mag_grouped']}


# Phases 35-38: the deployment slice. Kernels A-F as custom ops of
# torch.ops.amt_tools_tpu_torch; artifacts through torch.export, written
# under a temporary directory of the repository (git-ignored); MFU from
# profiling.py; the port's example scripts on the card

OP_CHECK_FRAMES = 50     # opcheck's shapes: small, each op runs a few times
EXAMPLE_FLOAT32_CLIPS = 8
EXAMPLE_INT8_CLIPS = 16
ARTIFACT_SYMBOLIC_CLIPS = 8


def same(got, want):
    """Whether two outputs (tensors or tuples of them) are equal bit for
    bit."""

    import torch

    if isinstance(want, torch.Tensor):
        return (got.dtype == want.dtype and got.shape == want.shape and
                bool(torch.equal(got, want)))

    return len(got) == len(want) and all(same(g, w)
                                         for g, w in zip(got, want))


def op_cases(scale):
    """(label, wrapper call, op call, kernel) for every op, B, E and F on
    one sequence (plain, masked, carried) and on three groups (plain,
    masked), and the conv epilogue pooled and not, on CUDA inputs of
    ``scale`` frames (opcheck's small shapes when OP_CHECK_FRAMES); the op
    calls are (op, args)."""

    import torch

    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.ops import (conv_epilogue, cqt_kernel,
                                         lstm_kernel, stft_kernel)

    device = torch.device('cuda')
    gen = torch.Generator(device=device).manual_seed(35)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=device)

    bank = MelSpec(n_mels=N_MELS)._bank(device)
    audio = randn(4, HOP * (scale - 1), scale=0.1)
    full, grouped = guitar_cqt(False), guitar_cqt('auto')
    cqt_bank, stack = full._bank(device), grouped._bank(device)
    guitar = randn(2, HOP * (scale - 1), scale=0.1)
    cases = [('A', 'stft_power',
              lambda: stft_kernel.stft_power(audio, bank, N_FFT, HOP),
              (stft_kernel.stft_power_op, (audio, bank, N_FFT, HOP, True))),
             ('C', 'cqt_mag',
              lambda: cqt_kernel.cqt_mag(guitar, cqt_bank, full._support,
                                         HOP, 'high'),
              (cqt_kernel.cqt_mag_op, (guitar, cqt_bank, full._support, HOP,
                                       'bf16x3'))),
             ('D', 'cqt_mag_grouped',
              lambda: cqt_kernel.cqt_mag_grouped(
                  guitar, stack, grouped._group_supports,
                  grouped._group_bins, HOP, 'high'),
              (cqt_kernel.cqt_mag_grouped_op,
               (guitar, stack, list(grouped._group_supports),
                list(grouped._group_bins), HOP, 'bf16x3')))]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split('.')[-1]
        xw = randn(4, scale, 4 * HIDDEN, scale=0.5).to(dtype)
        wh = randn(HIDDEN, 4 * HIDDEN, scale=0.05).to(dtype)
        lengths = torch.tensor([scale, scale // 2, 1, 0], dtype=torch.int32,
                               device=device)
        carry = (randn(4, HIDDEN, scale=0.5), randn(4, HIDDEN, scale=0.5))
        out, gates, c_seq = lstm_kernel.lstm_scan_residuals(xw, wh)
        dout = randn(4, scale, HIDDEN, scale=0.1).to(dtype)
        wht = wh.t().contiguous()
        # One sequence is one group (reverse_from 1 forward, 0 reversed):
        # the wrapper's results as the op's list
        one, res1 = (xw[None], wh[None]), (gates[None], c_seq[None],
                                             dout[None], wht[None])
        c1 = tuple(x[None] for x in carry)

        def group(*results):
            return [x[None] for r in results
                    for x in (r if isinstance(r, tuple) else (r,))]

        cases += [
            (f'B {name}', 'lstm_scan',
             lambda xw=xw, wh=wh: group(lstm_kernel.lstm_scan(xw, wh)),
             (lstm_kernel.lstm_scan_op, (*one, 1, None, None, None))),
            (f'B {name} masked', 'lstm_scan',
             lambda xw=xw, wh=wh, n=lengths: group(lstm_kernel.lstm_scan(
                 xw, wh, reverse=True, lengths=n)),
             (lstm_kernel.lstm_scan_op, (*one, 0, lengths, None, None))),
            (f'B {name} carried', 'lstm_scan',
             lambda xw=xw, wh=wh, c=carry: group(*lstm_kernel.lstm_scan(
                 xw, wh, initial_carry=c, return_carry=True)),
             (lstm_kernel.lstm_scan_op, (*one, 1, None, *c1))),
            (f'E {name}', 'lstm_scan_residuals',
             lambda xw=xw, wh=wh: group(*lstm_kernel.lstm_scan_residuals(
                 xw, wh, True)),
             (lstm_kernel.lstm_scan_residuals_op,
              (*one, 0, None, None, None))),
            (f'E {name} masked', 'lstm_scan_residuals',
             lambda xw=xw, wh=wh, n=lengths: group(
                 *lstm_kernel.lstm_scan_residuals(xw, wh, True, n)),
             (lstm_kernel.lstm_scan_residuals_op,
              (*one, 0, lengths, None, None))),
            (f'E {name} carried', 'lstm_scan_residuals',
             lambda xw=xw, wh=wh, n=lengths, c=carry: group(
                 *lstm_kernel.lstm_scan_residuals(xw, wh, False, n, c,
                                                  return_carry=True)),
             (lstm_kernel.lstm_scan_residuals_op,
              (*one, 1, lengths, *c1))),
            (f'F {name}', 'lstm_bptt',
             lambda g=gates, c=c_seq, d=dout, w=wht: group(
                 lstm_kernel.lstm_bptt(g, c, d, w)),
             (lstm_kernel.lstm_bptt_op, (*res1, 1, None, None, None, None))),
            (f'F {name} masked', 'lstm_bptt',
             lambda g=gates, c=c_seq, d=dout, w=wht, n=lengths: group(
                 lstm_kernel.lstm_bptt(g, c, d, w, True, n)),
             (lstm_kernel.lstm_bptt_op,
              (*res1, 0, lengths, None, None, None))),
            (f'F {name} carried', 'lstm_bptt',
             lambda g=gates, c=c_seq, d=dout, w=wht, n=lengths, k=carry:
             group(*lstm_kernel.lstm_bptt(g, c, d, w, False, n,
                                          (k[0], *k))),
             (lstm_kernel.lstm_bptt_op,
              (*res1, 1, lengths, c1[0], *c1)))]
        # Three groups, the last reversed
        gxw = randn(3, 4, scale, 4 * HIDDEN, scale=0.5).to(dtype)
        gwh = randn(3, HIDDEN, 4 * HIDDEN, scale=0.05).to(dtype)
        _, ggates, gc = lstm_kernel.lstm_scan_residuals_grouped(gxw, gwh, 2)
        gdout = randn(3, 4, scale, HIDDEN, scale=0.1).to(dtype)
        gwht = gwh.transpose(1, 2).contiguous()
        cases += [
            (f'B {name} grouped', 'lstm_scan',
             lambda x=gxw, w=gwh: [lstm_kernel.lstm_scan_grouped(x, w, 2)],
             (lstm_kernel.lstm_scan_op, (gxw, gwh, 2, None, None, None))),
            (f'B {name} grouped masked', 'lstm_scan',
             lambda x=gxw, w=gwh, n=lengths: [lstm_kernel.lstm_scan_grouped(
                 x, w, 2, n)],
             (lstm_kernel.lstm_scan_op, (gxw, gwh, 2, lengths, None, None))),
            (f'E {name} grouped', 'lstm_scan_residuals',
             lambda x=gxw, w=gwh: list(
                 lstm_kernel.lstm_scan_residuals_grouped(x, w, 2)),
             (lstm_kernel.lstm_scan_residuals_op,
              (gxw, gwh, 2, None, None, None))),
            (f'E {name} grouped masked', 'lstm_scan_residuals',
             lambda x=gxw, w=gwh, n=lengths: list(
                 lstm_kernel.lstm_scan_residuals_grouped(x, w, 2, n)),
             (lstm_kernel.lstm_scan_residuals_op,
              (gxw, gwh, 2, lengths, None, None))),
            (f'F {name} grouped', 'lstm_bptt',
             lambda g=ggates, c=gc, d=gdout, w=gwht: [
                 lstm_kernel.lstm_bptt_grouped(g, c, d, w, 2)],
             (lstm_kernel.lstm_bptt_op,
              (ggates, gc, gdout, gwht, 2, None, None, None, None))),
            (f'F {name} grouped masked', 'lstm_bptt',
             lambda g=ggates, c=gc, d=gdout, w=gwht, n=lengths: [
                 lstm_kernel.lstm_bptt_grouped(g, c, d, w, 2, n)],
             (lstm_kernel.lstm_bptt_op,
              (ggates, gc, gdout, gwht, 2, lengths, None, None, None)))]
        # The conv blocks' eval epilogue on cuDNN's channels-last layout
        x = randn(2, scale // 10, N_MELS, 48).to(dtype).permute(0, 3, 1, 2)
        vectors = (randn(48, scale=0.1).to(dtype), randn(48, scale=0.3),
                   randn(48), randn(48, scale=0.2))
        for pool in (False, True):
            cases.append((
                f'epilogue {name}{" pooled" if pool else ""}',
                'conv_epilogue',
                lambda x=x, v=vectors, p=pool: conv_epilogue.conv_epilogue(
                    x, *v, p),
                (conv_epilogue.conv_epilogue_op, (x, *vectors, pool))))

    return cases


def check_custom_ops(card):
    """Phase 35: each of kernels A-F (B, E and F on their masked and
    carried schemas) and the conv epilogue through its custom op, bit for
    bit its wrapper, one launch counted a call; then
    ``torch.library.opcheck`` of each on the card at small shapes (the
    schema, the fake implementation against the real one, the autograd
    registration, and a trace with symbolic shapes)."""

    import torch
    from torch.library import opcheck

    from amt_tools_tpu_torch import tools

    counters = kernel_counters()
    launches = {}
    with tools.exact_fp32():
        for label, kernel, wrapper, (op, args) in op_cases(4 * TRAIN_FRAMES):
            want = wrapper()
            before = counters[kernel].launches
            got = op(*args)
            torch.cuda.synchronize()
            counted = counters[kernel].launches - before
            require(same(got, want), f'{label}: its op differs from its '
                                     f'wrapper')
            require(counted == 1, f'{label}: its op counted {counted} '
                                  f'launches, not 1')
            launches[label] = counted
        log(f'the ops of A-F at (B, {4 * TRAIN_FRAMES} frames): each bit for '
            f'bit its wrapper, one launch counted a call: {sorted(launches)}')

        results = {}
        reset_launches()
        for label, kernel, _, (op, args) in op_cases(OP_CHECK_FRAMES):
            report = opcheck(op, args)
            results[label] = report
            require(all(v == 'SUCCESS' for v in report.values()),
                    f'opcheck of {label} on the card: {report}')
        checked = read_launches()
        reset_launches()
    log(f'opcheck on the card ({card}): {len(results)} ops and schemas, '
        f'every test SUCCESS ({sorted(next(iter(results.values())))}); '
        f'launches under opcheck {checked}')
    require(all(checked[name] > 0 for name in counters),
            'opcheck launched no kernel of an op on the card')

    return {'ops': sorted(results), 'op_check_launches': checked}


def piano_model(dtype, seed, quant=False):
    """O&F2 complexity 3 at full width from a seed."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2

    return OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                         model_complexity=3, dtype=dtype,
                         quant_acoustic=quant,
                         generator=torch.Generator().manual_seed(seed))


def notes_equal(got, want):
    """The clips whose notes are equal bit for bit, of all."""

    equal = sum(np.array_equal(p_g, p_w) and np.array_equal(i_g, i_w)
                for (p_g, i_g), (p_w, i_w) in zip(got, want))

    return equal, len(want)


def serving_artifacts(pipeline, requests, card, directory):
    """Phase 36: the bf16 piano pipeline of phase 5 exported at 128 x 60 s
    with a symbolic batch, saved and loaded on the card: notes equal to the
    live pipeline's, A once and B three times a call, audio-s per wall-s in
    turns with the live pipeline (live, artifact, artifact, live, each
    over the 3 requests called one by one); the same artifact at 8 clips; a
    float32 artifact loaded with TF32 switched on, whose loading turns it
    off and whose logits program equals the live float32 logits bit for
    bit; and the int8-static artifact's notes equal to the live int8
    pipeline's."""

    import torch

    from amt_tools_tpu_torch import export, serving, tools
    from amt_tools_tpu_torch.features import MelSpec

    num_samples = requests[0].shape[-1]
    probe = requests[0][:4].cpu().numpy()
    path = os.path.join(directory, 'piano_bf16.amtx')
    start = time.perf_counter()
    meta = export.save_serving(path, pipeline, num_samples, batch_size=8)
    export_s = time.perf_counter() - start
    start = time.perf_counter()
    artifact = export.load_serving(path)
    load_s = time.perf_counter() - start
    log(f'serving artifact, bf16 O&F2 complexity 3: exported in '
        f'{export_s:.1f} s, {os.path.getsize(path) / 1e6:.1f} MB, loaded in '
        f'{load_s:.1f} s; meta {meta}')
    require(meta['symbolic_batch'], 'the serving artifact did not export '
                                    'with a symbolic batch')

    artifact(requests[0][:8])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    frozen = artifact(requests[0])
    torch.cuda.synchronize()
    launches = read_launches()
    live = pipeline(requests[0])
    equal, clips = notes_equal(frozen, live)
    log(f'serving artifact at {BATCH} x {CLIP_SECONDS:.0f} s: notes equal '
        f'to the live pipeline\'s in {equal} of {clips} clips; launches a '
        f'call {launches}')
    require(equal == clips, 'the serving artifact\'s notes differ from the '
                            'live pipeline\'s')
    require(launches['stft_power'] == launches['stft_power_fft'] == 1 and
            launches['lstm_scan'] == 3,
            'the serving artifact did not run A once and B three times a '
            'call')

    times = {}
    runs = {'live': pipeline, 'artifact': artifact}
    for turn in ('live', 'artifact', 'artifact', 'live'):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for request in requests:
            runs[turn](request)
        torch.cuda.synchronize()
        times.setdefault(turn, []).append(time.perf_counter() - start)
    audio_seconds = REQUESTS * BATCH * CLIP_SECONDS
    rates = {turn: [audio_seconds / t for t in ts]
             for turn, ts in times.items()}
    log(f'audio-s per wall-s over {REQUESTS} requests of {BATCH} x '
        f'{CLIP_SECONDS:.0f} s, each called synchronously, in turns '
        f'(live, artifact, artifact, live): {rates} ({card})')

    sub = requests[0][:ARTIFACT_SYMBOLIC_CLIPS]
    equal_sub, _ = notes_equal(artifact(sub), pipeline(sub))
    require(equal_sub == ARTIFACT_SYMBOLIC_CLIPS,
            f'the symbolic artifact at {ARTIFACT_SYMBOLIC_CLIPS} clips '
            f'differs from the live pipeline')
    del artifact
    torch.cuda.empty_cache()

    # Float32: the program runs with the flags of the process that loads
    # it, so loading must turn TF32 off
    mel = MelSpec(sample_rate=SAMPLE_RATE, hop_length=HOP, n_mels=N_MELS)
    model32 = piano_model(None, 36)
    serving.calibrate_activity(model32, mel, probe)
    live32 = serving.TranscriptionPipeline(model32, mel, capacity=CAPACITY)
    audio32 = requests[0][:EXAMPLE_FLOAT32_CLIPS]

    class Logits(torch.nn.Module):
        def __init__(self, pipeline):
            super().__init__()
            self.pipeline = pipeline
            self.model = pipeline.model

        def forward(self, audio):
            raw = serving._forward(self.model, self.pipeline.data_proc, audio)
            return raw[tools.KEY_MULTIPITCH], raw[tools.KEY_ONSETS]

    logits_path = os.path.join(directory, 'piano_f32_logits.pt2')
    with torch.no_grad():
        torch.export.save(torch.export.export(Logits(live32), (audio32,),
                                              strict=False), logits_path)
    path32 = os.path.join(directory, 'piano_f32.amtx')
    export.save_serving(path32, live32, num_samples, batch_size=8)
    want_logits = Logits(live32)(audio32)
    want_notes = live32(audio32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    artifact32 = export.load_serving(path32)
    flags_off = not (torch.backends.cuda.matmul.allow_tf32 or
                     torch.backends.cudnn.allow_tf32)
    require(flags_off, 'load_serving left TF32 on')
    with torch.no_grad():
        got_logits = torch.export.load(logits_path).module()(audio32)
    equal32, _ = notes_equal(artifact32(audio32), want_notes)
    logit_err = max(float((g.float() - w.float()).abs().max())
                    for g, w in zip(got_logits, want_logits))
    log(f'float32 artifact loaded with TF32 on: the flags are off after '
        f'load_serving; its logits program against the live float32 '
        f'logits: max {logit_err:.3g} at {EXAMPLE_FLOAT32_CLIPS} clips; '
        f'notes equal in {equal32} of {EXAMPLE_FLOAT32_CLIPS} clips')
    require(same(got_logits, want_logits), 'the float32 logits program '
                                           'differs from the live pipeline')
    require(equal32 == EXAMPLE_FLOAT32_CLIPS, 'the float32 artifact\'s notes '
                                              'differ from the live pipeline')
    del artifact32, live32, model32
    torch.cuda.empty_cache()

    # Int8-static: the scales are the layers' buffers, frozen into the
    # program
    model8 = piano_model(torch.bfloat16, 14, quant='static')
    serving.calibrate_quant_stats(model8, mel, probe)
    serving.calibrate_activity(model8, mel, probe)
    live8 = serving.TranscriptionPipeline(model8, mel, capacity=CAPACITY)
    audio8 = requests[0][:EXAMPLE_INT8_CLIPS]
    path8 = os.path.join(directory, 'piano_int8_static.amtx')
    meta8 = export.save_serving(path8, live8, num_samples,
                                batch_size=EXAMPLE_INT8_CLIPS)
    artifact8 = export.load_serving(path8)
    reset_launches()
    frozen8 = artifact8(audio8)
    launches8 = read_launches()
    equal8, _ = notes_equal(frozen8, live8(audio8))
    log(f'int8-static artifact at {EXAMPLE_INT8_CLIPS} clips: symbolic '
        f'batch {meta8["symbolic_batch"]} (fixed batch '
        f'{meta8["batch_size"]}), notes equal to the live int8 pipeline\'s '
        f'in {equal8} of {EXAMPLE_INT8_CLIPS} clips; launches {launches8}')
    require(equal8 == EXAMPLE_INT8_CLIPS, 'the int8-static artifact\'s notes '
                                          'differ from the live pipeline')
    del artifact8, live8, model8
    torch.cuda.empty_cache()

    return {'launches': launches, 'rates': rates, 'export_s': export_s,
            'load_s': load_s, 'int8_static_symbolic': meta8['symbolic_batch'],
            'float32_logit_err': logit_err}


def streaming_artifact(card, directory):
    """Phase 37: OnsetsFramesOnline complexity 3 (phase 25's model and
    track) exported as a streaming artifact and loaded on the card: its
    maps over the track's frames, one frame a step, bit for bit
    ``run_online_stateful``'s, kernel B from the carry twice a frame; ms a
    frame (a step to its maps on the host) at the median and p99, in turns
    with ``run_online_stateful`` (live, artifact, artifact, live)."""

    import torch

    from amt_tools_tpu_torch import export, tools
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.inference import run_online_stateful
    from amt_tools_tpu_torch.models import OnsetsFramesOnline

    profile = tools.PianoProfile()
    mel = MelSpec(n_mels=N_MELS)
    model = OnsetsFramesOnline(dim_in=N_MELS, profile=profile,
                               model_complexity=3,
                               generator=torch.Generator().manual_seed(25))
    model = model.cuda().eval()
    audio = render_clips(profile, 1, STREAM_SECONDS)[0]
    feats = mel.process_audio(audio)
    track = {tools.KEY_FEATS: feats, tools.KEY_TIMES: mel.get_times(audio),
             tools.KEY_TRACK: 'stream'}
    frames = feats.shape[-1]
    keys = (tools.KEY_MULTIPITCH, tools.KEY_ONSETS)

    path = os.path.join(directory, 'online.amtx')
    start = time.perf_counter()
    with open(path, 'wb') as handle:
        handle.write(export.export_streaming(model))
    export_s = time.perf_counter() - start
    artifact = export.load_streaming(path)

    def stream_artifact():
        carries = artifact.init_carries()
        maps, stamps = {key: [] for key in keys}, []
        for t in range(frames):
            out, carries = artifact.step(carries, feats[None, ..., t: t + 1])
            for key in keys:
                maps[key].append(out[key][0].cpu())
            stamps.append(time.perf_counter())
        return {key: torch.cat(v, -1).numpy() for key, v in maps.items()}, \
            stamps

    def stream_live():
        timer = FrameTimer()
        predictions = run_online_stateful(dict(track), model, timer)
        return predictions, timer.stamps

    with tools.exact_fp32():
        stream_live()
        stream_artifact()  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        maps, _ = stream_artifact()
        launches = read_launches()
        live, _ = stream_live()
        for key in keys:
            require(np.array_equal(maps[key], live[key]),
                    f'the streaming artifact\'s {key} maps differ from '
                    f'run_online_stateful\'s')
        require(launches['lstm_scan'] == launches['lstm_scan_carried'] ==
                2 * frames, 'the streaming artifact did not run kernel B '
                            'from the carry twice a frame')

        per_frame = {}
        for turn in ('live', 'artifact', 'artifact', 'live'):
            torch.cuda.synchronize()
            start = time.perf_counter()
            _, stamps = (stream_live if turn == 'live' else
                         stream_artifact)()
            per_frame.setdefault(turn, []).append(
                np.diff([start] + stamps) * 1e3)
    stats = {turn: {'median_ms': float(np.median(np.concatenate(v))),
                    'p99_ms': float(np.percentile(np.concatenate(v), 99))}
             for turn, v in per_frame.items()}
    log(f'streaming artifact, O&F online complexity 3 float32: exported in '
        f'{export_s:.1f} s; {frames} frames, maps bit for bit '
        f'run_online_stateful\'s, launches {launches}; ms a frame in turns '
        f'{stats} ({card})')

    return {'frames': frames, 'carried_launches': launches['lstm_scan_carried'],
            'per_frame': stats, 'export_s': export_s}


def flops_by_op(fn):
    """FlopCounterMode's FLOPs by op over one call of ``fn``."""

    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()

    return {str(op): int(n) for op, n in
            counter.get_flop_counts()['Global'].items()}


def load_example(*parts):
    """Import an example script of the port without running it."""

    import importlib.util

    path = os.path.join(ROOT, 'amt_tools_tpu_torch', 'examples', *parts)
    spec = importlib.util.spec_from_file_location(
        'example_' + parts[-1][:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    return module


def profiling_and_examples(pipeline, requests, train_batch, card, directory):
    """Phase 38: ``profiling.mfu`` of the bf16 piano batch (against the
    bf16 peak) and of the float32 O&F2 training step (against the float32
    peak), with their FLOPs by op (kernels A-F through their ops'
    formulas); then the port's example scripts on the card:
    ``transcribe_file`` on a written WAV, ``export_artifact`` at 2 s clips,
    and ``synthetic_demo`` and ``synthetic_tabcnn`` at 2 iterations."""

    import torch

    from amt_tools_tpu_torch import profiling, tools

    power = card.split(',')[-1].strip()
    result = {'peak_bf16': profiling.peak_flops(None, 'bf16'),
              'peak_float32': profiling.peak_flops(None, 'float32'),
              'peak_hbm_bw': profiling.peak_hbm_bw()}
    require(result['peak_bf16'] == PEAK_BF16_FLOPS and
            result['peak_float32'] == PEAK_FP32_FLOPS and
            result['peak_hbm_bw'] == PEAK_BYTES_PER_S,
            f'profiling\'s H100 table reads {result}')

    runs = {'piano_bf16': (lambda: pipeline._decode(requests[0], CAPACITY),
                           'bf16', ('stft_power', 'lstm_scan')),
            'train_float32': (train_batch[1], 'float32',
                              ('lstm_scan_residuals', 'lstm_bptt'))}
    for name, (fn, dtype, ops) in runs.items():
        by_op = flops_by_op(fn)
        fraction, achieved, secs = profiling.mfu(fn, repeats=3,
                                                 peak_dtype=dtype)
        flops = achieved * secs
        kernel_flops = {op: n for op, n in by_op.items()
                        if op.startswith('amt_tools_tpu_torch')}
        log(f'MFU {name}: {fraction:.4f} of the {dtype} peak '
            f'({achieved / 1e12:.2f} TFLOP/s; {flops / 1e12:.4f} TFLOP in '
            f'{secs * 1e3:.3f} ms, best of 3; {card}); FLOPs by op {by_op}')
        require(all(any(op.endswith(f'.{kernel}') for op in kernel_flops)
                    for kernel in ops),
                f'{name}: the FLOP count has no formula of {ops}')
        result[name] = {'mfu': fraction, 'flops': flops, 'seconds': secs,
                        'flops_by_op': by_op, 'peak_dtype': dtype,
                        'power_limit': power}

    # The examples, on the card
    wav = os.path.join(directory, 'clip.wav')
    t = np.arange(2 * SAMPLE_RATE) / SAMPLE_RATE
    tools.write_wav(wav, (0.4 * np.sin(2 * np.pi * 261.63 * t)).astype(
        np.float32), SAMPLE_RATE)
    reset_launches()
    pitches, _ = load_example('inference', 'transcribe_file.py').main(
        wav, None, os.path.join(directory, 'notes.txt'))
    examples = {'transcribe_file': read_launches()}
    require(examples['transcribe_file']['stft_power'] == 1 and
            examples['transcribe_file']['lstm_scan'] == 3,
            'transcribe_file did not run A once and B three times')

    runs = {'export_artifact': ('inference', 'export_artifact.py',
                                [f'out={directory}/example.amtx',
                                 'clip_seconds=2']),
            'synthetic_demo': ('papers', 'synthetic_demo.py',
                               ['iterations=2', 'checkpoints=1',
                                'num_train_tracks=8', 'num_test_tracks=2']),
            'synthetic_tabcnn': ('papers', 'synthetic_tabcnn.py',
                                 ['iterations=2', 'checkpoints=1',
                                  'num_train_tracks=8',
                                  'num_test_tracks=2'])}
    outcomes = {}
    for name, (folder, script, overrides) in runs.items():
        module = load_example(folder, script)
        module.ex.root_dir = os.path.join(directory, 'experiments', name)
        reset_launches()
        start = time.perf_counter()
        outcomes[name] = module.ex.run(overrides)
        torch.cuda.synchronize()
        examples[name] = read_launches()
        log(f'{script} {" ".join(overrides)} on the card: '
            f'{time.perf_counter() - start:.1f} s, launches {examples[name]}')
    require(all(f == l == c for f, l, c in outcomes['export_artifact']),
            f'export_artifact\'s artifact and live notes differ: '
            f'{outcomes["export_artifact"]}')
    require(examples['synthetic_demo']['lstm_scan_residuals'] > 0 and
            examples['synthetic_demo']['lstm_bptt'] > 0,
            'synthetic_demo trained without kernels E and F')
    require(examples['synthetic_tabcnn']['cqt_mag'] > 0,
            'synthetic_tabcnn computed no CQT with kernel C')
    log(f'transcribe_file wrote {len(pitches)} notes')
    result['examples'] = examples

    return result


def deployment_phases(pipeline, requests, train_batch, card):
    """Phases 35-38 under one temporary directory of the repository."""

    import tempfile

    import torch

    with tempfile.TemporaryDirectory(prefix='_chip_smoke_deploy_',
                                     dir=ROOT) as directory:
        start = time.perf_counter()
        ops = check_custom_ops(card)
        torch.cuda.empty_cache()
        artifact = serving_artifacts(pipeline, requests, card, directory)
        torch.cuda.empty_cache()
        streaming = streaming_artifact(card, directory)
        torch.cuda.empty_cache()
        measured = profiling_and_examples(pipeline, requests, train_batch,
                                          card, directory)
        torch.cuda.empty_cache()
        log(f'phases 35-38 took {time.perf_counter() - start:.1f} s')

    log(json.dumps({'serving_artifact': artifact,
                    'streaming_artifact': streaming,
                    'mfu': {k: {f: v for f, v in measured[k].items()
                                if f != 'flops_by_op'}
                            for k in ('piano_bf16', 'train_float32')}}))

    return ops, artifact, streaming, measured


# Phases 39-43: the fused layouts. OnsetsFrames2(fused_heads=True,
# fused_lms=True): the acoustic heads as one grouped conv stack and the
# independent language models as one GroupedBiLSTM, whose 2S directions
# run as one grouped launch of kernel B (serving) or E and F (training)

FUSED_GROUPS = 4           # O&F2's onset and offset BiLSTMs, both ways
FUSED_VELOCITY_GROUPS = 6  # with the velocity head
# Both layouts serve 64 x 60 s: at 128 the fused stack holds all three
# heads' conv1 activations at once (bf16 15.8 GB, and the float32 copy its
# eval-mode BatchNorm makes, 31.7 GB), and the next allocation found no
# room on an 80 GB H100 (65.3 GB in use before it)
FUSED_SERVING_CLIPS = BATCH // 2
FUSED_TRAIN_STEPS = 10     # train() steps a timed turn
FUSED_FLOAT32_CLIPS = 8


def fused_twin(model, **kwargs):
    """The fused layout of a per-head O&F2 on the same weights, through
    ``fuse_acoustic_variables`` (with ``fused_heads``) and
    ``fuse_lm_variables``, on the same device."""

    import torch

    from amt_tools_tpu_torch.models import (OnsetsFrames2,
                                            fuse_acoustic_variables,
                                            fuse_lm_variables)

    options = dict(dim_in=model.dim_in, profile=model.profile,
                   in_channels=model.in_channels,
                   model_complexity=model.model_complexity,
                   dtype=model.dtype, dropout=model.dropout,
                   estimate_velocity=model.estimate_velocity,
                   fused_heads=True, fused_lms=True)
    options.update(kwargs)
    fused = OnsetsFrames2(generator=torch.Generator().manual_seed(0),
                          **options)
    state = model.state_dict()
    if options['fused_heads']:
        state = fuse_acoustic_variables(state, model.head_names)
    fused.load_state_dict(fuse_lm_variables(state, model._fused_lm_streams))

    return fused.to(next(model.parameters()).device)


def grouped_design(batch, groups, dtype, residuals=False, bptt=False):
    """A grouped launch's cluster plan, as a dict and a line of text."""

    import torch

    from amt_tools_tpu_torch.ops.lstm_kernel import (bptt_launch_plan,
                                                     scan_launch_plan)

    device = torch.device('cuda')
    plan = (bptt_launch_plan(batch, HIDDEN, dtype, device, groups) if bptt
            else scan_launch_plan(batch, HIDDEN, dtype, device, residuals,
                                  groups))
    text = (f'{groups} groups x {-(-batch // plan["rows"])} clusters = '
            f'{plan["clusters"]} clusters of 8 CTAs, {plan["rows"]} rows a '
            f'cluster, {plan["active_clusters"]} active, {plan["waves"]} '
            f'wave(s), {plan["smem_bytes"]} bytes of shared memory')

    return plan, text


def grouped_errors(got, per_stream, ref, tol, mean_tol, relative):
    """A grouped output against its per-stream launches (bit for bit, or
    else held to the plain-version tolerances) and against its plain
    version: (bit for bit, max and mean against the streams, against the
    plain version)."""

    import torch

    equal = all(bool(torch.equal(a, b)) for a, b in zip(got, per_stream))
    streams = lstm_errors(got, torch.stack(per_stream))
    plain = lstm_errors(got, ref)
    pick = (2, 3) if relative else (0, 1)

    for label, errs in (('the per-stream launches', streams),
                        ('its plain version', plain)):
        require(errs[pick[0]] <= tol and errs[pick[1]] <= mean_tol,
                f'a grouped launch disagrees with {label}: {errs}')

    return equal, streams, plain


def check_grouped_lstm(card):
    """Phase 39: grouped kernels B, E and F (one launch for G sequences)
    at the recipe shapes (G = 4 directions, B = 8, T = 625, H = 256),
    float32 and bf16, against G per-stream launches of the ungrouped ops
    (bit for bit expected; else held to the plain tolerances, max and mean
    printed) and against their plain versions; grouped B with lengths in
    bf16; grouped E and F at the velocity plan (G = 6, float32); grouped B
    at the fused serving shape (G = 4, ``FUSED_SERVING_CLIPS`` x 1876,
    bf16) against the per-stream launches and its plain version. Each
    timed beside the G per-stream launches, the plain version and the sum
    of the per-stream cuDNN ``nn.LSTM`` calls; the cluster plans of G = 4
    and G = 6."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops.lstm_kernel import (
        bptt_cost, lstm_bptt, lstm_bptt_grouped, lstm_bptt_grouped_plain,
        lstm_scan, lstm_scan_grouped, lstm_scan_grouped_plain,
        lstm_scan_residuals, lstm_scan_residuals_grouped,
        lstm_scan_residuals_grouped_plain, scan_cost)

    groups, split = FUSED_GROUPS, FUSED_GROUPS // 2
    result = {}
    with tools.exact_fp32():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else \
                PEAK_FP32_FLOPS
            inputs = [lstm_inputs(TRAIN_BATCH, TRAIN_FRAMES, dtype,
                                  seed=390 + g) for g in range(groups)]
            xw = torch.stack([i[3] for i in inputs])
            wh = torch.stack([i[4] for i in inputs])
            wht = wh.transpose(1, 2).contiguous()
            g = torch.Generator().manual_seed(39)
            dout = torch.randn(groups, TRAIN_BATCH, TRAIN_FRAMES, HIDDEN,
                               generator=g).cuda().to(dtype)

            reverse = [s >= split for s in range(groups)]
            out = lstm_scan_grouped(xw, wh, split)
            res = lstm_scan_residuals_grouped(xw, wh, split)
            da = lstm_bptt_grouped(res[1], res[2], dout, wht, split)
            alone = [lstm_scan_residuals(xw[s], wh[s], reverse[s])
                     for s in range(groups)]
            checks = {
                'B': grouped_errors(
                    out, [lstm_scan(xw[s], wh[s], reverse[s])
                          for s in range(groups)],
                    lstm_scan_grouped_plain(xw, wh, split), LSTM_TOL[name],
                    LSTM_MEAN_TOL[name], relative=False),
                'E gates': grouped_errors(
                    res[1], [a[1] for a in alone],
                    lstm_scan_residuals_grouped_plain(xw, wh, split)[1],
                    RESIDUAL_TOL[name], RESIDUAL_MEAN_TOL[name],
                    relative=True),
                'F': grouped_errors(
                    da, [lstm_bptt(res[1][s], res[2][s], dout[s], wht[s],
                                   reverse[s]) for s in range(groups)],
                    lstm_bptt_grouped_plain(res[1], res[2], dout, wht, split),
                    BPTT_TOL[name], BPTT_MEAN_TOL[name], relative=True)}
            require(torch.equal(res[0], out),
                    f'grouped E {name} h differs from grouped B')
            log(f'grouped lstm {name}, G={groups} (groups {split}.. '
                f'reversed) at B={TRAIN_BATCH}, T={TRAIN_FRAMES}, '
                f'H={HIDDEN}: ' + '; '.join(
                    f'{k} bit for bit the per-stream launches {eq} (max '
                    f'{s[0]:.3g}, mean {s[1]:.3g}), against the plain '
                    f'version max {p[0]:.3g} mean {p[1]:.3g} ({p[2]:.3g} of '
                    f'the largest)' for k, (eq, s, p) in checks.items()))

            if dtype == torch.bfloat16:
                lengths = torch.tensor([625, 600, 512, 400, 313, 200, 64, 1],
                                       dtype=torch.int32, device='cuda')
                masked = lstm_scan_grouped(xw, wh, split, lengths)
                eq, s, p = grouped_errors(
                    masked, [lstm_scan(xw[k], wh[k], reverse[k],
                                       lengths=lengths)
                             for k in range(groups)],
                    lstm_scan_grouped_plain(xw, wh, split, lengths),
                    LSTM_TOL[name], LSTM_MEAN_TOL[name], relative=False)
                log(f'grouped lstm bf16 with lengths {lengths.tolist()}: bit '
                    f'for bit the per-stream masked launches {eq} (max '
                    f'{s[0]:.3g}), against the plain version max {p[0]:.3g} '
                    f'mean {p[1]:.3g}')

            # Times: the grouped launch, its G per-stream launches, the
            # plain version, the sum of the per-stream cuDNN nn.LSTM calls
            modules = [cudnn_lstm(i[0], i[1], i[2], dtype) for i in inputs]
            lib_outs = [m(x)[0] for m, x in modules]
            params = [[x] + list(m.parameters()) for m, x in modules]
            entry = {}
            for label, kernel, streams, plain, library, cost in (
                    ('B', lambda: lstm_scan_grouped(xw, wh, split),
                     lambda: [lstm_scan(xw[s], wh[s], reverse[s])
                              for s in range(groups)],
                     lambda: lstm_scan_grouped_plain(xw, wh, split),
                     lambda: [m(x) for m, x in modules],
                     scan_cost(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, dtype)),
                    ('E', lambda: lstm_scan_residuals_grouped(xw, wh, split),
                     lambda: [lstm_scan_residuals(xw[s], wh[s], reverse[s])
                              for s in range(groups)],
                     lambda: lstm_scan_residuals_grouped_plain(xw, wh,
                                                               split),
                     lambda: [m(x) for m, x in modules],
                     scan_cost(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, dtype,
                               residuals=True)),
                    ('F', lambda: lstm_bptt_grouped(res[1], res[2], dout, wht,
                                                    split),
                     lambda: [lstm_bptt(res[1][s], res[2][s], dout[s],
                                        wht[s], reverse[s])
                              for s in range(groups)],
                     lambda: lstm_bptt_grouped_plain(res[1], res[2], dout,
                                                     wht, split),
                     lambda: [torch.autograd.grad(o, p, d, retain_graph=True)
                              for o, p, d in zip(lib_outs, params, dout)],
                     bptt_cost(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, dtype))):
                bound, bound_by = bound_ms(groups * cost[1],
                                           groups * cost[0], peak)
                plan, design = grouped_design(TRAIN_BATCH, groups, dtype,
                                              residuals=label == 'E',
                                              bptt=label == 'F')
                entry[label] = {
                    'ms': time_ms(kernel, reps=5),
                    'per_stream_ms': time_ms(streams, reps=5),
                    'plain_ms': time_ms(plain, reps=1),
                    'library_ms': time_ms(library, reps=5),
                    'bound_ms': bound, 'bound_by': bound_by,
                    'max_abs_err': checks['E gates' if label == 'E' else
                                          label][2][0],
                    'groups': groups, 'geometry': plan}
                log(f'grouped {label} {name}, G={groups} at B={TRAIN_BATCH}, '
                    f'T={TRAIN_FRAMES}: one launch {entry[label]["ms"]:.3f} '
                    f'ms against {groups} per-stream launches '
                    f'{entry[label]["per_stream_ms"]:.3f} ms, plain '
                    f'{entry[label]["plain_ms"]:.3f} ms, {groups} cuDNN '
                    f'nn.LSTM {"backwards" if label == "F" else "forwards"} '
                    f'{entry[label]["library_ms"]:.3f} ms, bound '
                    f'{bound:.3f} ms ({bound_by}); {design} ({card})')
            result[name] = entry
            del modules, lib_outs, params
            torch.cuda.empty_cache()

        for groups_at in (FUSED_GROUPS, FUSED_VELOCITY_GROUPS):
            for bptt in (False, True):
                _, design = grouped_design(TRAIN_BATCH, groups_at,
                                           torch.float32, residuals=not bptt,
                                           bptt=bptt)
                log(f'grouped {"F" if bptt else "E"} plan, G={groups_at}, '
                    f'B={TRAIN_BATCH}, float32: {design}')

        # The velocity model's plan: grouped E and F at G = 6 (three
        # BiLSTMs, both ways), float32, 8 x 625
        vgroups = FUSED_VELOCITY_GROUPS
        vsplit = vgroups // 2
        inputs = [lstm_inputs(TRAIN_BATCH, TRAIN_FRAMES, torch.float32,
                              seed=395 + g) for g in range(vgroups)]
        xw = torch.stack([i[3] for i in inputs])
        wh = torch.stack([i[4] for i in inputs])
        wht = wh.transpose(1, 2).contiguous()
        dout = torch.randn(vgroups, TRAIN_BATCH, TRAIN_FRAMES, HIDDEN,
                           generator=torch.Generator().manual_seed(395)).cuda()
        res = lstm_scan_residuals_grouped(xw, wh, vsplit)
        da = lstm_bptt_grouped(res[1], res[2], dout, wht, vsplit)
        alone = [lstm_scan_residuals(xw[s], wh[s], s >= vsplit)
                 for s in range(vgroups)]
        velocity = {
            'E gates': grouped_errors(
                res[1], [a[1] for a in alone],
                lstm_scan_residuals_grouped_plain(xw, wh, vsplit)[1],
                RESIDUAL_TOL['float32'], RESIDUAL_MEAN_TOL['float32'],
                relative=True),
            'F': grouped_errors(
                da, [lstm_bptt(res[1][s], res[2][s], dout[s], wht[s],
                               s >= vsplit) for s in range(vgroups)],
                lstm_bptt_grouped_plain(res[1], res[2], dout, wht, vsplit),
                BPTT_TOL['float32'], BPTT_MEAN_TOL['float32'],
                relative=True)}
        log(f'grouped lstm float32, G={vgroups} (the velocity plan) at '
            f'B={TRAIN_BATCH}, T={TRAIN_FRAMES}: ' + '; '.join(
                f'{k} bit for bit the per-stream launches {eq} (max '
                f'{s[0]:.3g}), against the plain version max {p[0]:.3g} '
                f'mean {p[1]:.3g} ({p[2]:.3g} of the largest)'
                for k, (eq, s, p) in velocity.items()))
        result['float32']['velocity'] = {
            k: {'bit_for_bit': eq, 'max_abs_err': p[0]}
            for k, (eq, s, p) in velocity.items()}
        del inputs, xw, wh, wht, dout, res, da, alone
        torch.cuda.empty_cache()

        # The fused serving shape (phase 40): four directions of
        # FUSED_SERVING_CLIPS clips of 60 s, bf16, against the per-stream
        # launches and the plain version with phase 4's tolerances
        clips = FUSED_SERVING_CLIPS
        frames = 1 + int(CLIP_SECONDS * SAMPLE_RATE) // HOP
        g = torch.Generator().manual_seed(391)
        xw = (torch.randn(groups, clips, frames, 4 * HIDDEN, generator=g) *
              0.5).cuda().to(torch.bfloat16)
        wh = torch.stack([torch.nn.init.orthogonal_(
            torch.empty(HIDDEN, 4 * HIDDEN), generator=g)
            for _ in range(groups)]).cuda().to(torch.bfloat16)
        out = lstm_scan_grouped(xw, wh, split)
        equal, s, p = grouped_errors(
            out, [lstm_scan(xw[k], wh[k], k >= split) for k in range(groups)],
            lstm_scan_grouped_plain(xw, wh, split), LSTM_TOL['bfloat16'],
            LSTM_MEAN_TOL['bfloat16'], relative=False)
        ms = time_ms(lambda: lstm_scan_grouped(xw, wh, split), reps=3)
        per_ms = time_ms(lambda: [lstm_scan(xw[k], wh[k], k >= split)
                                  for k in range(groups)], reps=3)
        flops, num_bytes = scan_cost(clips, frames, HIDDEN, torch.bfloat16)
        bound, bound_by = bound_ms(groups * num_bytes, groups * flops,
                                   PEAK_BF16_FLOPS)
        plan, design = grouped_design(clips, groups, torch.bfloat16)
        log(f'grouped B bf16 at the fused serving shape, G={groups}, '
            f'B={clips}, T={frames}: bit for bit the per-stream launches '
            f'{equal} (max {s[0]:.3g}), against the plain version max '
            f'{p[0]:.3g} mean {p[1]:.3g}; one launch {ms:.3f} ms against '
            f'{groups} per-stream launches {per_ms:.3f} ms, bound '
            f'{bound:.3f} ms ({bound_by}); {design} ({card})')
        result['bfloat16']['B serving'] = {
            'ms': ms, 'per_stream_ms': per_ms, 'bound_ms': bound,
            'bound_by': bound_by, 'bit_for_bit': equal, 'max_abs_err': p[0],
            'clips': clips, 'groups': groups, 'geometry': plan}
        del xw, wh, out
        torch.cuda.empty_cache()

    return result


def parity_rows(got, ref, tol):
    """Phase 33's rule for two sets of logits on the host: the thresholded
    maps may differ only where the reference logit is within ``tol`` of
    the threshold. Returns the (B, 88) rows whose maps differ, the number
    of differing cells and the worst logit difference."""

    import torch

    from amt_tools_tpu_torch.ops import decode

    rows, cells, worst = None, 0, 0.0
    for key in ref:
        a, b = got[key], ref[key]
        worst = max(worst, (a.float() - b.float()).abs().max().item())
        differ = (decode.threshold(decode.sigmoid(a.transpose(-1, -2))) !=
                  decode.threshold(decode.sigmoid(b.transpose(-1, -2))))
        require(bool((b.transpose(-1, -2)[differ].float().abs() <= tol)
                     .all()), f'fused {key} maps differ away from the '
                              f'threshold')
        cells += int(differ.sum())
        rows = differ.any(-1) if rows is None else rows | differ.any(-1)

    return rows, cells, worst


def notes_outside(rows, got, ref, profile):
    """Every note of the pitch rows whose maps agree equal; the count of
    notes compared."""

    compared = 0
    for b, ((p_got, i_got), (p_ref, i_ref)) in enumerate(zip(got, ref)):
        keep_got = ~rows[b].numpy()[p_got.astype(int) - profile.low]
        keep_ref = ~rows[b].numpy()[p_ref.astype(int) - profile.low]
        require(np.array_equal(p_got[keep_got], p_ref[keep_ref]) and
                np.array_equal(i_got[keep_got], i_ref[keep_ref]),
                f'clip {b}: fused notes differ from the per-head notes')
        compared += int(keep_ref.sum())

    return compared


def serve_fused(pipeline, requests, card):
    """Phase 40: phase 5's bf16 piano pipeline and its fused twin on the
    same weights, 3 requests of ``FUSED_SERVING_CLIPS`` x 60 s each: A
    once and grouped B twice (onset and offset at G = 4, adjoin_lm at G =
    2) a fused dispatch; the
    logits of the first request within ``LAYOUT_TOL`` of the per-head
    pipeline's and its notes equal to theirs under phase 33's rule, the
    maps differing only within ``LAYOUT_TOL`` of the largest logit of the
    threshold; audio-s per wall-s in turns (per-head, fused, fused,
    per-head) and peak memory a batch. A float32 pair at
    ``FUSED_FLOAT32_CLIPS`` clips: logits within ``LOGIT_TOL`` (PARITY.md)
    and the notes under that rule."""

    import torch

    from amt_tools_tpu_torch.serving import (TranscriptionPipeline,
                                             calibrate_activity)

    model, mel = pipeline.model, pipeline.data_proc
    profile = model.profile
    requests = [r[:FUSED_SERVING_CLIPS] for r in requests]
    fused = fused_twin(model).eval()
    fused_pipeline = TranscriptionPipeline(fused, mel, capacity=CAPACITY)
    fused_pipeline(requests[0][:8])  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    results, _ = serve_requests(fused_pipeline, requests)
    launches = read_launches()
    log(f'fused piano serving, {REQUESTS} requests of {FUSED_SERVING_CLIPS} '
        f'x {CLIP_SECONDS:.0f} s: launches {launches}')
    require(launches['stft_power'] == launches['stft_power_fft'] == REQUESTS,
            'fused serving: A did not run once a dispatch')
    require(launches['lstm_scan_grouped'] == 2 * REQUESTS and
            launches['lstm_scan'] == 2 * REQUESTS,
            'fused serving: not two grouped B a dispatch')

    # Channels-last, the grouped convs run other cuDNN kernels than the
    # per-head ones: the two layouts' logits are held to each other as each
    # is to its NCHW forward (phase 51), and a map may differ only within
    # that bound of the threshold
    got = piano_logits(fused, mel, requests[0])
    want = piano_logits(model, mel, requests[0])
    for key in want:
        layout_gap(got[key], want[key], f'fused against per-head {key}')
    band = LAYOUT_TOL[0] * max(v.abs().max().item() for v in want.values())
    rows, cells, worst = parity_rows(got, want, band)
    compared = notes_outside(rows, results[0], pipeline(requests[0]),
                             profile)
    log(f'fused against per-head bf16 at {FUSED_SERVING_CLIPS} clips: logits '
        f'within {worst:.3g}; {cells} map cells differ (each within '
        f'{band:.3g} of the threshold); notes identical in '
        f'{88 * FUSED_SERVING_CLIPS - int(rows.sum())} of '
        f'{88 * FUSED_SERVING_CLIPS} pitch rows, {compared} notes compared')
    require(compared > 0, 'fused serving: no notes compared')

    times = {}
    runs = {'per-head': pipeline, 'fused': fused_pipeline}
    for turn in ('per-head', 'fused', 'fused', 'per-head'):
        _, elapsed = serve_requests(runs[turn], requests)
        times.setdefault(turn, []).append(elapsed)
    audio_seconds = REQUESTS * FUSED_SERVING_CLIPS * CLIP_SECONDS
    rates = {turn: [audio_seconds / t for t in ts]
             for turn, ts in times.items()}
    peaks = {turn: batch_peaks(runs[turn], requests[:1])[0]
             for turn in ('per-head', 'fused')}
    log(f'audio-s per wall-s, {REQUESTS} requests of {FUSED_SERVING_CLIPS} x '
        f'{CLIP_SECONDS:.0f} s in turns (per-head, fused, fused, per-head): '
        f'{rates}; peak memory a batch {peaks} GB ({card})')

    # Float32 at a few clips: PARITY.md's logit bound
    model32 = piano_model(None, 40)
    calibrate_activity(model32, mel, requests[0][:4].cpu().numpy())
    fused32 = fused_twin(model32).eval()
    audio32 = requests[0][:FUSED_FLOAT32_CLIPS]
    rows32, cells32, worst32 = parity_rows(
        piano_logits(fused32, mel, audio32),
        piano_logits(model32, mel, audio32), LOGIT_TOL)
    compared32 = notes_outside(
        rows32, TranscriptionPipeline(fused32, mel, capacity=CAPACITY)(
            audio32),
        TranscriptionPipeline(model32, mel, capacity=CAPACITY)(audio32),
        profile)
    log(f'fused against per-head float32 at {FUSED_FLOAT32_CLIPS} clips: '
        f'logits within {worst32:.3g} (tolerance {LOGIT_TOL}); {cells32} map '
        f'cells differ; {compared32} notes compared')
    require(worst32 <= LOGIT_TOL, 'fused float32 logits differ from the '
                                  'per-head logits')
    del model32, fused32
    torch.cuda.empty_cache()

    return {'launches': launches, 'rates': rates, 'peak_gb': peaks,
            'logit_err_bf16': worst, 'logit_err_float32': worst32,
            'pipeline': fused_pipeline, 'requests': requests}


def split_heads(fused_store, heads):
    """Pre-ReLU values of the grouped stack, by per-head name: the
    head-blocked channels of ``grouped_am.BatchNorm_<i>`` become
    ``<head>_am.BatchNorm_<i>``."""

    split = {}
    for name, value in fused_store.items():
        layer = name.split('.', 1)[1]
        for head, part in zip(heads, value.chunk(len(heads), dim=1)):
            split[f'{head}_am.{layer}'] = part

    return split


def first_step(model, batch):
    """One float32 training step's losses, gradients and pre-ReLU values
    (no optimizer step)."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import run_on_batch
    from amt_tools_tpu_torch.train import _place_batch, step_generator

    pre_relu = {}
    hooks = record_pre_relu(model, pre_relu)
    output = run_on_batch(model, _place_batch(batch, torch.device('cuda')),
                          train=True, generator=step_generator(0, 0, 'cuda'))
    for hook in hooks:
        hook.remove()
    loss = output[tools.KEY_LOSS]
    loss[tools.KEY_LOSS_TOTAL].backward()

    return ({k: v.item() for k, v in loss.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()}, pre_relu)


def train_fused(batch, card):
    """Phase 41: O&F2 complexity 3, float32, 8 x 625, Adam, per-head and
    fused on the same weights. The first step without dropout: losses
    within ``LOSS_TOL`` and gradients under phase 12b's rule (the fused
    gradients mapped to per-head names by the converters, the ReLU and
    max-pool decisions the layouts took differently counted per stack).
    Then ``train()`` with dropout, ``FUSED_TRAIN_STEPS`` steps a turn
    (per-head, fused_lms, fused, fused, fused_lms, per-head; ``fused_lms``
    is the grouped language models under per-head acoustic stacks): E and
    F three times a step per-head and twice with either fused layout, every
    launch grouped; steps/s; and E + F's device ms a step
    at the step's shapes by CUDA events."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import (OnsetsFrames2,
                                            unfuse_acoustic_variables,
                                            unfuse_lm_variables)
    from amt_tools_tpu_torch.ops.lstm_kernel import (
        lstm_bptt_grouped, lstm_scan_residuals_grouped)
    from amt_tools_tpu_torch.train import train

    tools.use_exact_fp32()
    per_head = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                             model_complexity=3, dropout=False,
                             generator=torch.Generator().manual_seed(41))
    per_head = per_head.cuda()
    fused = fused_twin(per_head)
    heads, streams = per_head.head_names, per_head._fused_lm_streams

    (ref_loss, ref_grads, ref_pre) = first_step(per_head, batch)
    (got_loss, got_grads, got_pre) = first_step(fused, batch)
    got_grads = unfuse_lm_variables(unfuse_acoustic_variables(
        got_grads, heads), streams)
    got_pre = split_heads(got_pre, heads)
    loss_err = max(abs(got_loss[k] - ref_loss[k]) / abs(ref_loss[k])
                   for k in ref_loss)
    flips = {conv_block(name): decision_flips(ref, got_pre[name],
                                              pooled=conv_block(name)[1] > 0)
             for name, ref in ref_pre.items()}
    ratios = []
    for name, ref in ref_grads.items():
        module = name.rsplit('.', 1)[0]
        scale = max(g.abs().max().item() for n, g in ref_grads.items()
                    if n.rsplit('.', 1)[0] == module)
        err = (got_grads[name] - ref).abs().max().item() / scale
        tol = GRAD_TOL
        block = conv_block(name)
        if block is not None and any(
                sum(counts) for (stack, later), counts in flips.items()
                if stack == block[0] and later >= block[1]):
            tol = CONV_BLOCK_GRAD_TOL
        ratios.append((err / tol, err, name))
    ratio, err, worst_name = max(ratios)
    log(f'first float32 step, fused against per-head (no dropout): losses '
        f'within {loss_err:.3g} (relative; tolerance {LOSS_TOL}); differing '
        f'ReLU/max-pool decisions by stack and block '
        f'{ {f"{s} {i}": c for (s, i), c in sorted(flips.items())} }; '
        f'gradients at most {ratio:.3g} of their tolerance (worst '
        f'{worst_name}, {err:.3g} of its module\'s largest)')
    require(loss_err <= LOSS_TOL, 'fused training losses differ from the '
                                  'per-head losses')
    require(ratio <= 1.0, 'fused training gradients differ from the '
                          'per-head gradients')
    del fused, per_head, ref_pre, got_pre
    torch.cuda.empty_cache()

    # Steps/s in turns through train(), dropout on: per-head, the grouped
    # language models alone (fused_lms), and both fused layouts
    loader = FixedLoader([batch])
    models = {'per-head': piano_model(None, 42).cuda()}
    models['fused_lms'] = fused_twin(models['per-head'], fused_heads=False)
    models['fused'] = fused_twin(models['per-head'])
    rates, launches = {}, {}
    for turn in ('per-head', 'fused_lms', 'fused', 'fused', 'fused_lms',
                 'per-head'):
        model = models[turn]
        optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        result = train(model, loader, optimizer, FUSED_TRAIN_STEPS,
                       log_dir=None, seed=0)
        torch.cuda.synchronize()
        rates.setdefault(turn, []).append(
            result['step'] / (time.perf_counter() - start))
        launches[turn] = read_launches()
        require(all(np.isfinite(v).all() for v in result['losses'].values()),
                f'{turn} training: a loss is not finite')
    steps = FUSED_TRAIN_STEPS
    for turn, per_step in (('per-head', 3), ('fused_lms', 2), ('fused', 2)):
        counts = launches[turn]
        require(counts['lstm_scan_residuals_grouped'] == per_step * steps and
                counts['lstm_bptt_grouped'] == per_step * steps and
                counts['lstm_scan_residuals'] == per_step * steps and
                counts['lstm_bptt'] == per_step * steps and
                counts['lstm_scan'] == 0,
                f'{turn} training: not grouped E and F {per_step} times a '
                f'step')
    log(f'training O&F2 complexity 3 float32, {TRAIN_BATCH} x '
        f'{TRAIN_FRAMES}, Adam, {steps} steps a turn (per-head, fused_lms, '
        f'fused, fused, fused_lms, per-head): steps/s {rates} ({card}); '
        f'launches a run {launches}')

    # E + F device ms a step at the step's shapes: the grouped onset and
    # offset BiLSTMs plus adjoin_lm's, against one launch of E and one of F
    # a BiLSTM
    def shapes(groups, width):
        g = torch.Generator().manual_seed(410 + groups)
        xw = torch.randn(groups, TRAIN_BATCH, TRAIN_FRAMES, 4 * HIDDEN,
                         generator=g).cuda() * 0.5
        wh = torch.randn(groups, HIDDEN, 4 * HIDDEN, generator=g).cuda() * \
            width
        return xw, wh, wh.transpose(1, 2).contiguous(), torch.randn(
            groups, TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, generator=g).cuda()

    xw, wh, wht, dout = shapes(6, 0.05)
    # Each launch's groups [a, b) and its reverse_from
    layouts = {'per-head': [(0, 2, 1), (2, 4, 1), (4, 6, 1)],
               'fused': [(0, 4, 2), (4, 6, 1)]}
    res = {(a, b, r): lstm_scan_residuals_grouped(xw[a:b], wh[a:b], r)
           for layout in layouts.values() for a, b, r in layout}

    def step(layout):
        for a, b, r in layout:
            lstm_scan_residuals_grouped(xw[a:b], wh[a:b], r)
            lstm_bptt_grouped(res[a, b, r][1], res[a, b, r][2], dout[a:b],
                              wht[a:b], r)

    e_f = {}
    for turn in ('per-head', 'fused', 'fused', 'per-head'):
        e_f.setdefault(turn, []).append(
            time_ms(lambda: step(layouts[turn]), reps=5))
    log(f'E + F device ms a float32 step at {TRAIN_BATCH} x {TRAIN_FRAMES} '
        f'(CUDA events, in turns): {e_f} ({card})')

    return {'rates': rates, 'launches': launches, 'e_f_ms': e_f,
            'loss_err': loss_err, 'grad_ratio': ratio,
            'models': models, 'loader': loader}


def train_fused_velocity(batch, card):
    """Phase 42: the velocity model (G = 6: three BiLSTMs, both ways),
    per-head and fused on the same weights, ``FUSED_TRAIN_STEPS`` steps of
    ``train()`` a turn (per-head, fused, fused, per-head): grouped E and F
    twice a step, the G = 6 launch at 4 rows a cluster (12 clusters), and
    four times per-head; steps/s."""

    import torch

    from amt_tools_tpu_torch.train import train

    per_head = velocity_model(42).cuda()
    models = {'per-head': per_head, 'fused': fused_twin(per_head)}
    rates, launches = {}, {}
    for turn in ('per-head', 'fused', 'fused', 'per-head'):
        model = models[turn]
        optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        result = train(model, FixedLoader([batch]), optimizer,
                       FUSED_TRAIN_STEPS, log_dir=None, seed=0)
        torch.cuda.synchronize()
        rates.setdefault(turn, []).append(
            result['step'] / (time.perf_counter() - start))
        launches[turn] = read_launches()
    counts = launches['fused']
    require(counts['lstm_scan_residuals_grouped'] ==
            counts['lstm_bptt_grouped'] ==
            counts['lstm_scan_residuals'] == 2 * FUSED_TRAIN_STEPS,
            'fused velocity training: not grouped E and F twice a step')
    require(launches['per-head']['lstm_scan_residuals'] ==
            4 * FUSED_TRAIN_STEPS, 'velocity training: E not 4 times a step')
    plans = {}
    for kernel, bptt in (('E', False), ('F', True)):
        plans[kernel], design = grouped_design(
            TRAIN_BATCH, FUSED_VELOCITY_GROUPS, torch.float32,
            residuals=not bptt, bptt=bptt)
        log(f'fused velocity step, grouped {kernel}: {design}')
    log(f'velocity training float32, {FUSED_TRAIN_STEPS} steps a turn '
        f'(per-head, fused, fused, per-head): steps/s {rates} ({card}); '
        f'launches {launches}')

    return {'rates': rates, 'launches': launches, 'plans': plans}


def fused_artifact(serving, card, directory):
    """Phase 43: the fused bf16 pipeline of phase 40 exported
    (``export.save_serving``) with its requests' batch as the example, and
    loaded, with a symbolic batch: notes equal to the live fused
    pipeline's, A once and grouped B twice a call; the same
    artifact at ``ARTIFACT_SYMBOLIC_CLIPS`` clips."""

    import torch

    from amt_tools_tpu_torch import export

    pipeline, requests = serving['pipeline'], serving['requests']
    path = os.path.join(directory, 'piano_fused_bf16.amtx')
    start = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        meta = export.save_serving(path, pipeline, requests[0].shape[-1],
                                   batch_size=requests[0].shape[0])
    export_s = time.perf_counter() - start
    for warning in caught:
        log(f'fused export: {str(warning.message)[:300]}')
    artifact = export.load_serving(path)
    artifact(requests[0])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    frozen = artifact(requests[0])
    torch.cuda.synchronize()
    launches = read_launches()
    equal, clips = notes_equal(frozen, pipeline(requests[0]))
    log(f'fused serving artifact: exported in {export_s:.1f} s, symbolic '
        f'batch {meta["symbolic_batch"]}; at {clips} clips notes equal to '
        f'the live fused pipeline\'s in {equal}; launches a call {launches} '
        f'({card})')
    require(equal == clips, 'the fused artifact\'s notes differ from the '
                            'live fused pipeline\'s')
    require(launches['stft_power'] == 1 and
            launches['lstm_scan_grouped'] == 2 and
            launches['lstm_scan'] == 2,
            'the fused artifact did not run A once and grouped B twice a '
            'call')
    require(meta['symbolic_batch'], 'the fused artifact did not export '
                                    'with a symbolic batch')
    sub = requests[0][:ARTIFACT_SYMBOLIC_CLIPS]
    equal_sub, _ = notes_equal(artifact(sub), pipeline(sub))
    require(equal_sub == ARTIFACT_SYMBOLIC_CLIPS,
            f'the fused artifact at {ARTIFACT_SYMBOLIC_CLIPS} clips differs '
            f'from the live fused pipeline')
    del artifact
    torch.cuda.empty_cache()

    return {'launches': launches, 'export_s': export_s,
            'symbolic_batch': meta['symbolic_batch']}


def fused_phases(pipeline, requests, velocity_batch, card):
    """Phases 39-43. Returns the readings and the profiler entries of one
    fused piano batch and one fused training step."""

    import tempfile

    import torch

    from amt_tools_tpu_torch.train import (_place_batch, make_train_step,
                                           step_generator)

    start = time.perf_counter()
    grouped = check_grouped_lstm(card)
    torch.cuda.empty_cache()
    serving = serve_fused(pipeline, requests, card)
    torch.cuda.empty_cache()
    training = train_fused(velocity_batch, card)
    torch.cuda.empty_cache()
    velocity = train_fused_velocity(velocity_batch, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix='_chip_smoke_deploy_',
                                     dir=ROOT) as directory:
        artifact = fused_artifact(serving, card, directory)
    log(f'phases 39-43 in {time.perf_counter() - start:.1f} s')

    model = training['models']['fused']
    step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                   lr=LEARNING_RATE))
    device_batch = _place_batch(velocity_batch, torch.device('cuda'))
    step(device_batch, step_generator(0, 0, 'cuda'))
    fused_pipeline, fused_requests = serving['pipeline'], serving['requests']
    entries = [
        (f'fused piano batch of {FUSED_SERVING_CLIPS} clips',
         lambda: fused_pipeline(fused_requests[0]),
         ('stft_power_fft_kernel', 'lstm_scan_kernel')),
        (f'fused float32 training step of {TRAIN_BATCH} x {TRAIN_FRAMES} '
         f'frames', lambda: step(device_batch, step_generator(0, 1, 'cuda')),
         ('lstm_scan_kernel', 'lstm_bptt_kernel'))]
    del serving['pipeline'], serving['requests'], training['models']

    return {'grouped': grouped, 'serving': serving, 'training': training,
            'velocity': velocity, 'artifact': artifact}, entries


# Phases 44-47: masked and carried training (kernels E and F with per-row
# lengths and a float32 carry), then the port's side of the convergence
# differential

# Phase 44: valid lengths of the 8 x 625 rows, spread over 313-625 with one
# row empty and one whole, and the chunks that thread a carry
TRAIN_LENGTHS = (625, 0, 313, 390, 455, 510, 575, 620)
CARRY_CHUNK_FRAMES = 125
# The initial carry's gradient against the plain version, max over the
# largest and mean over the mean magnitude: float32 as kernel F's da; in
# bf16 a sum over 4H of da rounded to bf16, where an occasional da the two
# versions compounded apart rounds the other way (tests/test_torch_cuda.py
# CARRY_GRAD_TOL)
CARRY_GRAD_TOL = {'float32': (1e-4, 1e-5), 'bfloat16': (5e-4, 5e-4)}
CHUNK_GRAD_TOL = {'float32': 1e-6, 'bfloat16': 5e-4}
ONLINE_CHUNKS = 5
CHUNK_LM_GRAD_TOL = 1e-5
# Phase 47 (tests/test_torch_convergence.py, which checks these against the
# JAX package's run): held-out frame and note F1 of the JAX package's 500
# Adam steps of O&F complexity 2 on the 13-key corpus from the port's
# seeded weights, and the agreement the port's run on the card must reach
CONVERGENCE_JAX_F1 = {'frame': 0.7464994255074684, 'note': 0.7663043478260869}
CONVERGENCE_TOL = {'frame': 0.04, 'note': 0.10}
CONVERGENCE_STEPS = 500


def route_errors(worst, pairs):
    """Fold ``lstm_errors`` of each (key, got, ref) into ``worst``."""

    for key, got, ref in pairs:
        worst[key] = tuple(max(u, v) for u, v in
                           zip(worst.get(key, (0.0,) * 4),
                               lstm_errors(got, ref)))


def cudnn_masked_ms(x, w_x, w_h, dtype, lengths, carry):
    """cuDNN ``nn.LSTM`` forward and backward (each alone, ms) on the same
    weights: on a ``pack_padded_sequence`` batch (cuDNN takes no empty
    row: a length of 0 counts as 1) or from ``(h0, c0)``."""

    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    module, xd = cudnn_lstm(x, w_x, w_h, dtype)
    if lengths is not None:
        packed = pack_padded_sequence(xd, lengths.clamp(min=1).cpu(),
                                      batch_first=True, enforce_sorted=False)

        def forward():
            return module(packed)[0].data
    else:
        state = tuple(v.to(dtype)[None].contiguous() for v in carry[::-1])

        def forward():
            return module(xd, state)[0]

    forward_ms = time_ms(forward, reps=5)
    out = forward()
    grad = torch.randn_like(out)
    params = [xd] + list(module.parameters())
    backward_ms = time_ms(lambda: torch.autograd.grad(
        out, params, grad, retain_graph=True), reps=5)

    return forward_ms, backward_ms


def check_masked_carried_lstm(card):
    """Phase 44: masked and carried kernels E and F at the training shape
    (8 x 625, H = 256), both directions, float32 and bf16: against their
    plain versions (phases 10 and 11's tolerances; the initial carry's
    gradient by ``CARRY_GRAD_TOL``), lengths = T and a zero carry bit for
    bit the unmasked launches, chunks of 125 frames that thread the carry
    through the differentiable recurrence against one call, grouped masked
    E and F at G = 4 bit for bit four per-stream masked launches; each
    timed beside the unmasked launch, the plain version and cuDNN; the
    bounds from the valid steps. Returns the entries of E and F by route
    (float32)."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.ops import lstm_kernel as lk

    lengths = torch.tensor(TRAIN_LENGTHS, dtype=torch.int32, device='cuda')
    steps = int(lengths.sum())
    entries = {}
    with tools.exact_fp32():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[-1]
            peak = (PEAK_BF16_FLOPS if dtype == torch.bfloat16 else
                    PEAK_FP32_FLOPS)
            x, w_x, w_h, xw, wh = lstm_inputs(TRAIN_BATCH, TRAIN_FRAMES,
                                              dtype, seed=44)
            g = torch.Generator().manual_seed(45)
            dout = torch.randn(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN,
                               generator=g).cuda().to(dtype)
            c0, h0, dc, dh = (0.5 * torch.randn(TRAIN_BATCH, HIDDEN,
                                                generator=g).cuda()
                              for _ in range(4))
            w_h_t = w_h.t().to(dtype).contiguous()
            full = torch.full_like(lengths, TRAIN_FRAMES)
            zeros = torch.zeros_like(c0)
            routes = {'masked': (lengths, None), 'carried': (None, (c0, h0))}
            worst = {}
            for reverse in (False, True):
                plain_e = lk.lstm_scan_residuals(xw, wh, reverse)
                plain_f = lk.lstm_bptt(plain_e[1], plain_e[2], dout, w_h_t,
                                       reverse)
                for route, (n, carry) in routes.items():
                    got = lk.lstm_scan_residuals(xw, wh, reverse, n, carry,
                                                 return_carry=bool(carry))
                    ref = lk.lstm_scan_residuals_plain(
                        xw, wh, reverse, n, carry, return_carry=bool(carry))
                    bptt_carry = (c0, dc, dh) if carry else None
                    da = lk.lstm_bptt(ref[1], ref[2], dout, w_h_t, reverse,
                                      n, bptt_carry)
                    want = lk.lstm_bptt_plain(ref[1], ref[2], dout, w_h_t,
                                              reverse, n, bptt_carry)
                    torch.cuda.synchronize()
                    if carry:
                        (da, dc0, dh0), (want, want_dc0, want_dh0) = da, want
                        route_errors(worst, (
                            (f'{route} dc0', dc0, want_dc0),
                            (f'{route} dh0', dh0, want_dh0),
                            (f'{route} c, h', torch.stack(got[3]),
                             torch.stack(ref[3]))))
                    h_prev = lk._h_prev(ref[0][None], 0 if reverse else 1,
                                        n, h0[None] if carry else None)
                    route_errors(worst, (
                        (f'{route} out', got[0], ref[0]),
                        (f'{route} gates', got[1], ref[1]),
                        (f'{route} c', got[2], ref[2]),
                        (f'{route} da', da, want),
                        (f'{route} dW_h', lk._dw_h(h_prev, da[None]),
                         lk._dw_h(h_prev, want[None]))))
                    if n is not None:
                        mask = (torch.arange(TRAIN_FRAMES, device='cuda')[None]
                                < n[:, None])
                        require(not got[0][~mask].any() and
                                not da[~mask].any(),
                                f'masked E or F {name} wrote a padded step')
                # Lengths = T, a zero carry: the unmasked launches bit for bit
                same = [torch.equal(a, b) for a, b in zip(
                    lk.lstm_scan_residuals(xw, wh, reverse, full), plain_e)]
                same += [torch.equal(a, b) for a, b in zip(
                    lk.lstm_scan_residuals(xw, wh, reverse, None,
                                           (zeros, zeros)), plain_e)]
                same.append(torch.equal(lk.lstm_bptt(
                    plain_e[1], plain_e[2], dout, w_h_t, reverse, full),
                    plain_f))
                same.append(torch.equal(lk.lstm_bptt(
                    plain_e[1], plain_e[2], dout, w_h_t, reverse, None,
                    (zeros, zeros, zeros))[0], plain_f))
                require(all(same), f'E or F {name} with lengths = T or a zero '
                                   f'carry differs from the unmasked launch')
            log(f'phase 44, E and F {name} masked and carried (8 x 625, '
                f'lengths {list(TRAIN_LENGTHS)}): ' + '; '.join(
                    f'{key} max {m:.3g} ({rel:.3g} of the largest), mean '
                    f'{mean:.3g} ({mean_rel:.3g} of the mean magnitude)'
                    for key, (m, mean, rel, mean_rel) in sorted(
                        worst.items())) +
                '; lengths = T and a zero carry bit for bit the unmasked '
                'launches')
            for route in routes:
                out_err = worst[f'{route} out']
                require(out_err[0] <= LSTM_TOL[name] and
                        out_err[1] <= LSTM_MEAN_TOL[name],
                        f'{route} E {name} h disagrees with its plain version')
                for key in ('gates', 'c'):
                    err = worst[f'{route} {key}']
                    require(err[2] <= RESIDUAL_TOL[name] and
                            err[1] <= RESIDUAL_MEAN_TOL[name],
                            f'{route} E {name} {key} disagree with the plain '
                            f'version')
                for key in ('da', 'dW_h'):
                    err = worst[f'{route} {key}']
                    require(err[2] <= BPTT_TOL[name] and
                            err[3] <= BPTT_MEAN_TOL[name],
                            f'{route} F {name} {key} disagrees with its plain '
                            f'version')
            for key in ('dc0', 'dh0'):
                err = worst[f'carried {key}']
                require(err[2] <= CARRY_GRAD_TOL[name][0] and
                        err[3] <= CARRY_GRAD_TOL[name][1],
                        f'carried F {name} {key} disagrees with its plain '
                        f'version')
            # c is unbounded: the final carry held to its largest value
            require(worst['carried c, h'][2] <= LSTM_TOL[name],
                    f'carried E {name} final carry disagrees')

            chunk_err = check_carried_chunks(xw, w_h, dout, c0, h0, dtype)
            log(f'phase 44, the carried recurrence {name} in chunks of '
                f'{CARRY_CHUNK_FRAMES} frames against one call: outputs bit '
                f'for bit, gradients within {chunk_err:.3g} of their largest '
                f'(tolerance d(xw) {CHUNK_GRAD_TOL[name]}, others '
                f'{max(CHUNK_GRAD_TOL[name], 1e-5)})')
            grouped_masked_equal(dtype, lengths)

            # Times, each beside the unmasked launch, the plain version and
            # cuDNN; the bounds from this run's valid steps
            gates, c_seq = plain_e[1], plain_e[2]
            times = {
                'E': time_ms(lambda: lk.lstm_scan_residuals(xw, wh), reps=5),
                'F': time_ms(lambda: lk.lstm_bptt(gates, c_seq, dout, w_h_t),
                             reps=5)}
            masked_e = lk.lstm_scan_residuals(xw, wh, False, lengths)
            carried_e = lk.lstm_scan_residuals(xw, wh, False, None, (c0, h0))
            runs = {
                ('E', 'masked'): lambda: lk.lstm_scan_residuals(
                    xw, wh, False, lengths),
                ('E', 'carried'): lambda: lk.lstm_scan_residuals(
                    xw, wh, False, None, (c0, h0), return_carry=True),
                ('F', 'masked'): lambda: lk.lstm_bptt(
                    masked_e[1], masked_e[2], dout, w_h_t, False, lengths),
                ('F', 'carried'): lambda: lk.lstm_bptt(
                    carried_e[1], carried_e[2], dout, w_h_t, False, None,
                    (c0, dc, dh))}
            plains = {
                ('E', 'masked'): lambda: lk.lstm_scan_residuals_plain(
                    xw, wh, False, lengths),
                ('E', 'carried'): lambda: lk.lstm_scan_residuals_plain(
                    xw, wh, False, None, (c0, h0), return_carry=True),
                ('F', 'masked'): lambda: lk.lstm_bptt_plain(
                    masked_e[1], masked_e[2], dout, w_h_t, False, lengths),
                ('F', 'carried'): lambda: lk.lstm_bptt_plain(
                    carried_e[1], carried_e[2], dout, w_h_t, False, None,
                    (c0, dc, dh))}
            library = {route: cudnn_masked_ms(
                x, w_x, w_h, dtype, n, carry)
                for route, (n, carry) in routes.items()}
            for (kernel, route), run in runs.items():
                ms = time_ms(run, reps=5)
                plain_ms = time_ms(plains[kernel, route], reps=1)
                n = lengths if route == 'masked' else None
                valid = steps if n is not None else None
                if kernel == 'E':
                    flops, num_bytes = lk.scan_cost(
                        TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, dtype,
                        residuals=True, carried=route == 'carried',
                        steps=valid)
                else:
                    flops, num_bytes = lk.bptt_cost(
                        TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, dtype,
                        carried=route == 'carried', steps=valid)
                bound, bound_by = bound_ms(num_bytes, flops, peak)
                library_ms = library[route][0 if kernel == 'E' else 1]
                err = worst[f'{route} {"out" if kernel == "E" else "da"}'][0]
                log(f'phase 44, {kernel} {route} {name}: kernel {ms:.3f} ms '
                    f'(unmasked {times[kernel]:.3f} ms, '
                    f'{100 * (ms / times[kernel] - 1):+.1f}%), plain '
                    f'{plain_ms:.3f} ms, cuDNN nn.LSTM '
                    f'{"forward" if kernel == "E" else "backward"} '
                    f'{library_ms:.3f} ms ({"packed" if route == "masked" else "from (h0, c0)"}, '
                    f'with its input projection), bound {bound:.4f} ms '
                    f'({bound_by}; {valid or TRAIN_BATCH * TRAIN_FRAMES} '
                    f'valid row-steps)')
                entries.setdefault(name, {})[kernel, route] = {
                    'ms': ms, 'unmasked_ms': times[kernel],
                    'plain_ms': plain_ms, 'bound_ms': bound,
                    'bound_by': bound_by, 'library_ms': library_ms,
                    'max_abs_err': err}
            for kernel, grouped_ms in grouped_masked_times(dtype,
                                                           lengths).items():
                entries[name][kernel, 'grouped_masked'] = grouped_ms
    log(f'phase 44 ({card}) passed')

    return entries


def check_carried_chunks(xw, w_h, dout, c0, h0, dtype):
    """The differentiable carried recurrence (carried E and F) over chunks
    that thread the carry, against one call from the same carry: outputs
    bit for bit, gradients within ``CHUNK_GRAD_TOL``. Returns the worst
    gradient error over its largest value."""

    import torch

    from amt_tools_tpu_torch.ops.lstm_kernel import lstm_scan_grad

    name = str(dtype).split('.')[-1]

    def grads(chunk):
        x = xw.detach().clone().requires_grad_()
        w = w_h.detach().clone().requires_grad_()
        first = (c0.clone().requires_grad_(), h0.clone().requires_grad_())
        state, pieces = first, []
        for start in range(0, TRAIN_FRAMES, chunk):
            out, state = lstm_scan_grad(x[:, start:start + chunk], w,
                                        initial_carry=state,
                                        return_carry=True)
            pieces.append(out)
        out = torch.cat(pieces, dim=1)
        (out.float() * dout.float()).sum().backward()
        return out.detach(), [x.grad, w.grad, first[0].grad, first[1].grad]

    whole, want = grads(TRAIN_FRAMES)
    chunked, got = grads(CARRY_CHUNK_FRAMES)
    require(torch.equal(whole, chunked),
            f'carried E {name} in chunks differs from one call')
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        err = lstm_errors(a, b)[2]
        worst = max(worst, err)
        tol = CHUNK_GRAD_TOL[name] if i == 0 else max(CHUNK_GRAD_TOL[name],
                                                      1e-5)
        require(err <= tol, f'carried F {name} in chunks: gradient {i} off '
                            f'by {err:.3g} of its largest')

    return worst


def grouped_masked_inputs(dtype):
    import torch

    g = torch.Generator().manual_seed(46)
    xw = torch.randn(4, TRAIN_BATCH, TRAIN_FRAMES, 4 * HIDDEN,
                     generator=g) * 0.5
    w_h = torch.stack([torch.nn.init.orthogonal_(
        torch.empty(HIDDEN, 4 * HIDDEN), generator=g) for _ in range(4)])
    dout = torch.randn(4, TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, generator=g)
    xw, w_h, dout = (t.cuda().to(dtype) for t in (xw, w_h, dout))

    return xw, w_h, dout, w_h.transpose(1, 2).contiguous()


def grouped_masked_equal(dtype, lengths):
    """Grouped masked E and F at G = 4 (the groups from 2 on reversed) bit
    for bit four per-stream masked launches, and counted as masked."""

    import torch

    from amt_tools_tpu_torch.ops import lstm_kernel as lk

    xw, w_h, dout, w_h_t = grouped_masked_inputs(dtype)
    wrappers = (lk.lstm_scan_residuals, lk.lstm_bptt)
    counts = [(w.masked_launches, w.grouped_launches) for w in wrappers]
    res = lk.lstm_scan_residuals_grouped(xw, w_h, 2, lengths)
    da = lk.lstm_bptt_grouped(res[1], res[2], dout, w_h_t, 2, lengths)
    torch.cuda.synchronize()
    require([(w.masked_launches, w.grouped_launches) for w in wrappers] ==
            [(masked + 1, grouped + 1) for masked, grouped in counts],
            'grouped masked E/F not counted')
    for g in range(4):
        alone = lk.lstm_scan_residuals(xw[g], w_h[g], g >= 2, lengths)
        require(all(torch.equal(a[g], b) for a, b in zip(res, alone)) and
                torch.equal(da[g], lk.lstm_bptt(alone[1], alone[2], dout[g],
                                                w_h_t[g], g >= 2, lengths)),
                f'grouped masked E or F differs from group {g} alone')
    log(f'phase 44, grouped masked E and F {str(dtype).split(".")[-1]} at '
        f'G = 4: bit for bit the four per-stream masked launches')


def grouped_masked_times(dtype, lengths):
    """Grouped masked E and F at G = 4, each timed beside four per-stream
    masked launches, its grouped plain version and four cuDNN calls on a
    packed batch; the bound over the valid steps of the four groups."""

    from amt_tools_tpu_torch.ops import lstm_kernel as lk

    xw, w_h, dout, w_h_t = grouped_masked_inputs(dtype)
    res = lk.lstm_scan_residuals_grouped(xw, w_h, 2, lengths)
    peak = PEAK_BF16_FLOPS if str(dtype).endswith('bfloat16') else \
        PEAK_FP32_FLOPS
    steps = int(lengths.sum())
    x, w_x, w_h0, _, _ = lstm_inputs(TRAIN_BATCH, TRAIN_FRAMES, dtype,
                                     seed=47)
    library = cudnn_masked_ms(x, w_x, w_h0, dtype, lengths, None)
    result = {}
    for kernel, run, each, plain, cost in (
            ('E', lambda: lk.lstm_scan_residuals_grouped(xw, w_h, 2, lengths),
             lambda: [lk.lstm_scan_residuals(xw[g], w_h[g], g >= 2, lengths)
                      for g in range(4)],
             lambda: lk.lstm_scan_residuals_grouped_plain(xw, w_h, 2,
                                                          lengths),
             lk.scan_cost(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, dtype,
                          residuals=True, steps=steps)),
            ('F', lambda: lk.lstm_bptt_grouped(res[1], res[2], dout, w_h_t, 2,
                                               lengths),
             lambda: [lk.lstm_bptt(res[1][g], res[2][g], dout[g], w_h_t[g],
                                   g >= 2, lengths) for g in range(4)],
             lambda: lk.lstm_bptt_grouped_plain(res[1], res[2], dout, w_h_t,
                                                2, lengths),
             lk.bptt_cost(TRAIN_BATCH, TRAIN_FRAMES, HIDDEN, dtype,
                          steps=steps))):
        bound, bound_by = bound_ms(4 * cost[1], 4 * cost[0], peak)
        result[kernel] = {
            'ms': time_ms(run, reps=5), 'per_stream_ms': time_ms(each, reps=3),
            'plain_ms': time_ms(plain, reps=1), 'bound_ms': bound,
            'bound_by': bound_by,
            'library_ms': 4 * library[0 if kernel == 'E' else 1]}
        log(f'phase 44, grouped masked {kernel} {str(dtype).split(".")[-1]} '
            f'at G = 4: {result[kernel]["ms"]:.3f} ms, four per-stream '
            f'launches {result[kernel]["per_stream_ms"]:.3f} ms, plain '
            f'{result[kernel]["plain_ms"]:.3f} ms, four cuDNN calls '
            f'{result[kernel]["library_ms"]:.3f} ms, bound {bound:.4f} ms '
            f'({bound_by})')

    return result


def padded_batches(card_dataset, count, seed):
    """``count`` training batches of SyntheticPiano tracks cut to a length
    in [313, 625] frames and zero-padded to 625, with
    ``tools.KEY_VALID_FRAMES``: the masked training input."""

    from amt_tools_tpu_torch import tools

    rng = np.random.RandomState(seed)
    names = list(card_dataset.tracks)
    batches = []
    for _ in range(count):
        parts = {tools.KEY_FEATS: [], tools.KEY_MULTIPITCH: [],
                 tools.KEY_VALID_FRAMES: []}
        for row in range(TRAIN_BATCH):
            track = card_dataset.get_track_data(names[rng.randint(len(
                names))])
            length = TRAIN_LENGTHS[row] if row < len(TRAIN_LENGTHS) else \
                TRAIN_FRAMES
            length = max(length, 313)
            for key in (tools.KEY_FEATS, tools.KEY_MULTIPITCH):
                value = np.zeros(track[key].shape[:-1] + (TRAIN_FRAMES,),
                                 dtype=np.float32)
                value[..., :length] = track[key][..., :length]
                parts[key].append(value)
            parts[tools.KEY_VALID_FRAMES].append(length)
        batches.append({k: np.stack(v) for k, v in parts.items()})

    return batches


def train_masked(card):
    """Phase 45: masked training at full width. O&F2 complexity 3, float32,
    Adam 6e-4 on SyntheticPiano tracks (HTK mels by kernel A) cut to
    313-625 frames and padded to 625 with valid frames: through
    ``make_train_step`` (lengths = T bit for bit the unmasked step, under
    cuDNN's deterministic algorithms) and ``train()`` (30 steps on one
    batch, masked E and F three times a step, B never, the loss falling),
    steps/s in turns with the unmasked batch; the first masked step
    (dropout off, SGD) against the CPU's plain versions under phase 12b's
    rule; the same with ``fused_lms``
    (grouped masked E and F twice a step); one bf16
    step. Returns the launches a step by layout and a profiler entry."""

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.datasets import SyntheticPiano
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames2
    from amt_tools_tpu_torch.train import make_train_step, step_generator

    tools.use_exact_fp32()
    dataset = SyntheticPiano(num_tracks=8, track_duration=20.0,
                             data_proc=MelSpec(n_mels=N_MELS, htk=True))
    batches = padded_batches(dataset, 2, seed=45)
    batch = batches[0]
    full = dict(batch, **{tools.KEY_VALID_FRAMES: np.full(
        TRAIN_BATCH, TRAIN_FRAMES)})
    unmasked = {k: v for k, v in full.items()
                if k != tools.KEY_VALID_FRAMES}

    def model(dtype=None, seed=0, **kw):
        return OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                             model_complexity=3, dtype=dtype,
                             generator=torch.Generator().manual_seed(seed),
                             **kw)

    def place(data):
        return {k: torch.from_numpy(np.asarray(v)).cuda()
                for k, v in data.items()}

    # Lengths = T: the unmasked step bit for bit (losses, parameters and
    # statistics after one Adam step), dropout from one generator
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = []
        for data in (full, unmasked):
            local = model(seed=3).cuda()
            step = make_train_step(local, torch.optim.Adam(
                local.parameters(), lr=LEARNING_RATE))
            loss = step(place(data), step_generator(0, 0, 'cuda'))
            states.append(({k: v.item() for k, v in loss.items()},
                           local.state_dict()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    require(states[0][0] == states[1][0] and all(
        torch.equal(states[0][1][k], states[1][1][k]) for k in states[0][1]),
        'the masked step with lengths = T differs from the unmasked step')
    log('phase 45: a masked step with lengths = T is the unmasked step bit '
        'for bit (losses, parameters and statistics after one Adam step)')

    launches = {}
    for kw, label, counts in (
            ({}, 'per-head', {'lstm_scan_residuals_grouped': 3,
                              'lstm_bptt_grouped': 3,
                              'lstm_scan_residuals_masked': 3,
                              'lstm_bptt_masked': 3}),
            ({'fused_lms': True}, 'fused_lms',
             {'lstm_scan_residuals_grouped': 2, 'lstm_bptt_grouped': 2,
              'lstm_scan_residuals_masked': 2, 'lstm_bptt_masked': 2})):
        result, got, _ = train_run(
            model(seed=4, **kw), FixedLoader([batch]), FIT_STEPS,
            f'phase 45, {FIT_STEPS} masked float32 steps of O&F2 complexity '
            f'3 ({label}) on one batch, lengths '
            f'{batch[tools.KEY_VALID_FRAMES].tolist()}',
            recurrences=counts['lstm_scan_residuals_masked'])
        for key, per_step in counts.items():
            require(got[key] == per_step * FIT_STEPS,
                    f'phase 45 {label}: {key} ran {got[key]} times in '
                    f'{FIT_STEPS} steps')
        losses = result['losses'][tools.KEY_LOSS_TOTAL]
        log(f'phase 45 {label}: total loss {losses[0]:.6g} -> '
            f'{losses[-1]:.6g}')
        require(losses[-1] < losses[0], f'phase 45 {label}: the masked loss '
                                        f'did not fall')
        launches[label] = {k: got[k] / FIT_STEPS for k in counts}

        # Steps/s in turns: masked, unmasked, unmasked, masked
        rates = {'masked': [], 'unmasked': []}
        for kind in ('masked', 'unmasked', 'unmasked', 'masked'):
            data = batch if kind == 'masked' else unmasked
            _, _, rate = train_run(
                model(seed=5, **kw), FixedLoader([data] * 2), 3,
                f'phase 45 {label} {kind} turn',
                recurrences=counts['lstm_scan_residuals_masked'])
            rates[kind].append(rate)
        log(f'phase 45 {label}: steps/s in turns, masked {rates["masked"]}, '
            f'unmasked {rates["unmasked"]}')
        launches[label]['steps_per_s'] = rates

    # The first masked step (dropout off, SGD), card against the CPU's
    # plain versions under phase 12b's rule
    compare_step(f'the first masked step of O&F2 complexity 3, lengths '
                 f'{batch[tools.KEY_VALID_FRAMES].tolist()}',
                 *step_both(model(seed=4, dropout=False), batch))

    bf16 = model(torch.bfloat16, seed=6).cuda()
    step = make_train_step(bf16, torch.optim.Adam(bf16.parameters(),
                                                  lr=LEARNING_RATE))
    loss = step(place(batch), step_generator(0, 0, 'cuda'))
    require(all(np.isfinite(v.item()) for v in loss.values()),
            'phase 45: the masked bf16 step gave a loss that is not finite')
    log(f'phase 45: one masked bf16 step, total loss '
        f'{loss[tools.KEY_LOSS_TOTAL].item():.6g}')

    profiled = model(seed=7).cuda()
    step = make_train_step(profiled, torch.optim.Adam(profiled.parameters(),
                                                      lr=LEARNING_RATE))
    device_batch = place(batch)
    step(device_batch, step_generator(0, 0, 'cuda'))
    log(f'phase 45 ({card}) passed')

    return launches, (
        f'masked float32 training step of {TRAIN_BATCH} x {TRAIN_FRAMES} '
        f'frames (lengths {batch[tools.KEY_VALID_FRAMES].tolist()})',
        lambda: step(device_batch, step_generator(0, 1, 'cuda')),
        ('lstm_scan_kernel', 'lstm_bptt_kernel'))


def train_carried(card):
    """Phase 46: carried training. ``OnsetsFramesOnline`` complexity 3 on
    8 x 625 frames in 5 chunks that thread the carries, the gradient
    through the chain: carried E and F twice a chunk; its language model
    over the chunks against one whole-sequence call (outputs bit for bit,
    gradients within ``CHUNK_LM_GRAD_TOL`` of the whole call's largest) and
    against the CPU's plain versions (phase 11's float32 tolerance); ms a
    step. Returns the carried launches a chunk."""

    import copy

    import torch

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFramesOnline

    tools.use_exact_fp32()
    model = OnsetsFramesOnline(dim_in=N_MELS, profile=tools.PianoProfile(),
                               model_complexity=3,
                               generator=torch.Generator().manual_seed(8))
    g = torch.Generator().manual_seed(9)
    feats = torch.rand(TRAIN_BATCH, 1, N_MELS, TRAIN_FRAMES, generator=g)
    model = model.cuda().train()
    feats = model.pre_proc({tools.KEY_FEATS: feats.cuda()})[tools.KEY_FEATS]
    chunk = TRAIN_FRAMES // ONLINE_CHUNKS
    optimizer = torch.optim.Adam(model.parameters(), lr=LEARNING_RATE)

    def step():
        optimizer.zero_grad(set_to_none=True)
        state, total = model.init_carries(TRAIN_BATCH, 'cuda'), 0.0
        for start in range(0, TRAIN_FRAMES, chunk):
            out, state = model(feats[:, start:start + chunk],
                               torch.Generator('cuda').manual_seed(start),
                               carries=state)
            total = total + out[tools.KEY_MULTIPITCH].square().mean()
        total.backward()
        optimizer.step()
        return total

    torch.cuda.synchronize()
    reset_launches()
    loss = step()
    torch.cuda.synchronize()
    launches = read_launches()
    require(np.isfinite(loss.item()), 'phase 46: the loss is not finite')
    for key in ('lstm_scan_residuals_carried', 'lstm_bptt_carried'):
        require(launches[key] == 2 * ONLINE_CHUNKS,
                f'phase 46: {key} ran {launches[key]} times in '
                f'{ONLINE_CHUNKS} chunks')
    require(launches['lstm_scan'] == 0, 'phase 46: kernel B ran in training')
    ms = time_ms(step, reps=3)
    log(f'phase 46: OnsetsFramesOnline complexity 3, {TRAIN_BATCH} x '
        f'{TRAIN_FRAMES} frames in {ONLINE_CHUNKS} chunks threading the '
        f'carries: carried E and F twice a chunk, {ms:.3f} ms a step (Adam)')

    # The language model alone: chunks against one call, card against CPU
    lm = model.onset_lm
    x = torch.randn(TRAIN_BATCH, TRAIN_FRAMES, lm.FastLSTM_0.input_proj
                    .in_features, generator=g).cuda()
    dout = torch.randn(TRAIN_BATCH, TRAIN_FRAMES, lm.dim_out,
                       generator=g).cuda()

    def lm_grads(module, device, size):
        module.zero_grad()
        carry = tuple(v.requires_grad_() for v in module.init_carry(
            TRAIN_BATCH, device))
        state, pieces = carry, []
        xd = x.detach().to(device).requires_grad_()
        for start in range(0, TRAIN_FRAMES, size):
            out, state = module(xd[:, start:start + size], state)
            pieces.append(out)
        out = torch.cat(pieces, dim=1)
        (out * dout.to(device)).sum().backward()
        grads = [p.grad for p in module.parameters()] + [
            xd.grad, carry[0].grad, carry[1].grad]
        return out.detach(), [t.detach().cpu() for t in grads]

    whole, want = lm_grads(lm, 'cuda', TRAIN_FRAMES)
    chunked, got = lm_grads(lm, 'cuda', chunk)
    require(torch.equal(whole, chunked),
            'phase 46: the language model over chunks differs from one call')
    chunk_err = max(lstm_errors(a, b)[2] for a, b in zip(got, want))
    require(chunk_err <= CHUNK_LM_GRAD_TOL,
            f'phase 46: chunked gradients off by {chunk_err:.3g}')
    cpu_out, cpu = lm_grads(copy.deepcopy(lm).cpu(), 'cpu', chunk)
    out_err = (cpu_out - chunked.cpu()).abs().max().item()
    cpu_err = max(lstm_errors(a, b)[2] for a, b in zip(got, cpu))
    log(f'phase 46: the onset language model in {ONLINE_CHUNKS} chunks: '
        f'outputs bit for bit one call, gradients within {chunk_err:.3g} of '
        f'its largest (tolerance {CHUNK_LM_GRAD_TOL}); card against the '
        f'CPU\'s plain versions: outputs within {out_err:.3g} (tolerance '
        f'{LSTM_TOL["float32"]}), gradients {cpu_err:.3g} of the largest '
        f'(tolerance {BPTT_TOL["float32"]})')
    require(out_err <= LSTM_TOL['float32'] and
            cpu_err <= BPTT_TOL['float32'],
            'phase 46: the carried step differs card vs CPU')
    log(f'phase 46 ({card}) passed')

    return {'carried_per_chunk': launches['lstm_scan_residuals_carried'] /
            ONLINE_CHUNKS, 'ms_per_step': ms}


def convergence_on_card(card):
    """Phase 47: the port's side of the convergence differential
    (tests/test_torch_convergence.py) on the card: O&F complexity 2 on 48
    mel bins over ``PianoProfile(52, 64)``, 8 SyntheticPiano tracks of 8 s
    (6 to train, 2 held out), batch 4, crops of 96 frames from
    ``RandomState(7)``, Adam 2e-3, dropout off, 500 steps from the port's
    seeded initialization (generator seed 0: the weights the JAX run of
    the slow test starts from, converted to its layout), then ``validate``
    bucketed by 128 frames (masked B). Its frame and note F1 within
    ``CONVERGENCE_TOL`` of ``CONVERGENCE_JAX_F1``. Under cuDNN's
    deterministic algorithms, so that a rerun on the card gives the same
    figures (E and F are deterministic)."""

    import torch

    from amt_tools_tpu_torch import evaluate, tools, transcribe
    from amt_tools_tpu_torch.datasets import SyntheticPiano
    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.models import OnsetsFrames
    from amt_tools_tpu_torch.train import make_train_step

    start = time.perf_counter()
    profile = tools.PianoProfile(52, 64)
    corpus = SyntheticPiano(base_dir='.', data_proc=MelSpec(n_mels=48),
                            profile=profile, num_frames=None, num_tracks=8,
                            track_duration=8.0, notes_per_track=24,
                            save_data=False, seed=0)
    tracks = {t: corpus.get_track_data(t) for t in corpus.tracks}
    names = corpus.tracks
    model = OnsetsFrames(dim_in=48, profile=profile, model_complexity=2,
                         dropout=False,
                         generator=torch.Generator().manual_seed(0)).cuda()
    step = make_train_step(model, torch.optim.Adam(model.parameters(),
                                                   lr=2e-3))
    stream = np.random.RandomState(7)
    reset_launches()
    losses = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for _ in range(CONVERGENCE_STEPS):
        parts = {tools.KEY_FEATS: [], tools.KEY_MULTIPITCH: [],
                 tools.KEY_ONSETS: []}
        for _ in range(4):
            track = tracks[names[:6][stream.randint(6)]]
            at = stream.randint(0, track[tools.KEY_FEATS].shape[-1] - 96)
            parts[tools.KEY_FEATS].append(
                track[tools.KEY_FEATS][..., at:at + 96])
            for key in (tools.KEY_MULTIPITCH, tools.KEY_ONSETS):
                parts[key].append(track[key][:, at:at + 96])
        loss = step({k: torch.from_numpy(np.stack(v).astype(np.float32))
                     .cuda() for k, v in parts.items()})
        losses.append(loss[tools.KEY_LOSS_TOTAL].item())
    torch.backends.cudnn.deterministic = deterministic
    train_s = time.perf_counter() - start
    trained = read_launches()

    class Holdout:
        def __init__(self, held):
            self.tracks = held

        def get_track_data(self, track_id):
            return dict(tracks[track_id])

    reset_launches()
    results = evaluate.validate(
        model, Holdout(list(names[6:])), evaluate.ComboEvaluator(
            [evaluate.MultipitchEvaluator(), evaluate.NoteEvaluator()]),
        transcribe.ComboEstimator([transcribe.NoteTranscriber(
            profile=profile)]), bucket=128)
    validated = read_launches()
    f1 = {'frame': float(results[tools.KEY_MULTIPITCH][tools.KEY_F1]),
          'note': float(results[tools.KEY_NOTES][tools.KEY_F1])}
    log(f'phase 47: {CONVERGENCE_STEPS} Adam steps on the card in '
        f'{train_s:.1f} s (E {trained["lstm_scan_residuals"]} and F '
        f'{trained["lstm_bptt"]} launches), loss {losses[0]:.4f} -> '
        f'{losses[-1]:.4f}; held-out frame F1 {f1["frame"]:.4f}, note F1 '
        f'{f1["note"]:.4f} (masked B {validated["lstm_scan_masked"]} '
        f'launches); the JAX package: {CONVERGENCE_JAX_F1} ({card})')
    require(losses[-1] < 0.5 * losses[0], 'phase 47: the model did not learn')
    require(validated['lstm_scan_masked'] > 0,
            'phase 47: validate did not run masked B')
    for key, tol in CONVERGENCE_TOL.items():
        require(abs(f1[key] - CONVERGENCE_JAX_F1[key]) < tol,
                f'phase 47: {key} F1 {f1[key]:.4f} is not within {tol} of '
                f'the JAX package\'s {CONVERGENCE_JAX_F1[key]:.4f}')

    return {'f1': f1, 'jax_f1': CONVERGENCE_JAX_F1, 'train_s': train_s,
            'losses': (losses[0], losses[-1])}


def add_masked_entries(residuals, bptt, entries, masked, carried):
    """Kernels E's and F's masked, carried and grouped masked launches in
    the ``kernels`` line: phase 44's times (float32, the recipe's; bf16
    beside them) and the launches a step of phase 45 (a chunk of phase
    46, carried)."""

    for entry, key in ((residuals, 'E'), (bptt, 'F')):
        name = entry['name']
        times = entries['float32']
        entry['masked'] = dict(times[key, 'masked'], launches_per_step=(
            masked['per-head'][f'{name}_masked']))
        entry['carried'] = dict(times[key, 'carried'], launches_per_chunk=(
            carried['carried_per_chunk']))
        # Every launch of a masked step is masked, so the grouped ones are
        # the grouped masked ones
        entry['grouped_masked'] = dict(
            times[key, 'grouped_masked'], launches_fused_lms_per_step=(
                masked['fused_lms'][f'{name}_grouped']))
        entry['bfloat16_masked_carried'] = {
            route: entries['bfloat16'][key, route]
            for route in ('masked', 'carried', 'grouped_masked')}


def masked_carried_phases(card):
    """Phases 44-47, timed together."""

    import torch

    start = time.perf_counter()
    entries = check_masked_carried_lstm(card)
    torch.cuda.empty_cache()
    masked, masked_step = train_masked(card)
    torch.cuda.empty_cache()
    carried = train_carried(card)
    torch.cuda.empty_cache()
    convergence = convergence_on_card(card)
    torch.cuda.empty_cache()
    log(json.dumps({'masked_training': masked, 'carried_training': carried,
                    'convergence': convergence,
                    'phases_44_47_s': time.perf_counter() - start}))

    return entries, masked, carried, masked_step


def main(argv=()):
    import tempfile

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

    if list(argv) == ['layout']:
        epilogue = check_conv_epilogue()
        torch.cuda.empty_cache()
        layout = check_stack_layout(card)
        log(card)
        print(json.dumps({'kernels': [epilogue]}), flush=True)
        print(json.dumps({'stack_layout': layout}), flush=True)
        return

    if list(argv) == ['hft']:
        add_norm = check_add_layer_norm()
        log(card)
        print(json.dumps({'kernels': [add_norm]}), flush=True)
        return

    if list(argv) in (['gru'], ['hpt']):
        with tools.exact_fp32():
            gru = check_gru_scan()
            hpt = check_hpt_forward() if argv[0] == 'hpt' else None
        log(card)
        print(json.dumps({'kernels': [dict(gru, op='torch.ops.'
                                           'amt_tools_tpu_torch.'
                                           'gru_scan_grouped')]}), flush=True)
        if hpt is not None:
            print(json.dumps({'hpt_forward': hpt}), flush=True)
        return

    # The batches the spawned ranks of phase 33 read (git-ignored; removed
    # at the end, or at exit)
    parallel_tmp = tempfile.TemporaryDirectory(prefix='_chip_smoke_parallel_',
                                               dir=ROOT)
    parallel_dir = parallel_tmp.name

    profile = tools.PianoProfile()
    start = time.perf_counter()
    clips = render_clips(profile, BATCH, CLIP_SECONDS)
    np.save(os.path.join(parallel_dir, 'piano.npy'), clips)
    log(f'rendered {BATCH} x {CLIP_SECONDS:.0f} s clips in '
        f'{time.perf_counter() - start:.1f} s')

    audio = torch.from_numpy(clips).cuda()
    stft = check_stft(audio)
    frames = 1 + clips.shape[-1] // HOP
    del audio
    lstm = check_lstm(frames)
    masked = check_masked_lstm(card)
    torch.cuda.empty_cache()

    launches, piano_batch, piano_reference, piano_live = serve(clips, profile,
                                                               card)
    check_against_cpu(clips, profile)
    torch.cuda.empty_cache()
    epilogue = check_conv_epilogue()
    epilogue['launches'] = launches['conv_epilogue']
    torch.cuda.empty_cache()
    layout = check_stack_layout(card)
    int8_launches, int8_batch = serve_int8(clips, profile, card)
    torch.cuda.empty_cache()
    int8_against_cpu(clips, profile)
    del clips
    torch.cuda.empty_cache()
    time_int8_layers(card)
    torch.cuda.empty_cache()

    stft['launches'] = launches['stft_power']
    lstm['launches'] = launches['lstm_scan']
    stft['launches_int8_static'] = int8_launches['stft_power']
    lstm['launches_int8_static'] = int8_launches['lstm_scan']

    start = time.perf_counter()
    guitar = render_clips(tools.GuitarProfile(num_frets=19), GUITAR_BATCH,
                          CLIP_SECONDS, GUITAR_SAMPLE_RATE)
    np.save(os.path.join(parallel_dir, 'guitar.npy'), guitar)
    log(f'rendered {GUITAR_BATCH} x {CLIP_SECONDS:.0f} s guitar clips at '
        f'{GUITAR_SAMPLE_RATE} Hz in {time.perf_counter() - start:.1f} s')

    cqt_full = check_cqt(guitar)
    torch.cuda.empty_cache()
    cqt_grouped = check_cqt_grouped(guitar)
    torch.cuda.empty_cache()

    launches, guitar_batch, guitar_reference = serve_guitar(guitar, card)
    check_guitar_against_cpu(guitar)
    torch.cuda.empty_cache()
    int8_guitar = serve_guitar_int8(guitar, card)
    del guitar
    torch.cuda.empty_cache()

    cqt_full['launches'] = launches['cqt_mag']
    cqt_grouped['launches'] = launches['cqt_mag_grouped']
    cqt_grouped['launches_int8_static'] = int8_guitar['cqt_mag_grouped']

    residuals = check_lstm_residuals()
    bptt = check_lstm_bptt()
    torch.cuda.empty_cache()
    launches, steps, train_batch = train_piano(card)
    train_against_cpu()
    for entry in (residuals, bptt):
        entry['launches'] = launches[entry['name']]
        entry['launches_per_step'] = launches[entry['name']] / steps
    torch.cuda.empty_cache()

    lstm['launches_masked'], lstm['launches_masked_batch_1'] = \
        validate_piano(card)
    lstm['masked'] = masked
    torch.cuda.empty_cache()
    cqt_grouped['launches_validation'] = validate_guitar(card)
    torch.cuda.empty_cache()
    train_with_validation(card)
    torch.cuda.empty_cache()

    velocity_launches, velocity_rate, velocity_batch, velocity_step = \
        train_velocity(card)
    for entry in (residuals, bptt):
        entry['launches_velocity_per_step'] = velocity_launches[entry['name']]
    torch.cuda.empty_cache()
    remat = remat_turns(velocity_batch, card)
    torch.cuda.empty_cache()
    cqt_full['launches_recipe_training'], tab_rates, tab_step = \
        train_tabcnn(card)
    torch.cuda.empty_cache()
    lstm['carried'] = check_carried_lstm(card)
    lstm['launches_carried'], streaming, stream_frames, online_step = \
        stream_online(card, velocity_batch)
    torch.cuda.empty_cache()
    log(json.dumps({'velocity_steps_per_s': velocity_rate, 'remat': remat,
                    'tabcnn_steps_per_s': {
                        'with_validation': tab_rates[True],
                        'without_validation': tab_rates[False]},
                    'streaming': streaming}))

    fused, fused_entries = fused_phases(*piano_live, velocity_batch, card)
    torch.cuda.empty_cache()
    log(json.dumps({'fused_serving_audio_s_per_wall_s':
                    fused['serving']['rates'],
                    'fused_serving_peak_gb': fused['serving']['peak_gb'],
                    'fused_training_steps_per_s': fused['training']['rates'],
                    'fused_training_e_f_ms': fused['training']['e_f_ms'],
                    'fused_velocity_steps_per_s': fused['velocity']['rates']}))

    (masked_entries, masked_training, carried_training,
     masked_step) = masked_carried_phases(card)

    with tempfile.TemporaryDirectory(prefix='_chip_smoke_corpora_',
                                     dir=ROOT) as root:
        start = time.perf_counter()
        corpora = write_corpora(root)
        log(f'wrote the MAESTRO ({MAESTRO_TRAIN_TRACKS} x '
            f'{MAESTRO_TRAIN_SECONDS:.0f} s + 2 x {MAESTRO_EVAL_TRACKS} x '
            f'{MAESTRO_EVAL_SECONDS:.0f} s), MAPS ({len(MAPS_SPLITS)} x '
            f'{MAPS_TRACKS} x {MAPS_SECONDS:.0f} s) and GuitarSet '
            f'({GSET_PLAYERS} x {GSET_TRACKS} x {GSET_SECONDS:.0f} s) corpora '
            f'in {time.perf_counter() - start:.1f} s')
        corpus_model, of2_passes, of2_rates, of2_step = of2_on_maestro(
            card, corpora)
        torch.cuda.empty_cache()
        masked_corpus = validate_corpora(card, corpora, corpus_model)
        del corpus_model
        torch.cuda.empty_cache()
        gset_launches, gset_rates, gset_step = tabcnn_on_guitarset(card,
                                                                   corpora)
        torch.cuda.empty_cache()
        file_features, file_carried, file_stream = stream_from_file(card,
                                                                    corpora)
        hcqt_launches = check_hcqt(card)
        torch.cuda.empty_cache()
        log(json.dumps({'of_2_maestro': of2_rates,
                        'corpus_validation_masked_launches': masked_corpus,
                        'tabcnn_guitarset': gset_rates,
                        'audio_file_stream': file_stream}))

        profile_batches([piano_batch, int8_batch, guitar_batch, train_batch,
                         velocity_step, online_step, tab_step, stream_frames,
                         of2_step, gset_step, *fused_entries, masked_step],
                        os.path.join(root, 'trace'))
        del fused_entries
    ops, artifact, streaming, measured = deployment_phases(
        *piano_live, train_batch, card)
    # The profiled batches hold their pipelines and requests on the card
    del (piano_batch, int8_batch, guitar_batch, train_batch, velocity_step,
         online_step, tab_step, stream_frames, of2_step, gset_step,
         piano_live, masked_step)
    torch.cuda.empty_cache()

    parallel = parallel_phases(card, parallel_dir, piano_reference,
                               guitar_reference)
    parallel_tmp.cleanup()

    cold, warm = of2_passes['cold']['launches'], of2_passes['warm']['launches']
    stft['launches_maestro_cold'] = cold['stft_power']
    stft['launches_maestro_warm'] = warm['stft_power']
    stft['launches_audio_file_stream'] = file_features
    lstm['launches_masked_corpus_validation'] = sum(masked_corpus.values())
    lstm['launches_carried_file_stream'] = file_carried
    cqt_full['launches_guitarset_cold'] = gset_launches['cold']['cqt_mag']
    cqt_full['launches_guitarset_warm'] = gset_launches['warm']['cqt_mag']
    cqt_full['launches_hcqt'] = hcqt_launches
    steps = MAESTRO_TRAIN_TRACKS // TRAIN_BATCH
    for entry in (residuals, bptt):
        entry['launches_maestro_per_step'] = cold[entry['name']] / steps
        entry['launches_dp_world_one_per_step'] = parallel[
            'e_f_per_step_world_one']
        entry['launches_two_rank_per_step_per_rank'] = parallel[
            'e_f_per_step_two_ranks']
    stft['launches_two_rank_serving_per_rank'] = parallel['a_per_rank']
    lstm['launches_two_rank_serving_per_rank'] = parallel['b_per_rank']
    cqt_grouped['launches_two_rank_serving_per_rank'] = parallel['d_per_rank']

    examples = measured['examples']
    for entry in (stft, lstm, cqt_full, cqt_grouped, residuals, bptt,
                  epilogue):
        entry['op'] = f'torch.ops.amt_tools_tpu_torch.{entry["name"]}'
        entry['launches_op_check'] = ops['op_check_launches'][entry['name']]
    stft['launches_serving_artifact'] = artifact['launches']['stft_power']
    lstm['launches_serving_artifact'] = artifact['launches']['lstm_scan']
    lstm['launches_carried_streaming_artifact'] = streaming[
        'carried_launches']
    stft['launches_transcribe_file'] = examples['transcribe_file'][
        'stft_power']
    cqt_full['launches_synthetic_tabcnn'] = examples['synthetic_tabcnn'][
        'cqt_mag']
    for entry in (residuals, bptt):
        entry['launches_synthetic_demo'] = examples['synthetic_demo'][
            entry['name']]

    # The fused layouts (phases 39-43): the grouped launches of B, E and F,
    # their times (one launch for G = 4 sequences) and counts
    grouped = fused['grouped']
    lstm['grouped'] = {'float32': grouped['float32']['B'],
                       'bfloat16': grouped['bfloat16']['B'],
                       'bfloat16_serving': grouped['bfloat16']['B serving']}
    lstm['launches_grouped_fused_serving'] = fused['serving']['launches'][
        'lstm_scan_grouped']
    lstm['launches_fused_serving'] = fused['serving']['launches']['lstm_scan']
    lstm['launches_grouped_fused_artifact'] = fused['artifact']['launches'][
        'lstm_scan_grouped']
    for entry, key in ((residuals, 'E'), (bptt, 'F')):
        name = entry['name']
        entry['grouped'] = grouped['float32'][key]
        for run, counts in (('fused', fused['training']['launches']['fused']),
                            ('fused_velocity',
                             fused['velocity']['launches']['fused'])):
            entry[f'launches_grouped_{run}_per_step'] = (
                counts[f'{name}_grouped'] / FUSED_TRAIN_STEPS)
            entry[f'launches_{run}_per_step'] = (counts[name] /
                                                  FUSED_TRAIN_STEPS)

    add_masked_entries(residuals, bptt, masked_entries, masked_training,
                       carried_training)

    torch.cuda.empty_cache()
    with tools.exact_fp32():
        gru = check_gru_scan()
        torch.cuda.empty_cache()
        hpt = check_hpt_forward()
    gru['op'] = 'torch.ops.amt_tools_tpu_torch.gru_scan_grouped'
    torch.cuda.empty_cache()
    add_norm = check_add_layer_norm()

    log(card)
    print(json.dumps({'hpt_forward': hpt}), flush=True)
    print(json.dumps({'stack_layout': layout}), flush=True)
    print(json.dumps({'kernels': [stft, lstm, cqt_full, cqt_grouped,
                                  residuals, bptt, epilogue, gru,
                                  add_norm]}),
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
