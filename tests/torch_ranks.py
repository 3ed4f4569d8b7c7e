"""Rank workers for the port's parallel tests: gloo process groups on the CPU.

:func:`spawn` (or :class:`Ranks`, to work while they run) starts
``world`` processes in ``spawn`` mode (the test
process has JAX initialized, which forking would copy), joins them through
a ``FileStore`` in the given directory, runs one task of this module on
every rank and returns the per-rank results; it raises if a rank raises or
the ranks outlast the timeout. This module imports neither JAX nor the JAX
package: the children import it afresh.

Each task is ``task(rank, inputs) -> result`` with the process group
initialized; ``inputs`` is what the test passed (``torch.save``d into the
directory), ``result`` is ``torch.save``d back.
"""

import os
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Ranks:
    """``world`` spawned ranks running the task named ``task``; the caller
    may work meanwhile and then collect :meth:`results`."""

    def __init__(self, task, world, directory, inputs=None):
        self.task, self.world, self.directory = task, world, str(directory)
        torch.save(inputs, os.path.join(self.directory, 'inputs.pt'))
        self.context = mp.start_processes(
            _main, args=(world, self.directory, task), nprocs=world,
            join=False, start_method='spawn')
        self.start = time.monotonic()

    def results(self, timeout=120.0):
        """Join every rank (raising if one raised, or after ``timeout``
        seconds from the start, killing them); the per-rank results."""

        deadline = self.start + timeout
        context = self.context
        while not context.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for process in context.processes:
                    process.kill()
                for process in context.processes:
                    process.join(10)
                raise TimeoutError(f'{self.task} on {self.world} ranks '
                                   f'outlasted {timeout} s')

        return [torch.load(os.path.join(self.directory, f'rank{rank}.pt'),
                           weights_only=False) for rank in range(self.world)]


def spawn(task, world, directory, inputs=None, timeout=120.0):
    """Run the task named ``task`` on ``world`` ranks; their results."""

    return Ranks(task, world, directory, inputs).results(timeout)


def _main(rank, world, directory, task):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(directory, 'store'), world)
    dist.init_process_group('gloo', store=store, rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(directory, 'inputs.pt'),
                            weights_only=False)
        result = globals()[task](rank, inputs)
        torch.save(result, os.path.join(directory, f'rank{rank}.pt'))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _numpy(tree):
    if isinstance(tree, dict):
        return {key: _numpy(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(value) for value in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()

    return tree


def _raises(fn):
    """The message of the exception ``fn()`` raises, with its type."""

    try:
        fn()
    except (TypeError, ValueError, RuntimeError) as error:
        return f'{type(error).__name__}: {error}'

    return None


##################################################
# MESH, COLLECTIVES, KERNEL WRAPPERS             #
##################################################


def mesh_checks(rank, inputs):
    from torch.distributed.tensor import DTensor, Replicate

    from amt_tools_tpu_torch.ops import cqt_kernel, lstm_kernel, stft_kernel
    from amt_tools_tpu_torch.ops.lstm import FastBiLSTM
    from amt_tools_tpu_torch.parallel import (collectives, data_parallel_shardings,
                                              get_mesh, local_batch_to_global,
                                              pad_shard_batch, replicate,
                                              shard_batch)

    out = {}
    mesh = get_mesh(device='cpu')
    group = mesh.get_group('data')

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        local = shard_batch(inputs['batch30'], mesh)
    out['warned30'] = [str(w.message) for w in caught]
    out['rows30'] = {k: v.shape[0] for k, v in local.items()}

    with warnings.catch_warnings():
        warnings.simplefilter('error')
        out['local32'] = _numpy(shard_batch(inputs['batch32'], mesh))

    padded, valid = pad_shard_batch(inputs['batch30'], mesh)
    out['padded'], out['valid'] = _numpy(padded), _numpy(valid)
    feats = padded['feats']
    per_example = feats.reshape(feats.shape[0], -1).sum(dim=1)
    totals = torch.stack([(per_example * valid).sum(), valid.sum().float()])
    dist.all_reduce(totals)
    out['masked_mean'] = float(totals[0] / totals[1])

    rows = inputs['global'].shape[0] // 4
    own = inputs['global'][rank * rows:(rank + 1) * rows]
    out['local_global'] = _numpy(local_batch_to_global({'x': own}, mesh))
    ragged = inputs['global'][:rows + (rank == 0)]
    out['ragged'] = _raises(lambda: local_batch_to_global({'x': ragged},
                                                          mesh))

    grid = get_mesh(axis_names=('data', 'model'), shape=(2, 2), device='cpu')
    out['grid'] = (tuple(grid.mesh_dim_names), tuple(grid.shape),
                   grid.get_local_rank('data'), grid.get_local_rank('model'))
    out['grid_shardings'] = [tuple(type(p).__name__ for p in placements)
                             for placements in data_parallel_shardings(grid)]
    out['no_shape'] = _raises(lambda: get_mesh(axis_names=('data', 'model'),
                                               device='cpu'))

    # replicate: rank 0's values everywhere, over both dimensions
    tree = {'a': torch.full((3,), float(rank)),
            'b': [torch.arange(4, dtype=torch.int64) * (rank + 1)]}
    out['replicated'] = _numpy(replicate(tree, grid))
    module = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(module.weight, float(rank))
    replicate(module, grid)
    out['replicated_module'] = _numpy(module.weight)

    # Differentiable collectives: the sum, and the gradient summed
    weight = float(rank + 1)
    x = torch.full((3,), float(rank), requires_grad=True)
    y = collectives.all_reduce(x, group)
    (y * weight).sum().backward()
    out['all_reduce'] = (_numpy(y), _numpy(x.grad))
    x = torch.full((2,), float(rank), requires_grad=True)
    y = collectives.reduce_grad(x, group)
    (y * weight).sum().backward()
    out['reduce_grad'] = (_numpy(y), _numpy(x.grad))
    x = torch.full((2, 2), float(rank), requires_grad=True)
    y = collectives.gather_columns(x, group)
    (y * torch.arange(8.0)).sum().backward()
    out['gather_columns'] = (_numpy(y), _numpy(x.grad))
    params = [torch.nn.Parameter(torch.zeros(2)),
              torch.nn.Parameter(torch.zeros(3, dtype=torch.float64)),
              torch.nn.Parameter(torch.zeros(1))]
    params[0].grad = torch.full((2,), float(rank))
    params[1].grad = torch.full((3,), 2.0 * rank, dtype=torch.float64)
    collectives.average_gradients(params, group)
    out['average_gradients'] = [_numpy(p.grad) if p.grad is not None
                                else None for p in params]

    # The kernels' wrappers refuse DTensors, on the CPU route too
    def dtensor(t):
        return DTensor.from_local(t, mesh, [Replicate()])

    rng = np.random.RandomState(0)
    xw = torch.from_numpy(rng.randn(2, 5, 64).astype(np.float32))
    w_h = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
    gates = torch.rand(2, 5, 64)
    c_seq = torch.rand(2, 5, 16)
    dout = torch.rand(2, 5, 16)
    out['lstm_refusals'] = [
        _raises(lambda: lstm_kernel.lstm_scan(dtensor(xw), w_h)),
        _raises(lambda: lstm_kernel.lstm_scan(xw, dtensor(w_h))),
        _raises(lambda: lstm_kernel.lstm_scan(
            xw, w_h, lengths=dtensor(torch.tensor([5, 3])))),
        _raises(lambda: lstm_kernel.lstm_scan(
            xw, w_h, initial_carry=(dtensor(torch.zeros(2, 16)),
                                    torch.zeros(2, 16)))),
        _raises(lambda: lstm_kernel.lstm_scan_residuals(dtensor(xw), w_h)),
        _raises(lambda: lstm_kernel.lstm_bptt(gates, c_seq, dout,
                                              dtensor(w_h.t().contiguous()))),
        _raises(lambda: lstm_kernel.lstm_scan_grad(xw, dtensor(w_h))),
    ]
    audio = torch.rand(2, 4096)
    bank = torch.rand(512, 16)
    out['stft_refusals'] = [
        _raises(lambda: stft_kernel.stft_power(dtensor(audio), bank, 512,
                                               128)),
        _raises(lambda: stft_kernel.stft_power(audio, dtensor(bank), 512,
                                               128)),
    ]
    out['cqt_refusals'] = [
        _raises(lambda: cqt_kernel.cqt_mag(dtensor(audio), bank, 512, 128)),
        _raises(lambda: cqt_kernel.cqt_mag(audio, dtensor(bank), 512, 128)),
        _raises(lambda: cqt_kernel.cqt_mag_grouped(
            dtensor(audio), bank, (256, 256), (4, 4), 128)),
        _raises(lambda: cqt_kernel.cqt_mag_grouped(
            audio, dtensor(bank), (256, 256), (4, 4), 128)),
    ]
    out['plain_refusals'] = [
        _raises(lambda: lstm_kernel.lstm_scan(xw, w_h)),
        _raises(lambda: stft_kernel.stft_power(audio, bank, 512, 128)),
        _raises(lambda: cqt_kernel.cqt_mag(audio, bank, 512, 128)),
    ]

    # The layer gathers a DTensor recurrent kernel before the kernel call
    layer = FastBiLSTM(8, 16, generator=torch.Generator().manual_seed(0))
    feats = torch.from_numpy(rng.randn(2, 5, 8).astype(np.float32))
    with torch.no_grad():
        want = layer(feats)
        layer.recurrent_kernel_fwd = torch.nn.Parameter(
            dtensor(layer.recurrent_kernel_fwd.detach()))
        got = layer(feats)
    out['dtensor_layer'] = (_numpy(got), _numpy(want))

    return out


##################################################
# DATA-PARALLEL TRAINING                         #
##################################################


def _model(spec):
    """A model of the port from ``(kind, kwargs)``: ``'of1'`` and
    ``'of2'`` an OnsetsFrames (V1, V2) on the piano, ``'tabcnn'`` a TabCNN
    on the guitar."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames, OnsetsFrames2, TabCNN

    kind, kwargs = spec
    if kind == 'of1':
        return OnsetsFrames(profile=tools.PianoProfile(), **kwargs)
    if kind == 'of2':
        return OnsetsFrames2(profile=tools.PianoProfile(), **kwargs)

    return TabCNN(profile=tools.GuitarProfile(), **kwargs)


class Loader:
    """A re-iterable loader over fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def _step_result(model, loss):
    return {'loss': _numpy(loss),
            'grads': {name: _numpy(p.grad)
                      for name, p in model.named_parameters()},
            'state': _numpy(model.state_dict())}


def train_checks(rank, inputs):
    from amt_tools_tpu_torch.parallel import get_mesh, shard_batch
    from amt_tools_tpu_torch.train import make_train_step, step_generator, train

    meshes = {4: get_mesh(device='cpu'),
              2: get_mesh(devices=[0, 1], device='cpu')}
    out = {}

    for name, case in inputs['steps'].items():
        if rank >= case['world']:
            continue
        mesh = meshes[case['world']]
        model = _model(case['spec'])
        model.load_state_dict(case['state'])
        step = make_train_step(
            model, torch.optim.SGD(model.parameters(), lr=inputs['lr']),
            mesh=mesh)
        loss = step(shard_batch(case['batch'], mesh),
                    step_generator(inputs['seed'], 0, 'cpu'))
        out[name] = _step_result(model, loss)

    # train(): two iterations writing a checkpoint, then a resume to three
    # from other weights; accumulation over 2 microbatches
    loop = inputs['loop']
    runs = []
    for iterations, weights in ((2, loop['state']), (3, None)):
        model = _model(loop['spec'])
        if weights is not None:
            model.load_state_dict(weights)
        runs.append(train(model, Loader(loop['batches']),
                          torch.optim.SGD(model.parameters(),
                                          lr=inputs['lr']),
                          iterations, log_dir=loop['log_dir'], seed=3,
                          device='cpu', mesh=meshes[4]))
    out['loop'] = {'runs': runs, 'state': _numpy(model.state_dict())}

    model = _model(loop['spec'])
    model.load_state_dict(loop['state'])
    result = train(model, Loader(loop['batches'][:1]),
                   torch.optim.SGD(model.parameters(), lr=inputs['lr']), 1,
                   log_dir=None, seed=3, device='cpu', accum_steps=2,
                   mesh=meshes[4])
    out['accum'] = {'result': result, 'state': _numpy(model.state_dict())}

    return out


##################################################
# DATA-PARALLEL SERVING                          #
##################################################


N_MELS = 48
GUITAR_CQT = dict(sample_rate=22050, hop_length=512, n_bins=48,
                  bins_per_octave=12)


def piano_model(spec, state):
    """An O&F2 (48 mels, complexity 2) from ``spec`` (model keyword
    arguments) and a state dict."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import OnsetsFrames2

    model = OnsetsFrames2(dim_in=N_MELS, profile=tools.PianoProfile(),
                          model_complexity=2, **spec)
    model.load_state_dict(state)

    return model


def piano_pipeline(spec, state, mesh=None, capacity=256, threshold=0.5):
    """A TranscriptionPipeline of :func:`piano_model` on the CPU."""

    from amt_tools_tpu_torch.features import MelSpec
    from amt_tools_tpu_torch.serving import TranscriptionPipeline

    return TranscriptionPipeline(piano_model(spec, state),
                                 MelSpec(n_mels=N_MELS), capacity=capacity,
                                 threshold=threshold, device='cpu', mesh=mesh)


def guitar_pipeline(spec, state, mesh=None):
    """A TabCNN (fullseq) TablaturePipeline behind a 48-bin CQT, from
    ``spec`` and a state dict (or its seeded initial weights)."""

    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.features import CQT
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.serving import TablaturePipeline

    model = TabCNN(dim_in=GUITAR_CQT['n_bins'],
                   profile=tools.GuitarProfile(num_frets=19), fullseq=True,
                   **spec)
    if state is not None:
        model.load_state_dict(state)

    return TablaturePipeline(model, CQT(**GUITAR_CQT), capacity=64,
                             device='cpu', mesh=mesh)


def serving_checks(rank, inputs):
    from amt_tools_tpu_torch.parallel import get_mesh

    mesh = get_mesh(device='cpu')
    out = {}
    for name, (spec, state) in inputs['piano'].items():
        pipeline = piano_pipeline(spec, state, mesh)
        # The overlapped protocol: the next batch before the first finalize
        first = pipeline.dispatch(inputs['audio'])
        second = pipeline.dispatch(torch.from_numpy(inputs['audio']))
        out[name] = (pipeline.finalize(first), pipeline.finalize(second))
    out['indivisible'] = _raises(lambda: pipeline(inputs['audio'][:6]))

    # A near-zero threshold decodes more notes than capacity 8 holds: each
    # rank decodes its overflowing clips again
    spec, state = inputs['piano']['float32']
    out['overflow'] = [piano_pipeline(spec, state, mesh, capacity=capacity,
                                      threshold=0.02)(inputs['audio'])
                       for capacity in (8, 4096)]

    spec, state = inputs['guitar']
    out['guitar'] = guitar_pipeline(spec, state, mesh)(inputs['guitar_audio'])

    return out


##################################################
# CONTEXT AND TENSOR PARALLELISM                 #
##################################################


def _full_state(model, reference, group):
    """``model``'s state with every tensor-parallel shard gathered whole
    (along the dimension where its shape differs from ``reference``'s)."""

    from amt_tools_tpu_torch.parallel import collectives

    full = {}
    shapes = {k: v.shape for k, v in reference.state_dict().items()}
    for key, value in model.state_dict().items():
        dims = [d for d, (a, b) in enumerate(zip(value.shape, shapes[key]))
                if a != b]
        if dims:
            value = collectives.gather_columns(value, group, dims[0])
        full[key] = value.detach().numpy()

    return full


def cp_tp_checks(rank, inputs):
    from amt_tools_tpu_torch import tools
    from amt_tools_tpu_torch.models import TabCNN
    from amt_tools_tpu_torch.parallel import (framify_time_sharded, get_mesh,
                                              shard_batch, shard_params_tp,
                                              shard_time)
    from amt_tools_tpu_torch.train import make_train_step, step_generator

    out = {}
    mesh = get_mesh(device='cpu')

    # Context parallelism: windows, edges, errors, TabCNN, the gradient
    feats = torch.from_numpy(inputs['feats'])
    out['windows'] = _numpy(framify_time_sharded(shard_time(feats, mesh), 9,
                                                 mesh))
    out['edges'] = _numpy(framify_time_sharded(
        shard_time(torch.ones(1, 1, 4, 64), mesh), 9, mesh))
    out['windows_1'] = _numpy(framify_time_sharded(shard_time(feats, mesh),
                                                   1, mesh))
    out['indivisible'] = _raises(lambda: shard_time(torch.zeros(1, 1, 4, 30),
                                                    mesh))
    out['halo'] = _raises(lambda: framify_time_sharded(
        shard_time(torch.zeros(1, 1, 4, 8), mesh), 9, mesh))

    local = shard_time(feats, mesh).requires_grad_(True)
    windows = framify_time_sharded(local, 9, mesh)
    weights = shard_time(torch.from_numpy(inputs['window_weights']).permute(
        0, 1, 2, 4, 3), mesh).permute(0, 1, 2, 4, 3)
    (windows * weights).sum().backward()
    out['window_grad'] = _numpy(local.grad)

    model = TabCNN(dim_in=48, profile=tools.GuitarProfile(),
                   model_complexity=1).eval()
    model.load_state_dict(inputs['tabcnn'])
    track = shard_time(torch.from_numpy(inputs['track']), mesh)
    with torch.no_grad():
        windows = framify_time_sharded(track, model.frame_width, mesh)
        out['tabcnn'] = _numpy(model(windows.permute(0, 3, 1, 2, 4))[
            tools.KEY_TABLATURE])

    # Tensor parallelism on a 2 (data) x 2 (model) mesh
    grid = get_mesh(axis_names=('data', 'model'), shape=(2, 2), device='cpu')
    model_group = grid.get_group('model')
    for name, case in inputs['tp'].items():
        model = _model(case['spec'])
        model.load_state_dict(case['state'])
        reference = _model(case['spec'])
        sharded = shard_params_tp(model, grid)
        step = make_train_step(
            model, torch.optim.SGD(model.parameters(), lr=inputs['lr']),
            mesh=grid)
        loss = step(shard_batch(case['batch'], grid),
                    step_generator(inputs['seed'], 0, 'cpu'))
        out[name] = {'sharded': sharded, 'loss': _numpy(loss),
                     'local': {k: tuple(v.shape) for k, v in
                               model.state_dict().items()},
                     'state': _full_state(model, reference, model_group)}

    return out


##################################################
# PIPELINE PARALLELISM                           #
##################################################


def residual_stage(params, y):
    """One pipeline stage: a gated residual dense block (shape-preserving)."""

    return y + torch.tanh(y @ params['w'] + params['b'])


def _stages(arrays):
    return [{key: torch.from_numpy(value) for key, value in stage.items()}
            for stage in arrays]


def pp_checks(rank, inputs):
    from amt_tools_tpu_torch.parallel import (get_mesh, pipeline_apply,
                                              shard_params_pp,
                                              stack_stage_params)
    from amt_tools_tpu_torch.parallel.pp_flagship import (
        flagship_pipeline_forward)

    meshes = {size: get_mesh(devices=range(size), axis_names=('pipe',),
                             device='cpu') for size in (3, 4, 5)}
    grid = get_mesh(axis_names=('pipe', 'data'), shape=(4, 2), device='cpu')
    out = {}

    # The generic schedule: forward, gradients, dp x pp, a stage mismatch
    if rank < 4:
        case = inputs['forward']
        local = shard_params_pp(stack_stage_params(_stages(case['stages'])),
                                meshes[4])
        out['forward'] = _numpy(pipeline_apply(
            local, torch.from_numpy(case['x']), residual_stage, meshes[4]))

        case = inputs['gradients']
        local = shard_params_pp(stack_stage_params(_stages(case['stages'])),
                                meshes[4])
        for value in local.values():
            value.requires_grad_(True)
        x = torch.from_numpy(case['x']).requires_grad_(True)
        y = pipeline_apply(local, x, residual_stage, meshes[4])
        torch.mean((y - torch.from_numpy(case['target'])) ** 2).backward()
        out['gradients'] = {'params': _numpy({k: v.grad for k, v in
                                              local.items()}),
                            'x': _numpy(x.grad)}

        out['mismatch'] = _raises(lambda: shard_params_pp(
            stack_stage_params(_stages(inputs['forward']['stages'][:3])),
            meshes[4]))

    case = inputs['dp_pp']
    local = shard_params_pp(stack_stage_params(_stages(case['stages'])), grid)
    data = grid.get_local_rank('data')
    x = torch.from_numpy(case['x'])
    rows = x.shape[1] // 2
    out['dp_pp'] = _numpy(pipeline_apply(
        local, x[:, data * rows:(data + 1) * rows], residual_stage, grid,
        batch_axis='data'))

    # The flagship models: one stage per rank
    for name, case in inputs['flagship'].items():
        stages = case['stages']
        mesh = grid if case['dp'] else meshes[stages]
        if not case['dp'] and rank >= stages:
            continue
        model = _model(case['spec']).eval()
        model.load_state_dict(case['state'])
        feats = torch.from_numpy(case['feats'])
        if case['dp']:
            data = grid.get_local_rank('data')
            rows = feats.shape[0] // 2
            feats = feats[data * rows:(data + 1) * rows]
        feats.requires_grad_(case['grad'])
        logits = flagship_pipeline_forward(model, feats, mesh,
                                           case['num_micro'],
                                           batch_axis='data' if case['dp']
                                           else None)
        result = {'logits': _numpy(logits)}
        if case['grad']:
            loss = sum(torch.sum(logits[key] ** 2) for key in case['keys'])
            loss.backward()
            result['feats_grad'] = _numpy(feats.grad)
            result['param_grads'] = {
                key: _numpy(p.grad) for key, p in model.named_parameters()
                if p.grad is not None}
        out[name] = result

    return out
