"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so`` (the directory is git-ignored), where the
hash covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused. :func:`build` starts one ``nvcc`` per source, all at
once. Nothing is compiled or loaded when a module is imported: the first
kernel launch builds what it needs.

Loader threads compute features, so the first launch of a kernel may come
from several threads at once. :func:`build` and :func:`library` hold one
module lock: a kernel is built and loaded once, however many threads reach
it first, and a build that fails raises in every thread that asks for it.
Each compiler writes to a temporary name that carries the process and the
thread, and the finished library is renamed into place. :func:`count`
increments the wrappers' launch counters under a lock, and :func:`cached`
fills a device-side cache (banks, twiddles, occupancy answers) once.
:func:`require_plain` refuses a tensor a kernel cannot read through its
data pointer (a DTensor or another wrapper subclass), on every route.
:func:`cluster_rows` is the cluster kernels' one rule for the batch rows a
cluster takes.

Each kernel is reached through a ``torch.library`` custom op in the
:data:`NAMESPACE` namespace (``torch.ops.amt_tools_tpu_torch.*``), defined
beside its wrapper, so that ``torch.export``, ``FlopCounterMode`` and
``torch.library.opcheck`` see it. The op's real implementation launches the
kernel (and counts the launch) for CUDA tensors and runs the plain version
for CPU tensors; its fake implementation gives shapes only. :func:`register_cost`
gives an op its one cost function, ``(flops, bytes)``, which feeds both
``FlopCounterMode`` (as the op's FLOP formula) and :data:`OP_COSTS`, where
``profiling.compiled_cost`` reads the op's bytes.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ['KERNEL_SOURCES', 'NAMESPACE', 'OP_COSTS', 'build', 'library',
           'check', 'count', 'cached', 'require_plain', 'register_cost',
           'cluster_rows']

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'

KERNEL_SOURCES = ('stft_power', 'lstm_scan', 'lstm_bptt', 'cqt_mag',
                  'conv_epilogue', 'gru_scan', 'add_layer_norm')

# The custom ops' namespace: torch.ops.amt_tools_tpu_torch.<op>
NAMESPACE = 'amt_tools_tpu_torch'

# op packet -> cost(*args, **kwargs) -> (flops, bytes), on the op's
# arguments (real or fake tensors)
OP_COSTS = {}

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_loaded = {}
# Builds and loads (re-entrant: library() builds under it)
_build_lock = threading.RLock()
# Launch counters and device-side caches
_count_lock = threading.Lock()
_cache_lock = threading.Lock()


def _nvcc():
    nvcc = shutil.which('nvcc')
    if nvcc is None and Path('/usr/local/cuda/bin/nvcc').exists():
        nvcc = '/usr/local/cuda/bin/nvcc'
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (PATH or /usr/local/cuda/bin)')
    return nvcc


def _library_path(name):
    source = (CSRC_DIR / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(source + ' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(names=KERNEL_SOURCES):
    """Compile the named kernels that are not built yet, all in parallel.

    Returns ``{name: {'seconds': s, 'ptxas': text}}`` for the sources it
    compiled (``ptxas`` is the assembler's register and shared-memory
    report). Raises with the compiler's output if any build fails.
    """

    with _build_lock:
        return _build(names)


def _build(names):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    jobs = []
    for name in names:
        target = _library_path(name)
        if target.exists():
            continue
        partial = target.with_name(f'{target.stem}.{os.getpid()}.'
                                   f'{threading.get_ident()}.partial.so')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(partial),
               str(CSRC_DIR / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, target, partial, proc, time.perf_counter()))

    report = {}
    failures = []
    for name, target, partial, proc, start in jobs:
        out, err = proc.communicate()
        if proc.returncode:
            failures.append(f'nvcc failed for {name}.cu:\n{out}{err}')
            continue
        os.replace(partial, target)
        report[name] = {'seconds': time.perf_counter() - start,
                        'ptxas': (out + err).strip()}

    if failures:
        raise RuntimeError('\n'.join(failures))

    return report


def library(name, signatures):
    """The loaded shared library of kernel ``name``, built at first use.

    ``signatures`` maps each exported C function to its ctypes argtypes;
    every function returns the ``cudaError_t`` of its launch as an int.
    """

    lib = _loaded.get(name)
    if lib is not None:
        return lib

    with _build_lock:
        if name not in _loaded:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            for function, argtypes in signatures.items():
                fn = getattr(lib, function)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib

    return _loaded[name]


def count(wrapper, *counters):
    """Add one to each named launch counter of a kernel's wrapper."""

    with _count_lock:
        for counter in counters:
            setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def cached(cache, key, make):
    """``cache[key]``, made by ``make()`` once however many threads ask
    for it first. A value made while ``torch.export`` traces (a fake or
    functional tensor) is the trace's constant and is not kept."""

    value = cache.get(key)
    if value is None:
        with _cache_lock:
            value = cache.get(key)
            if value is None:
                value = make()
                if not _traced(value):
                    cache[key] = value

    return value


def _traced(value):
    """Whether ``value`` is a tracer's tensor rather than a real one."""

    import torch
    from torch._subclasses.fake_tensor import is_fake

    return isinstance(value, torch.Tensor) and (
        is_fake(value) or type(value) not in (torch.Tensor,
                                              torch.nn.Parameter))


def cluster_rows(batch, groups, max_rows, active_clusters):
    """Batch rows a cluster for a launch of ``groups`` sequences of
    ``batch`` rows, each group on its own ``ceil(batch / rows)`` clusters,
    given how many clusters the card holds at once: the fewest rows that
    put every cluster in one wave, or ``max_rows`` (the most the buffers
    fit) where none does. The rule of kernels B, E, F and G."""

    return next((rows for rows in range(1, max_rows + 1)
                 if groups * -(-batch // rows) <= active_clusters), max_rows)


def check(status, kernel):
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""

    if status != 0:
        raise RuntimeError(f'{kernel} kernel launch failed with CUDA error '
                           f'{status}')


def require_plain(kernel, **tensors):
    """Raise ``TypeError`` for any named tensor that is not a plain
    ``torch.Tensor`` (or ``nn.Parameter``): a DTensor's or another wrapper
    subclass's data pointer is not its values, so the kernels would read
    garbage. The tracer's fake tensors (``torch.export``) pass: they reach
    the op's fake implementation, never a kernel."""

    import torch
    from torch._subclasses.fake_tensor import is_fake

    for name, tensor in tensors.items():
        if tensor is not None and type(tensor) not in (
                torch.Tensor, torch.nn.Parameter) and not is_fake(tensor):
            raise TypeError(
                f'{kernel} takes plain tensors, got a '
                f'{type(tensor).__name__} for {name}: the kernel reads it '
                f'through its data pointer. Gather a DTensor first '
                f'(full_tensor() or to_local()).')


def register_cost(op, cost):
    """Give the custom op ``op`` (a ``CustomOpDef``) its cost function,
    ``cost(*args, **kwargs) -> (flops, bytes)`` on the op's arguments: its
    FLOP formula for ``FlopCounterMode`` and its entry of :data:`OP_COSTS`."""

    import torch
    from torch.utils.flop_counter import register_flop_formula

    packet = getattr(getattr(torch.ops, NAMESPACE), op._name)
    OP_COSTS[packet] = cost

    @register_flop_formula(packet, get_raw=True)
    def flops(*args, out_val=None, **kwargs):
        return int(round(cost(*args, **kwargs)[0]))

    return op
