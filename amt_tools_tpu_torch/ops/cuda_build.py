"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so`` (the directory is git-ignored), where the
hash covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused. :func:`build` starts one ``nvcc`` per source, all at
once. Nothing is compiled or loaded when a module is imported: the first
kernel launch builds what it needs.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ['KERNEL_SOURCES', 'build', 'library', 'check']

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'

KERNEL_SOURCES = ('stft_power', 'lstm_scan')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_loaded = {}


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

    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    jobs = []
    for name in names:
        target = _library_path(name)
        if target.exists():
            continue
        partial = target.with_name(f'{target.stem}.{os.getpid()}.partial.so')
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

    if name not in _loaded:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for function, argtypes in signatures.items():
            fn = getattr(lib, function)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib

    return _loaded[name]


def check(status, kernel):
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""

    if status != 0:
        raise RuntimeError(f'{kernel} kernel launch failed with CUDA error '
                           f'{status}')
