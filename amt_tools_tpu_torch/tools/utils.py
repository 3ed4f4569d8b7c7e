"""Host helpers: note sorting, time-grid hop estimation, device choice.

``sort_notes`` and ``estimate_hop_length`` are copies of
``amt_tools_tpu/tools/utils.py:149`` and ``:1239`` (numpy, host side).
"""

import contextlib

import numpy as np
import torch

__all__ = [
    'sort_notes',
    'estimate_hop_length',
    'resolve_device',
    'use_exact_fp32',
    'exact_fp32',
]


def sort_notes(pitches, intervals, by=0):
    """Stable-sort loose note groups by attribute (0 onset | 1 offset | 2 pitch)."""

    batched_notes = np.empty([0, 3])
    if len(pitches) > 0:
        batched_notes = np.concatenate(
            (np.asarray(intervals, dtype=np.float64).reshape(-1, 2),
             np.asarray(pitches, dtype=np.float64).reshape(-1, 1)), axis=-1)

    order = np.argsort(batched_notes[..., by], kind='stable')
    batched_notes = batched_notes[order].reshape(-1, 3)

    return batched_notes[..., 2], batched_notes[..., :2]


def estimate_hop_length(times):
    """Estimate the hop of a semi-regular time grid (median of regular diffs)."""

    if not len(times):
        raise ValueError('Cannot estimate hop length from an empty time array.')

    times = np.sort(np.asarray(times))

    if len(times) == 1:
        raise ValueError('Cannot estimate hop length from a single time.')

    non_gaps = np.append([False], np.isclose(np.diff(times, n=2), 0))

    if not np.sum(non_gaps):
        if len(times) == 2:
            return times[1] - times[0]
        raise ValueError('Time observations are too irregular.')

    return float(np.median(np.diff(times)[non_gaps]))


def resolve_device(device=None):
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device named and no CUDA device present this raises: the port
    never moves to the CPU on its own. ``device='cpu'`` runs every kernel's
    plain PyTorch version.
    """

    if device is not None:
        return torch.device(device)

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")

    return torch.device('cuda', torch.cuda.current_device())


def use_exact_fp32():
    """Turn TF32 off, process-wide, for float32 matmuls and cuDNN convs.

    cuDNN convolutions default to TF32 (``torch.backends.cudnn.allow_tf32``),
    which keeps about three decimal digits; the JAX reference computes the
    float32 path in full precision. bf16 work is unaffected. The serving
    entry points call this once, where they are built.
    """

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def exact_fp32():
    """:func:`use_exact_fp32` for the duration of a block, for tests and
    measurements; the previous flags are restored on exit."""

    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
