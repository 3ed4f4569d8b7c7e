"""Framing of activations into context windows, on tensors.

Counterpart of ``amt_tools_tpu/ops/frames.py`` ``framify`` (``:15``), for
the windowed TabCNN forward.
"""

import torch
import torch.nn.functional as F

__all__ = [
    'framify',
]


def framify(activations, win_length, hop_length=1, pad=True):
    """Chunk (..., T) activations into (..., T', win_length) windows.

    With ``pad`` the input is zero center-padded so T' = T and window t is
    centered on frame t. Returns a copy (a gather), as the JAX function does.
    """

    num_frames = activations.shape[-1]
    pad_length = win_length // 2

    if pad:
        target = num_frames + 2 * pad_length
    else:
        target = max(win_length, num_frames)

    lpad = (target - num_frames) // 2
    rpad = target - num_frames - lpad
    activations = F.pad(activations, (lpad, rpad))

    num_hops = (target - 2 * pad_length) // hop_length

    starts = torch.arange(num_hops, device=activations.device) * hop_length
    idcs = starts[:, None] + torch.arange(win_length,
                                          device=activations.device)[None, :]

    return activations[..., idcs]
