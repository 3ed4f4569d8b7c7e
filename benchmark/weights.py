"""Seeds, and weights made on the device from one.

A reference module lists its configuration's parameters as ``(name,
shape, init)``, named as the port's ``state_dict`` names them. ``init`` is
``('normal', mean, std)`` or ``('uniform', low, high)``. :func:`make` draws
every normal value in one call and every uniform value in another, from a
generator on the device seeded from the run's seed, in float32 (the port
keeps float32 parameters and casts them to the compute dtype), and hands
the same tensors to the program and to the reference.
"""

import numpy as np
import torch


def derive(seed, *path):
    """A 63-bit seed for one use (``path``: names) of the run's seed."""

    words = [int(seed) % (1 << 64)] + [int.from_bytes(str(p).encode(), 'little')
                                      % (1 << 32) for p in path]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)

    return (int(state[0]) << 31) | (int(state[1]) >> 1)


def generator(seed, device, *path):
    """A ``torch.Generator`` on ``device`` seeded from ``derive``."""

    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, *path))

    return gen


def make(spec, seed, device):
    """{name: float32 tensor on ``device``} for a reference's parameter
    list, drawn in two large calls."""

    gen = generator(seed, device, 'weights')
    sizes = {kind: sum(int(np.prod(shape)) for _, shape, init in spec
                       if init[0] == kind) for kind in ('normal', 'uniform')}
    draws = {'normal': torch.randn(sizes['normal'], generator=gen,
                                   device=device),
             'uniform': torch.rand(sizes['uniform'], generator=gen,
                                   device=device)}
    offsets = {'normal': 0, 'uniform': 0}

    params = {}
    for name, shape, init in spec:
        kind, a, b = init
        size = int(np.prod(shape))
        values = draws[kind][offsets[kind]:offsets[kind] + size].view(shape)
        offsets[kind] += size
        params[name] = (a + b * values if kind == 'normal'
                        else a + (b - a) * values).contiguous()

    return params
