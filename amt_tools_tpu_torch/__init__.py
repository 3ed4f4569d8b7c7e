"""PyTorch/CUDA port of the amt_tools_tpu transcription framework.

The JAX package ``amt_tools_tpu`` is the reference; this package mirrors its
layout (``tools``, ``ops``, ``features``, ``models``, ``datasets``,
``serving``, ``train``, ``metrics``, ``transcribe``, ``inference``,
``evaluate``, ``parallel``) and holds
each module against its JAX counterpart in ``tests/test_torch_*.py``. It
imports ``torch`` and numpy only — never JAX, Flax, Optax or anything of
``amt_tools_tpu``.

Entry points run on CUDA unless the caller passes ``device='cpu'``. The
Pallas kernels of the JAX package become hand-written Hopper kernels
(``csrc/``), built with ``nvcc`` at first use; their wrappers run the plain
PyTorch version only for tensors that lie on the CPU.
"""

from . import (tools, ops, features, models, datasets, serving, train,
               weights, metrics, transcribe, inference, evaluate, parallel)

__all__ = ['tools', 'ops', 'features', 'models', 'datasets', 'serving',
           'train', 'weights', 'metrics', 'transcribe', 'inference',
           'evaluate', 'parallel']
