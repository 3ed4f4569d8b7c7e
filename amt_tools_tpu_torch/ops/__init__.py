"""Tensor ops: spectral primitives, Hopper kernels with plain versions,
LSTM layers and the on-device note decode."""

from . import (cuda_build, decode, layers, lstm, lstm_kernel, spectral,
               stft_kernel)
