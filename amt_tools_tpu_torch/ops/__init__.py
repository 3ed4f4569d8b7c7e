"""Tensor ops: spectral primitives, Hopper kernels with plain versions,
LSTM layers, framing and the on-device note and tablature decode."""

from . import (conv_epilogue, cqt_kernel, cuda_build, decode, frames,
               layers, lstm, lstm_kernel, spectral, stft_kernel)
