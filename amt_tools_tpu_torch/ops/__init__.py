"""Tensor ops: spectral primitives, Hopper kernels with plain versions,
LSTM and GRU layers, attention and transformer layers, framing and the
on-device note, tablature and regression decode."""

from . import (add_layer_norm, attention, conv_epilogue, cqt_kernel,
               cuda_build, decode, frames, gru, gru_kernel, layers, lstm,
               lstm_kernel, spectral, stft_kernel)
