"""Constant-Q / variable-Q transform features as one framed contraction.

Counterpart of ``amt_tools_tpu/features/cqt.py`` ``VQT`` (``:20``) and
``CQT`` (``:195``). The wavelet bank is built once on the host
(``spectral.wavelet_bank``). With ``grouped`` the bins are split into
``group_size`` groups, each bank padded only to its own longest wavelet,
column-padded to the widest group and row-stacked, as the JAX package
builds it (``:84-110``). :meth:`process` runs kernel D
(``ops.cqt_kernel.cqt_mag_grouped``) when groups were built and kernel C
(``ops.cqt_kernel.cqt_mag``) otherwise, on CUDA audio; their plain framed
matmuls on CPU audio. The JAX package's ``optimization_barrier`` before the
dB scaling is an identity and has no counterpart here.
"""

import numpy as np
import torch

from .. import profiling
from ..ops import cuda_build, spectral
from ..ops.cqt_kernel import cqt_mag, cqt_mag_grouped
from ..tools.instrument import midi_to_hz, note_to_midi
from .common import FeatureModule

# The JAX kernel's support tile: group supports are multiples of it
_SUPPORT_TILE = 2048


class VQT(FeatureModule):
    """Variable-Q transform magnitude features -> (1, n_bins, T).

    ``exact`` selects the kernels' contraction on CUDA audio, as it selects
    the Pallas kernel's passes on the TPU: ``True`` IEEE float32 FMAs (the
    TPU's 6-pass HIGHEST), ``'high'`` three bf16 tensor-core passes of a
    hi/lo split (``hi*hi + hi*lo + lo*hi``, float32 accumulation: the TPU's
    bf16x3, within 2e-4 of each clip's peak magnitude of float32; the dB
    scale magnifies that in the quietest bins above its -80 dB floor),
    ``False`` one bf16 pass (``hi*hi``). CPU audio contracts in IEEE
    float32 in every mode, as the JAX class's XLA route does on its CPU.
    ``grouped``: ``True`` always splits the bank into ``group_size``-bin
    groups when there are at least two groups' worth of bins, ``'auto'``
    only when the split drops support tiles. The JAX class's
    ``frame_chunk`` and ``use_pallas`` have no counterpart: CUDA audio
    always takes the kernels, and the CPU path frames 256 frames at a
    time.
    """

    def __init__(self, sample_rate=22050, hop_length=512, decibels=True,
                 fmin=None, n_bins=84, bins_per_octave=12, gamma=None,
                 exact=True, grouped=False, group_size=64):
        super().__init__(sample_rate, hop_length, 1, decibels)

        self.exact = exact

        if fmin is None:
            # C1 by default
            fmin = float(midi_to_hz(note_to_midi('C1')))
        self.fmin = fmin

        self.n_bins = n_bins
        self.bins_per_octave = bins_per_octave

        # Inverse of the constant Q factor
        self.alpha = 2.0 ** (1.0 / self.bins_per_octave) - 1

        if gamma is None:
            # Bandwidth offset default from the VQT paper / librosa docs
            gamma = 24.7 * self.alpha / 0.108
        self.gamma = gamma

        freqs = spectral.cqt_frequencies(n_bins, self.fmin, bins_per_octave)
        if np.max(freqs) > sample_rate / 2:
            raise ValueError('Highest CQT bin exceeds the Nyquist frequency.')

        self._kernel, self._support = spectral.wavelet_bank(
            freqs, sample_rate, alpha=self.alpha, gamma=self.gamma)

        # Support-grouped banks: a single bank pads every bin to the
        # longest support; each group is padded only to its own
        self._groups = None
        if grouped and n_bins >= 2 * group_size:
            groups = [spectral.wavelet_bank(freqs[s: s + group_size],
                                            sample_rate, alpha=self.alpha,
                                            gamma=self.gamma)
                      for s in range(0, n_bins, group_size)]
            grouped_tiles = sum(sup // _SUPPORT_TILE for _, sup in groups)
            full_tiles = (self._support // _SUPPORT_TILE) * len(groups)
            if grouped != 'auto' or grouped_tiles < full_tiles:
                self._groups = groups
                # Column-pad every group's bank to the widest group and
                # row-concatenate in group order
                gb = max(k.shape[-1] // 2 for k, _ in groups)
                slabs = []
                for k_g, _ in groups:
                    nb = k_g.shape[-1] // 2
                    if nb < gb:
                        pad = np.zeros((k_g.shape[0], gb - nb), k_g.dtype)
                        k_g = np.concatenate(
                            [k_g[:, :nb], pad, k_g[:, nb:], pad], axis=1)
                    slabs.append(k_g)
                self._bank_stack = np.concatenate(slabs, axis=0)
                self._group_supports = tuple(sup for _, sup in groups)
                self._group_bins = tuple(k.shape[-1] // 2 for k, _ in groups)

        # Device copies of the bank (or bank stack), made on first use
        self._device_banks = {}

    def _bank(self, device):
        host = self._kernel if self._groups is None else self._bank_stack
        return cuda_build.cached(self._device_banks, device,
                                 lambda: torch.from_numpy(host).to(device))

    def process(self, audio):
        """(..., N) float32 audio -> (..., 1, n_bins, T) [0, 1] features."""

        with profiling.span('amt.features'):
            lead = audio.shape[:-1]
            flat = audio.reshape((-1, audio.shape[-1])).contiguous()
            bank = self._bank(audio.device)

            # The CPU contracts in IEEE float32 whatever ``exact`` says, as
            # the JAX class's XLA route does: ``exact`` selects the kernel's
            # passes
            exact = self.exact if flat.device.type == 'cuda' else True
            if self._groups is not None:
                mag = cqt_mag_grouped(flat, bank, self._group_supports,
                                      self._group_bins, self.hop_length,
                                      exact=exact)
            else:
                mag = cqt_mag(flat, bank, self._support, self.hop_length,
                              exact=exact)

            return self.post_proc(mag.reshape(lead + mag.shape[1:]))

    def get_times(self, audio, at_start=False):
        times = super().get_times(audio)

        if at_start:
            # Compensate the latency of the longest (lowest-frequency) filter
            longest = spectral.wavelet_lengths(self.fmin, self.sample_rate,
                                               self.alpha, self.gamma)
            times = times - (longest // 2) / self.sample_rate

        return times

    def get_feature_size(self):
        return self.n_bins


class CQT(VQT):
    """Constant-Q transform: a VQT with gamma = 0."""

    def __init__(self, sample_rate=22050, hop_length=512, decibels=True,
                 fmin=None, n_bins=84, bins_per_octave=12, exact=True,
                 grouped=False, group_size=64):
        super().__init__(sample_rate=sample_rate, hop_length=hop_length,
                         decibels=decibels, fmin=fmin, n_bins=n_bins,
                         bins_per_octave=bins_per_octave, gamma=0.0,
                         exact=exact, grouped=grouped, group_size=group_size)
