"""The port's CQT (bank builders, kernels C and D through their plain
versions, the ``CQT`` feature module) vs the JAX package's, on the CPU.

On CPU tensors the wrappers run their plain versions, framed float32
matmuls; the Hopper kernels themselves are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). The JAX side runs the
Pallas kernels in interpret mode (``block_t=8, tile_s=1024``, as the JAX
package's own tests do) and its XLA ``cqt_mag``.

Tolerances, relative to each clip's peak magnitude (quiet bins carry an
absolute error set by the frame energy, not by their own value):
- ``exact=True``: 1e-5 (both float32, sums in another order);
- ``exact='high'``: 1e-5. Both sides split the operands into bf16 hi and
  lo and sum ``hi*hi + hi*lo + lo*hi`` in float32; the products of bf16
  values are exact, so only the order of the sums differs.
  ``test_high_tolerance_tells_the_passes_apart`` shows that 1e-5 rejects
  two passes and one;
- ``exact=False``: 1e-5 against a float64 numpy product of bf16-rounded
  operands. JAX's interpret mode runs that dot in float32 on the CPU, so it
  cannot be the reference there;
- [0, 1] dB features: 2e-4 (``features/cqt.py:29-33``) where the port's
  and JAX's contractions differ ('high' on JAX's side), 1e-5 where both
  contract in float32 (the CPU route, every ``exact``).
The bank builders and the group layout must agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amt_tools_tpu.features import CQT as JaxCQT
from amt_tools_tpu.features import VQT as JaxVQT
from amt_tools_tpu.ops import spectral as jspec
from amt_tools_tpu.ops.pallas_cqt import cqt_mag_pallas, cqt_mag_pallas_grouped

from amt_tools_tpu_torch.features import CQT, VQT
from amt_tools_tpu_torch.ops import spectral
from amt_tools_tpu_torch.ops.cqt_kernel import (CHUNK_TAPS, FRAME_CHUNK,
                                                cqt_mag, cqt_mag_grouped,
                                                cqt_mag_grouped_plain,
                                                cqt_mag_plain, split_bf16)

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

SR = 22050
HOP = 512
PALLAS = dict(block_t=8, tile_s=1024, interpret=True)


def _tonal(batch, num_samples, seed=0):
    """Partials plus a little noise: quiet off-resonance bins beside loud
    ones, the hard case for a low-precision contraction."""

    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / SR
    clips = []
    for _ in range(batch):
        tone = sum(a * np.sin(2 * np.pi * f * t + p)
                   for a, f, p in zip(rng.rand(3) * 0.3 + 0.1,
                                      rng.rand(3) * 600 + 110,
                                      rng.rand(3) * 6.28))
        clips.append(tone + 0.01 * rng.randn(num_samples))
    return np.stack(clips).astype(np.float32)


def _bank(n_bins=48, bpo=12, fmin=100.0):
    freqs = spectral.cqt_frequencies(n_bins, fmin, bpo)
    return freqs, 2 ** (1 / bpo) - 1


def _assert_close_to_peak(got, ref, tol):
    peak = ref.reshape(ref.shape[0], -1).max(axis=1)[:, None, None]
    np.testing.assert_allclose(got / peak, ref / peak, rtol=0, atol=tol)


def _pallas(audio, kernel, support, exact=True):
    return np.stack([np.asarray(cqt_mag_pallas(
        jnp.asarray(clip), jnp.asarray(kernel), support, HOP, exact=exact,
        **PALLAS)) for clip in audio])


def _stack(freqs, alpha, group_size):
    """The column-padded, row-stacked group banks (as ``CQT`` builds them)."""

    banks = [spectral.wavelet_bank(freqs[s: s + group_size], SR, alpha)
             for s in range(0, len(freqs), group_size)]
    gb = max(k.shape[-1] // 2 for k, _ in banks)
    slabs = []
    for k_g, _ in banks:
        nb = k_g.shape[-1] // 2
        pad = np.zeros((k_g.shape[0], gb - nb), k_g.dtype)
        slabs.append(np.concatenate([k_g[:, :nb], pad, k_g[:, nb:], pad], 1))
    return (np.concatenate(slabs), tuple(sup for _, sup in banks),
            tuple(k.shape[-1] // 2 for k, _ in banks))


@pytest.mark.parametrize('n_bins,bpo,fmin,gamma',
                         [(48, 12, 100.0, 0.0),
                          (192, 24, 32.70319566257483, 0.0),  # guitar recipe
                          (60, 12, 55.0, 3.0)])
def test_bank_builders_bit_for_bit(n_bins, bpo, fmin, gamma):
    freqs = spectral.cqt_frequencies(n_bins, fmin, bpo)
    np.testing.assert_array_equal(freqs, jspec.cqt_frequencies(n_bins, fmin,
                                                               bpo))
    alpha = 2 ** (1 / bpo) - 1
    np.testing.assert_array_equal(
        spectral.wavelet_lengths(freqs, SR, alpha, gamma),
        jspec.wavelet_lengths(freqs, SR, alpha, gamma))

    kernel, support = spectral.wavelet_bank(freqs, SR, alpha, gamma)
    ref, ref_support = jspec.wavelet_bank(freqs, SR, alpha, gamma)
    assert support == ref_support and support % 2048 == 0
    assert kernel.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(kernel, ref)


@pytest.mark.parametrize('exact,tol', [(True, 1e-5), ('high', 1e-5)])
def test_plain_matches_pallas_kernel_interpret(exact, tol):
    freqs, alpha = _bank()
    kernel, support = spectral.wavelet_bank(freqs, SR, alpha)
    audio = _tonal(2, SR)

    ref = _pallas(audio, kernel, support, exact)
    got = cqt_mag(torch.from_numpy(audio), torch.from_numpy(kernel), support,
                  HOP, exact=exact).numpy()

    assert got.shape == ref.shape == (2, 48, 1 + SR // HOP)
    _assert_close_to_peak(got, ref, tol)


@pytest.mark.parametrize('num_samples', [SR,
                                         HOP * (2 * FRAME_CHUNK - 1),
                                         HOP * (FRAME_CHUNK + 40) + 1])
def test_plain_matches_xla_cqt_mag(num_samples):
    """One chunk, exactly two, and a ragged last chunk; T = 1 + N // hop."""

    freqs, alpha = _bank()
    kernel, support = spectral.wavelet_bank(freqs, SR, alpha)
    audio = _tonal(2, num_samples, seed=1)

    ref = np.asarray(jspec.cqt_mag(jnp.asarray(audio), jnp.asarray(kernel),
                                   support, HOP))
    got = cqt_mag_plain(torch.from_numpy(audio), torch.from_numpy(kernel),
                        support, HOP).numpy()

    assert got.shape == ref.shape
    assert got.shape[-1] == 1 + num_samples // HOP
    assert -(-got.shape[-1] // FRAME_CHUNK) == (
        1 if num_samples == SR else 2)
    _assert_close_to_peak(got, ref, 1e-5)


def _round_bf16(x):
    """Round float32 to the nearest bf16 (ties to even), in numpy."""

    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def test_single_bf16_pass_matches_rounded_reference():
    freqs, alpha = _bank()
    kernel, support = spectral.wavelet_bank(freqs, SR, alpha)
    audio = _tonal(2, SR // 2, seed=2)

    frames = spectral.frame_signal(torch.from_numpy(audio), support,
                                   HOP).numpy()
    resp = (_round_bf16(frames).astype(np.float64) @
            _round_bf16(kernel).astype(np.float64))
    ref = np.sqrt(resp[..., :48] ** 2 + resp[..., 48:] ** 2).swapaxes(-1, -2)

    got = cqt_mag(torch.from_numpy(audio), torch.from_numpy(kernel), support,
                  HOP, exact=False).numpy()
    _assert_close_to_peak(got, ref, 1e-5)

    # The rounding happened: one bf16 pass is far off the exact product
    exact = cqt_mag(torch.from_numpy(audio), torch.from_numpy(kernel),
                    support, HOP, exact=True).numpy()
    peak = exact.max()
    assert np.abs(got - exact).max() / peak > 1e-4


def _passes_variant(audio, kernel, support, passes, acc=torch.float32):
    """The split contraction with the passes named in ``passes`` (of 'hh',
    'hl', 'lh'), summed in ``acc``: the plain 'high' takes all three."""

    frames = spectral.frame_signal(torch.from_numpy(audio), support, HOP)
    c_hi, c_lo = (p.to(acc) for p in split_bf16(frames))
    b_hi, b_lo = (p.to(acc) for p in split_bf16(torch.from_numpy(kernel)))
    pairs = {'hh': (c_hi, b_hi), 'hl': (c_hi, b_lo), 'lh': (c_lo, b_hi)}
    resp = sum(pairs[p][0] @ pairs[p][1] for p in passes).float()
    n = kernel.shape[-1] // 2
    return torch.sqrt(resp[..., :n] ** 2 + resp[..., n:] ** 2).transpose(
        -1, -2).numpy()


def test_high_tolerance_tells_the_passes_apart():
    """The 1e-5 bound that holds 'high' to its split (here, on the card and
    in ``chip_smoke.py``): the three passes summed in float64 stay within
    it; dropping hi*lo, dropping lo*hi or taking hi*hi alone exceeds it."""

    freqs, alpha = _bank(192, 24, 32.70319566257483)  # guitar recipe
    kernel, support = spectral.wavelet_bank(freqs, SR, alpha)
    audio = _tonal(2, SR // 2, seed=7)
    ref = cqt_mag_plain(torch.from_numpy(audio), torch.from_numpy(kernel),
                        support, HOP, exact='high').numpy()
    peak = ref.max()

    def error(passes, acc=torch.float32):
        got = _passes_variant(audio, kernel, support, passes, acc)
        return np.abs(got - ref).max() / peak

    assert error(('hh', 'hl', 'lh')) == 0.0
    assert error(('hh', 'hl', 'lh'), torch.float64) <= 1e-5
    for faulty in (('hh', 'lh'), ('hh', 'hl'), ('hh',)):
        assert error(faulty) > 1e-5, faulty


def _emulate_tensor_core_body(audio, bank, support, passes):
    """Kernel C's tensor-core body step for step, for every frame at once
    (its block tile changes no output's arithmetic): the taps in chunks of
    ``CHUNK_TAPS``; each chunk's patch and bank values split once as the
    chunk lands; then each 16-tap mma step forms hi*hi, hi*lo and lo*hi of
    its 16 taps, in that order, in a zeroed fragment, which one float32
    add joins to the accumulator."""

    frames = spectral.frame_signal(audio, support, HOP)
    acc = torch.zeros(frames.shape[:-1] + (bank.shape[-1],))
    for k0 in range(0, support, CHUNK_TAPS):
        p_hi, p_lo = (p.float() for p in split_bf16(
            frames[..., k0: k0 + CHUNK_TAPS]))
        b_hi, b_lo = (p.float() for p in split_bf16(
            bank[k0: k0 + CHUNK_TAPS]))
        for kk in range(0, p_hi.shape[-1], 16):
            step = slice(kk, kk + 16)
            part = p_hi[..., step] @ b_hi[step]
            if passes == 3:
                part = part + p_hi[..., step] @ b_lo[step]
                part = part + p_lo[..., step] @ b_hi[step]
            acc = acc + part
    n = bank.shape[-1] // 2
    return torch.sqrt(acc[..., :n] ** 2 + acc[..., n:] ** 2).transpose(-1, -2)


@pytest.mark.parametrize('exact,passes', [('high', 3), (False, 1)])
def test_tensor_core_emulation_matches_plain(exact, passes):
    """Kernels C and D's tensor-core route, emulated chunk for chunk, agree
    with the plain version of the same ``exact`` within 1e-5 of the peak,
    on the full bank and group by group."""

    freqs, alpha = _bank(80, 24)
    kernel, support = spectral.wavelet_bank(freqs, SR, alpha)
    stack, supports, bins = _stack(freqs, alpha, 32)
    audio = torch.from_numpy(_tonal(2, SR // 2, seed=8))

    got = _emulate_tensor_core_body(audio, torch.from_numpy(kernel), support,
                                    passes)
    ref = cqt_mag(audio, torch.from_numpy(kernel), support, HOP, exact=exact)
    _assert_close_to_peak(got.numpy(), ref.numpy(), 1e-5)

    parts, row0, gb = [], 0, stack.shape[1] // 2
    for sup, nb in zip(supports, bins):
        rows = torch.from_numpy(stack[row0: row0 + sup])
        bank = torch.cat([rows[:, :nb], rows[:, gb: gb + nb]], dim=1)
        parts.append(_emulate_tensor_core_body(audio, bank, sup, passes))
        row0 += sup
    ref = cqt_mag_grouped(audio, torch.from_numpy(stack), supports, bins, HOP,
                          exact=exact)
    _assert_close_to_peak(torch.cat(parts, dim=-2).numpy(), ref.numpy(), 1e-5)


def test_grouped_high_matches_pallas_grouped():
    freqs, alpha = _bank(80, 24)
    stack, supports, bins = _stack(freqs, alpha, 32)
    audio = _tonal(2, SR // 2, seed=9)

    got = cqt_mag_grouped(torch.from_numpy(audio), torch.from_numpy(stack),
                          supports, bins, HOP, exact='high').numpy()
    ref = np.stack([np.asarray(cqt_mag_pallas_grouped(
        jnp.asarray(clip), jnp.asarray(stack), supports, bins, HOP,
        exact='high', **PALLAS)) for clip in audio])
    _assert_close_to_peak(got, ref, 1e-5)


@pytest.mark.parametrize('n_bins,group_size', [(80, 32), (96, 32), (192, 64)])
def test_grouped_plain_matches_pallas_grouped_and_full_bank(n_bins,
                                                            group_size):
    """80 bins in groups of 32 -> 32, 32, 16: the last group is column
    padded to the widest, so a wrong per-group offset or centre shows."""

    bpo = 24
    freqs, alpha = _bank(n_bins, bpo, 100.0 if n_bins < 192 else 32.70319566)
    kernel, support = spectral.wavelet_bank(freqs, SR, alpha)
    stack, supports, bins = _stack(freqs, alpha, group_size)
    assert min(supports) < support  # the split dropped support tiles
    audio = _tonal(2, SR // 2, seed=3)

    got = cqt_mag_grouped(torch.from_numpy(audio), torch.from_numpy(stack),
                          supports, bins, HOP).numpy()
    full = cqt_mag(torch.from_numpy(audio), torch.from_numpy(kernel), support,
                   HOP).numpy()
    assert got.shape == full.shape == (2, n_bins, 1 + (SR // 2) // HOP)
    _assert_close_to_peak(got, full, 1e-5)

    if n_bins < 192:  # interpret mode at the recipe's support takes minutes
        ref = np.stack([np.asarray(cqt_mag_pallas_grouped(
            jnp.asarray(clip), jnp.asarray(stack), supports, bins, HOP,
            **PALLAS)) for clip in audio])
        _assert_close_to_peak(got, ref, 1e-5)


def test_grouped_plain_is_the_cpu_path():
    freqs, alpha = _bank(80, 24)
    stack, supports, bins = _stack(freqs, alpha, 32)
    audio = torch.from_numpy(_tonal(1, 6000, seed=4))

    launches = cqt_mag_grouped.launches
    np.testing.assert_array_equal(
        cqt_mag_grouped(audio, torch.from_numpy(stack), supports, bins,
                        HOP).numpy(),
        cqt_mag_grouped_plain(audio, torch.from_numpy(stack), supports, bins,
                              HOP).numpy())
    assert cqt_mag_grouped.launches == launches


def test_cqt_process_matches_jax():
    """The guitar recipe (192 bins at 24 per octave from C1, exact='high',
    grouped='auto'): the port runs the grouped plain version, JAX on the
    CPU the full-bank XLA contraction."""

    audio = _tonal(2, SR, seed=5)
    kw = dict(sample_rate=SR, hop_length=HOP, n_bins=192, bins_per_octave=24,
              exact='high', grouped='auto')
    port, ref = CQT(**kw), JaxCQT(**kw)
    assert port._groups is not None

    got = port.process(torch.from_numpy(audio)).numpy()
    want = np.asarray(ref.process_jax(jnp.asarray(audio)))

    assert got.shape == want.shape == (2, 1, 192, 1 + SR // HOP)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)

    # One clip without a batch axis, as process_jax takes it
    np.testing.assert_allclose(port.process(torch.from_numpy(audio[0])).numpy(),
                               got[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize('exact', [False, 'high'])
def test_cqt_process_on_cpu_contracts_in_float32(exact):
    """On the CPU the module contracts in IEEE float32 whatever ``exact``
    says, as the JAX class's XLA route does (``exact`` selects only the
    kernel's passes): the features equal those of ``exact=True`` bit for
    bit, and match JAX's ``process_jax`` in the same mode within the 2e-4
    that holds ``exact=True``. Passing ``exact=False`` on to the plain
    version put them 0.19 apart. Two float32 contractions in another order
    are themselves about 1.3e-4 apart here: the dB scale magnifies the
    relative error of the quietest bins."""

    audio = _tonal(2, SR, seed=10)
    kw = dict(sample_rate=SR, hop_length=HOP, n_bins=192, bins_per_octave=24,
              grouped='auto')
    got = CQT(exact=exact, **kw).process(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(
        got, CQT(exact=True, **kw).process(torch.from_numpy(audio)).numpy())
    want = np.asarray(JaxCQT(exact=exact, **kw).process_jax(
        jnp.asarray(audio)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize('kw', [dict(n_bins=192, bins_per_octave=24,
                                     grouped='auto'),
                                dict(n_bins=192, bins_per_octave=24,
                                     grouped=True, group_size=48),
                                dict(n_bins=96, bins_per_octave=24,
                                     grouped='auto'),
                                dict(n_bins=192, bins_per_octave=24,
                                     grouped=False),
                                dict(n_bins=80, bins_per_octave=24, fmin=100.0,
                                     grouped=True, group_size=32)])
def test_grouping_matches_jax(kw):
    """'auto' groups only when the split drops support tiles and there are
    at least two groups' worth of bins; the bank stack is bit for bit."""

    port, ref = CQT(sample_rate=SR, hop_length=HOP, **kw), \
        JaxCQT(sample_rate=SR, hop_length=HOP, **kw)

    np.testing.assert_array_equal(port._kernel, ref._kernel)
    assert port._support == ref._support
    assert (port._groups is None) == (ref._groups is None)
    if ref._groups is None:
        return

    assert port._group_supports == ref._group_supports
    assert port._group_bins == ref._group_bins
    assert sum(port._group_bins) == kw['n_bins']
    assert all(sup % 2048 == 0 for sup in port._group_supports)
    np.testing.assert_array_equal(port._bank_stack, ref._bank_stack)


def test_vqt_matches_jax():
    audio = _tonal(1, SR // 2, seed=6)
    kw = dict(sample_rate=SR, hop_length=HOP, n_bins=60, bins_per_octave=12,
              fmin=55.0)
    port, ref = VQT(**kw), JaxVQT(**kw)
    assert port.gamma == ref.gamma > 0

    np.testing.assert_allclose(port.process(torch.from_numpy(audio)).numpy(),
                               np.asarray(ref.process_jax(jnp.asarray(audio))),
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize('at_start', [False, True])
def test_get_times_matches_jax(at_start):
    kw = dict(sample_rate=SR, hop_length=HOP, n_bins=192, bins_per_octave=24)
    audio = np.zeros(SR + 123, dtype=np.float32)

    got = CQT(**kw).get_times(audio, at_start=at_start)
    want = JaxCQT(**kw).get_times(audio, at_start=at_start)

    np.testing.assert_array_equal(got, want)
    assert CQT(**kw).get_feature_size() == 192
    if at_start:
        assert got[0] < 0  # compensates the longest filter's latency


def test_nyquist_guard():
    with pytest.raises(ValueError, match='Nyquist'):
        CQT(sample_rate=8000, n_bins=120, bins_per_octave=12)


def test_wrappers_reject_bad_inputs():
    freqs, alpha = _bank()
    kernel, support = spectral.wavelet_bank(freqs, SR, alpha)
    bank = torch.from_numpy(kernel)
    audio = torch.zeros(2, 3000)

    with pytest.raises(ValueError):
        cqt_mag(audio[0], bank, support, HOP)
    with pytest.raises(TypeError):
        cqt_mag(audio.double(), bank, support, HOP)
    with pytest.raises(ValueError):
        cqt_mag(audio, bank, support + 2048, HOP)
    with pytest.raises(ValueError):
        cqt_mag(torch.zeros(3000, 2).t(), bank, support, HOP)

    stack, supports, bins = _stack(freqs, alpha, 32)
    stack = torch.from_numpy(stack)
    with pytest.raises(ValueError):
        cqt_mag_grouped(audio, stack, supports[:-1], bins, HOP)
    with pytest.raises(ValueError):
        cqt_mag_grouped(audio, stack, supports, bins[:-1], HOP)
    with pytest.raises(ValueError):
        cqt_mag_grouped(audio, stack, supports, (64,) + bins[1:], HOP)
