"""The port's STFT power wrapper vs the JAX package's fused Pallas STFT
kernel (interpret mode) and its FFT path, on the CPU.

On CPU tensors the wrapper runs its plain version, a framed float32 matmul
against the DFT bank; the Hopper kernel itself is held against that plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: 1e-4 relative, where "relative" is to each clip's peak power
(the sums differ in order from an FFT, and quiet bins carry an absolute
error set by the frame energy, not by their own value).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from amt_tools_tpu.ops import spectral as jspec
from amt_tools_tpu.ops.pallas_stft import split_bank_bf16, stft_power_pallas

from amt_tools_tpu_torch.ops import spectral
from amt_tools_tpu_torch.ops.stft_kernel import (fft_geometry, fft_tile_frames,
                                                 fft_twiddles, stft_power,
                                                 stft_power_plain, stft_route)

# The suite runs in several worker processes that share the cores
torch.set_num_threads(1)

RTOL_OF_PEAK = 1e-4


def _tonal(batch, num_samples, seed=0, sr=16000):
    rng = np.random.RandomState(seed)
    t = np.arange(num_samples) / sr
    clips = []
    for _ in range(batch):
        clips.append(sum(a * np.sin(2 * np.pi * f * t + p)
                         for a, f, p in zip(rng.rand(4) * 0.2 + 0.05,
                                            rng.rand(4) * 2000 + 100,
                                            rng.rand(4) * 6.28)))
    return np.stack(clips).astype(np.float32)


def _assert_close_to_peak(got, ref):
    peak = ref.reshape(ref.shape[0], -1).max(axis=1)[:, None, None]
    np.testing.assert_allclose(got / peak, ref / peak, atol=RTOL_OF_PEAK)


def _port(audio, n_fft, hop, center=True):
    bank = torch.from_numpy(spectral.dft_bank(n_fft))
    return stft_power(torch.from_numpy(audio), bank, n_fft, hop,
                      center=center).numpy()


def test_matches_pallas_kernel_interpret():
    n_fft, hop = 512, 128
    audio = _tonal(3, 16000)

    hi, lo = split_bank_bf16(jspec.dft_bank(n_fft))
    ref = np.asarray(stft_power_pallas(jnp.asarray(audio), hi, lo, n_fft, hop,
                                       block_t=8, interpret=True))
    got = _port(audio, n_fft, hop)

    assert got.shape == ref.shape == (3, 257, 126)
    _assert_close_to_peak(got, ref)


@pytest.mark.parametrize('n_fft,hop,center', [(512, 128, True),
                                              (400, 160, True),
                                              (512, 128, False)])
def test_matches_fft_power(n_fft, hop, center):
    audio = _tonal(2, 9001, seed=1)

    ref = np.asarray(jspec.stft_mag(jnp.asarray(audio), n_fft, hop,
                                    center=center)) ** 2
    got = _port(audio, n_fft, hop, center)

    assert got.shape == ref.shape
    _assert_close_to_peak(got, ref)


def test_plain_version_is_the_cpu_path():
    audio = torch.from_numpy(_tonal(2, 4000))
    bank = torch.from_numpy(spectral.dft_bank(256))
    launches = stft_power.launches

    np.testing.assert_array_equal(stft_power(audio, bank, 256, 64).numpy(),
                                  stft_power_plain(audio, bank, 256, 64).numpy())
    assert stft_power.launches == launches


def test_wrapper_rejects_bad_inputs():
    bank = torch.from_numpy(spectral.dft_bank(256))
    audio = torch.zeros(2, 1000)

    with pytest.raises(ValueError):
        stft_power(audio[0], bank, 256, 64)
    with pytest.raises(TypeError):
        stft_power(audio.double(), bank, 256, 64)
    with pytest.raises(ValueError):
        stft_power(audio, bank, 512, 64)
    with pytest.raises(ValueError):
        stft_power(torch.zeros(1000, 2).t(), bank, 256, 64)


# The FFT route of the card's kernel (csrc/stft_power.cu), emulated step for
# step in torch: the tests below hold its index arithmetic (the packing, the
# in-place radix-4/radix-2 passes over the twiddle table, the digit-reversed
# read-out and the real-input split) against the plain version and the
# Pallas kernel, at the n_fft the route takes.

def _digit_reverse(k, m):
    """Where the DIF passes leave frequency k: base-4 digits reversed."""

    pos, width = 0, m
    while width >= 4:
        width //= 4
        pos += (k & 3) * width
        k >>= 2
    if width == 2:
        pos += k & 1
    return pos


def _digit_reverse_bits(k, log2m):
    """The kernel's closed form of :func:`_digit_reverse` (``__brev``)."""

    bits = log2m & ~1
    low = k & ((1 << bits) - 1)
    pos = int(format(low, f'0{bits}b')[::-1], 2) if bits else 0
    pos = ((pos & 0x55555555) << 1) | ((pos >> 1) & 0x55555555)
    if log2m & 1:
        pos = 2 * pos + (k >> bits)
    return pos


@pytest.mark.parametrize('log2m', range(0, 13))
def test_closed_form_digit_reversal(log2m):
    m = 1 << log2m
    positions = [_digit_reverse_bits(k, log2m) for k in range(m)]
    assert positions == [_digit_reverse(k, m) for k in range(m)]
    assert sorted(positions) == list(range(m))


def _emulate_fft_route(audio, bank, n_fft, hop, center=True):
    """(B, N) float32 audio -> (B, n_bins, T) power, as the kernel's FFT
    route computes it, in complex64."""

    m = n_fft // 2
    window = bank[:, 0]
    frames = spectral.frame_signal(audio, n_fft, hop, center=center) * window
    z = torch.complex(frames[..., 0::2], frames[..., 1::2])  # (B, T, m)
    table = torch.from_numpy(fft_twiddles(n_fft))
    table = torch.complex(table[:, 0], table[:, 1])

    offset, width = 0, m
    lead = z.shape[:-1]
    while width >= 4:
        q = width // 4
        a = z.reshape(lead + (m // width, 4, q))
        a0, a1, a2, a3 = a.unbind(-2)
        s02, d02, s13, d13 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
        w1, w2, w3 = table[offset: offset + 3 * q].reshape(3, q)
        y = torch.stack([s02 + s13, (d02 - 1j * d13) * w1,
                         (s02 - s13) * w2, (d02 + 1j * d13) * w3], dim=-2)
        z = y.reshape(lead + (m,))
        offset += 3 * q
        width = q
    if width == 2:
        a = z.reshape(lead + (m // 2, 2))
        z = torch.stack([a[..., 0] + a[..., 1], a[..., 0] - a[..., 1]],
                        dim=-1).reshape(lead + (m,))

    # Bin pairs (k, m - k), k <= m/2: X[k] = E + W^k O, X[m-k] = conj(E - W^k O)
    k = np.arange(m // 2 + 1)
    rev = torch.tensor([_digit_reverse(int(i) % m, m) for i in k])
    rev_c = torch.tensor([_digit_reverse(int(m - i) % m, m) for i in k])
    zk, zc = z[..., rev], z[..., rev_c].conj()
    even, odd = 0.5 * (zk + zc), (zk - zc) / 2j
    wo = table[offset: offset + m // 2 + 1] * odd
    low, high = even + wo, even - wo
    spec = torch.cat([low, high[..., : m - m // 2].flip(-1)], dim=-1)

    return (spec.real ** 2 + spec.imag ** 2).transpose(-1, -2)


@pytest.mark.parametrize('n_fft', [2, 4, 8, 16, 32, 64, 128, 256, 512, 2048])
def test_digit_reversed_passes_give_the_fft(n_fft):
    """The packed complex FFT of the passes, split, equals numpy's rfft of
    the windowed frames, for both parities of log2(n_fft / 2)."""

    audio = _tonal(2, 3 * n_fft + 5, seed=2)
    bank = torch.from_numpy(spectral.dft_bank(n_fft))
    hop = max(1, n_fft // 4)

    got = _emulate_fft_route(torch.from_numpy(audio), bank, n_fft, hop).numpy()
    frames = spectral.frame_signal(torch.from_numpy(audio).double(), n_fft,
                                   hop).numpy()
    ref = np.abs(np.fft.rfft(frames * spectral.hann_window(n_fft), axis=-1))
    ref = (ref ** 2).transpose(0, 2, 1)

    assert got.shape == ref.shape
    _assert_close_to_peak(got, ref)


@pytest.mark.parametrize('n_fft,hop,center', [(512, 128, True),
                                              (256, 100, False),
                                              (2048, 512, True)])
def test_fft_route_emulation_matches_plain_and_pallas(n_fft, hop, center):
    audio = _tonal(2, 9001, seed=3)
    bank = torch.from_numpy(spectral.dft_bank(n_fft))

    got = _emulate_fft_route(torch.from_numpy(audio), bank, n_fft, hop,
                             center).numpy()
    plain = stft_power_plain(torch.from_numpy(audio), bank, n_fft, hop,
                             center).numpy()
    assert got.shape == plain.shape
    _assert_close_to_peak(got, plain)

    if center:
        hi, lo = split_bank_bf16(jspec.dft_bank(n_fft))
        ref = np.asarray(stft_power_pallas(jnp.asarray(audio), hi, lo, n_fft,
                                           hop, block_t=8, interpret=True))
        _assert_close_to_peak(got, ref)


def test_fft_route_reads_the_padded_window_from_the_bank():
    """The FFT route takes its window from the bank's bin-0 cosine column,
    which holds the window centre-padded to n_fft (win_length < n_fft)."""

    window = spectral.hann_window(300)
    bank = spectral.dft_bank(512, 300, window)
    padded = np.zeros(512, np.float32)
    padded[106: 406] = window

    np.testing.assert_array_equal(bank[:, 0], padded)

    audio = torch.from_numpy(_tonal(1, 6000, seed=4))
    got = _emulate_fft_route(audio, torch.from_numpy(bank), 512, 128).numpy()
    plain = stft_power_plain(audio, torch.from_numpy(bank), 512, 128).numpy()
    _assert_close_to_peak(got, plain)


@pytest.mark.parametrize('n_fft', [2, 16, 256, 2048, 4096])
def test_twiddle_table_matches_numpy_fft(n_fft):
    """Each entry is exp(-2 pi i k / L), the k-th DFT coefficient of a unit
    impulse at 1 (numpy.fft), rounded once to float32: within half a float32
    ulp of 1 (2^-25) of numpy's float64 value."""

    table = fft_twiddles(n_fft)
    m = n_fft // 2
    expected = []
    width = m
    while width >= 4:
        unit = np.fft.fft(np.eye(width)[1])
        j = np.arange(width // 4)
        expected += [unit[(j * mm) % width] for mm in (1, 2, 3)]
        width //= 4
    expected.append(np.fft.fft(np.eye(n_fft)[1])[: m // 2 + 1])
    expected = np.concatenate(expected)
    if len(expected) % 2:
        expected = np.append(expected, 0)

    assert table.dtype == np.float32 and table.shape == (len(expected), 2)
    np.testing.assert_allclose(table[:, 0], expected.real, rtol=0,
                               atol=2 ** -25)
    np.testing.assert_allclose(table[:, 1], expected.imag, rtol=0,
                               atol=2 ** -25)


@pytest.mark.parametrize('n_fft,hop,route', [
    (2048, 512, 'fft'), (512, 160, 'fft'), (256, 64, 'fft'),
    (4096, 1024, 'fft'), (8192, 2048, 'fft'), (16384, 512, 'dft'),
    (400, 160, 'dft'),
    (1000, 250, 'dft'), (32768, 512, 'dft')])
def test_route_by_n_fft(n_fft, hop, route):
    assert stft_route(n_fft, hop, n_fft // 2 + 1) == route
    # A bank with fewer bins than the full real DFT takes the DFT route
    assert stft_route(n_fft, hop, n_fft // 2) == 'dft'


@pytest.mark.parametrize('n_fft', [2, 4, 256, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize('hop', [1, 160, 512, 1024])
def test_fft_tile_fits_and_covers_every_frame_once(n_fft, hop):
    tile = fft_tile_frames(n_fft, hop)
    assert tile >= 1 and tile & (tile - 1) == 0
    assert fft_geometry(n_fft, hop, tile)['bytes'] <= 232448
    if tile < 8:
        assert fft_geometry(n_fft, hop, 2 * tile)['bytes'] > 232448

    for num_frames in (1, tile - 1, tile, 5 * tile + 3):
        if num_frames < 1:
            continue
        blocks = -(-num_frames // tile)
        cover = np.zeros(num_frames, int)
        for block in range(blocks):
            t = block * tile + np.arange(tile)
            np.add.at(cover, t[t < num_frames], 1)
        assert (cover == 1).all()

    # The span holds every sample of the tile's frames after any lead; a
    # frame's buffer holds its m values with one padding value after every
    # 8 (the kernel's pad(i) = i + i // 8)
    geo = fft_geometry(n_fft, hop, tile)
    assert geo['span_len'] % 4 == 0
    assert geo['span_len'] >= 3 + (tile - 1) * hop + n_fft
    m = n_fft // 2
    assert geo['frame_pad'] > (m - 1) + (m - 1) // 8
    assert geo['z_count'] >= tile * geo['frame_pad'] and geo['n_tw'] % 2 == 0
    assert geo['bytes'] == 8 * (geo['z_count'] + geo['n_tw']) + \
        4 * geo['span_len']


def test_serving_shape_takes_the_fft_route_in_whole_sectors():
    """n_fft 2048 at hop 512: 8 frames a block (a 32-byte sector a bin row)
    in under half of an SM's shared memory, so two blocks share an SM."""

    assert stft_route(2048, 512, 1025) == 'fft'
    assert fft_tile_frames(2048, 512) == 8
    geo = fft_geometry(2048, 512, 8)
    assert geo['z_count'] == 8 * (1024 + 128 + 1)
    assert 2 * (geo['bytes'] + 1024) <= 233472
