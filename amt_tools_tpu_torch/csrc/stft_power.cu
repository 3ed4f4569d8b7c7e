// STFT power spectrum for Hopper (sm_90a), IEEE float32.
//
// Replaces: amt_tools_tpu/ops/pallas_stft.py, _stft_kernel (pallas_call in
// stft_power_pallas). Same function, not the same blocking: frame the audio
// with centre padding, window each frame, take its real DFT and write
// re^2 + im^2 as (B, n_bins, T), n_bins = n_fft / 2 + 1.
//
// What bounds it on this card: at the serving shape (128 clips x 60 s at
// 16 kHz, n_fft 2048, hop 512) the bytes it must move (0.49 GB of audio in,
// 0.98 GB of power out) take about 0.45 ms at 3.35 TB/s, while an FFT of
// every frame needs about 15 GFLOP, 0.22 ms at 67 TFLOP/s. It is bound by
// bytes. A DFT written as a matmul does 2.02 TFLOP there, at least 30 ms on
// the float32 cores: the algorithm, not the tiling, decides.
//
// Two routes, chosen by shape in the wrapper (ops/stft_kernel.py):
//
// FFT route, power-of-two n_fft whose buffers fit (stft_power_fft_f32):
//   - One block per (clip, tile of F consecutive frames), 512 threads;
//     F = 8 at n_fft 2048, so two blocks share an SM.
//   - The audio the tile covers, (F - 1) * hop + n_fft samples, is read
//     once into shared memory with 16-byte loads, zeros standing in for
//     the centre padding; the 4x overlap of frames at hop = n_fft / 4 is
//     served from there.
//   - Each frame's real FFT of n_fft points is an n_fft / 2-point complex
//     FFT of z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], the window w being the
//     bank's bin-0 cosine column: decimation-in-frequency radix-4 passes in
//     place in shared memory (one radix-2 pass where log2 is odd), a
//     __syncthreads between passes. A padding value follows every 8 complex
//     values of a frame, so the strided butterflies of the late passes
//     spread over the banks, and frames sit one complex value apart modulo
//     the banks, so the transposed reads below do not conflict.
//   - The twiddles are a float32 table built on the host in float64 and
//     rounded once (stft_kernel.fft_twiddles), copied to shared memory:
//     per pass W_L^(j m) for m = 1..3, contiguous in j, then W_N^k for
//     k <= n_fft / 4. No __sinf / __cosf.
//   - The split into the n_fft / 2 + 1 real-input bins, with its
//     post-twiddle and re^2 + im^2, takes bins k and n_fft / 2 - k from the
//     same two digit-reversed outputs (the reversal in closed form, by
//     __brev), consecutive threads on consecutive frames, so the bin-major,
//     frame-minor output (B, n_bins, T) is written in runs of F frames.
//   - Arithmetic is IEEE float32 FMA throughout: no TF32, no bf16 pass.
//
// DFT route, any other n_fft (stft_power_f32): an implicit GEMM,
// M = frames, N = 2 * bins, K = n_fft, against the windowed [cos | -sin]
// bank (spectral.dft_bank):
//   - One block per (clip, 64 frames, 64 bins), 256 threads.
//   - K is walked in chunks of 16 taps. Each chunk's frame patch
//     (64 frames x 16 taps) is gathered straight from the audio into shared
//     memory, with zeros standing in for the centre padding.
//   - The bank slice (16 taps x 64 re + 64 im columns) goes through shared
//     memory too.
//   - Each thread keeps a 4-frame x 4-bin tile of re and im accumulators
//     (32 floats) and reads its operands as float4, three 16-byte shared
//     loads for 32 FMAs, in IEEE fp32.
// Both routes take any hop: it need not divide n_fft.
// Later work: the mel projection and dB scaling fused into the FFT route's
// epilogue, so only the (B, n_mels, T) features reach device memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileFrames = 64;
constexpr int kTileBins = 64;
constexpr int kChunk = 16;
constexpr int kThreads = 256;
constexpr int kPatchStride = kTileFrames + 4;  // keeps float4 rows aligned

__global__ void __launch_bounds__(kThreads)
stft_power_kernel(const float* __restrict__ audio,
                  const float* __restrict__ bank,
                  float* __restrict__ out,
                  int num_samples, int n_fft, int hop, int pad_left,
                  int num_frames, int n_bins) {
  __shared__ __align__(16) float patch[kChunk][kPatchStride];
  __shared__ __align__(16) float slab[kChunk][2 * kTileBins];

  const int clip = blockIdx.z;
  const int t0 = blockIdx.y * kTileFrames;
  const int b0 = blockIdx.x * kTileBins;
  const int tx = threadIdx.x % 16;  // frames 4 * tx .. 4 * tx + 3
  const int ty = threadIdx.x / 16;  // bins 4 * ty .. 4 * ty + 3

  const float* x = audio + static_cast<size_t>(clip) * num_samples;
  const size_t bank_cols = 2 * static_cast<size_t>(n_bins);

  float re[4][4];
  float im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < n_fft; k0 += kChunk) {
    // Frame patch: consecutive threads read consecutive taps of one frame
    for (int e = threadIdx.x; e < kTileFrames * kChunk; e += kThreads) {
      const int k = e % kChunk;
      const int f = e / kChunk;
      const int t = t0 + f;
      const long long s = static_cast<long long>(t) * hop + k0 + k - pad_left;
      float v = 0.f;
      if (t < num_frames && k0 + k < n_fft && s >= 0 && s < num_samples) {
        v = x[s];
      }
      patch[k][f] = v;
    }
    // Bank slab: [re bins b0.. | im bins b0..] for taps k0..k0+15
    for (int e = threadIdx.x; e < kChunk * 2 * kTileBins; e += kThreads) {
      const int k = e / (2 * kTileBins);
      const int c = e % (2 * kTileBins);
      const int bin = b0 + c % kTileBins;
      const int col = c < kTileBins ? bin : n_bins + bin;
      float v = 0.f;
      if (bin < n_bins && k0 + k < n_fft) {
        v = bank[static_cast<size_t>(k0 + k) * bank_cols + col];
      }
      slab[k][c] = v;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&patch[k][4 * tx]);
      const float4 br = *reinterpret_cast<const float4*>(&slab[k][4 * ty]);
      const float4 bi =
          *reinterpret_cast<const float4*>(&slab[k][kTileBins + 4 * ty]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float rv[4] = {br.x, br.y, br.z, br.w};
      const float iv[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(av[j], rv[i], re[i][j]);
          im[i][j] = fmaf(av[j], iv[i], im[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bin = b0 + 4 * ty + i;
    if (bin >= n_bins) continue;
    float* row = out + (static_cast<size_t>(clip) * n_bins + bin) * num_frames;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + 4 * tx + j;
      if (t < num_frames) {
        row[t] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// FFT route

constexpr int kFftThreads = 512;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most a block may use
constexpr int kPadShift = 3;  // a padding value after every 8 of a frame

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// Position of frequency k (0 <= k < m = 2^log2m) after the in-place DIF
// passes (radix 4 while the span is at least 4, then one radix 2): the
// first pass's output quarter holds the lowest base-4 digit of k, and so
// on down. So the low 2p bits of k, p = log2m / 2, are reversed as base-4
// digits (a bit reversal, then each pair of bits swapped back), and where
// log2m is odd the position doubles and takes k's top bit.
__device__ __forceinline__ int digit_reverse(int k, int log2m) {
  const int bits = log2m & ~1;
  const unsigned low = static_cast<unsigned>(k) & ((1u << bits) - 1);
  unsigned pos = bits ? __brev(low) >> (32 - bits) : 0u;
  pos = ((pos & 0x55555555u) << 1) | ((pos >> 1) & 0x55555555u);
  if (log2m & 1) pos = 2 * pos + (static_cast<unsigned>(k) >> bits);
  return static_cast<int>(pos);
}

__device__ __forceinline__ int log2_int(int v) { return 31 - __clz(v); }

// Position of complex value i of a frame: one padding value after every 8,
// so the strided butterflies of the late passes spread over the banks
__device__ __forceinline__ int pad(int i) { return i + (i >> kPadShift); }

__global__ void __launch_bounds__(kFftThreads)
stft_power_fft_kernel(const float* __restrict__ audio,
                      const float* __restrict__ window,
                      const float2* __restrict__ twiddles,
                      float* __restrict__ out, int num_samples, int n_fft,
                      int hop, int pad_left, int num_frames, int n_bins,
                      int tile_frames, int frame_pad, int z_count, int n_tw,
                      int span_len) {
  extern __shared__ float4 smem4[];
  const int m = n_fft / 2;
  const int log2m = log2_int(m);
  const int log2f = log2_int(tile_frames);
  float2* z = reinterpret_cast<float2*>(smem4);
  float2* tw = z + z_count;
  float* span = reinterpret_cast<float*>(tw + n_tw);

  const int tid = threadIdx.x;
  const int clip = blockIdx.y;
  const int t0 = blockIdx.x * tile_frames;
  const float* x = audio + static_cast<size_t>(clip) * num_samples;

  // The tile's audio from sample s0 on, started at the 16-byte boundary at
  // or before it (`lead` floats earlier)
  const long long s0 = static_cast<long long>(t0) * hop - pad_left;
  const long long flat0 = static_cast<long long>(clip) * num_samples + s0;
  const int lead = static_cast<int>(((flat0 % 4) + 4) % 4);
  const long long sa = s0 - lead;
  const bool vec = (reinterpret_cast<uintptr_t>(audio) & 15) == 0;
  for (int q = tid; q < span_len / 4; q += blockDim.x) {
    const long long s = sa + 4 * q;
    float4 v;
    if (vec && s >= 0 && s + 3 < num_samples) {
      v = __ldg(reinterpret_cast<const float4*>(x + s));
    } else {
      v.x = (s >= 0 && s < num_samples) ? x[s] : 0.f;
      v.y = (s + 1 >= 0 && s + 1 < num_samples) ? x[s + 1] : 0.f;
      v.z = (s + 2 >= 0 && s + 2 < num_samples) ? x[s + 2] : 0.f;
      v.w = (s + 3 >= 0 && s + 3 < num_samples) ? x[s + 3] : 0.f;
    }
    reinterpret_cast<float4*>(span)[q] = v;
  }
  for (int q = tid; q < n_tw / 2; q += blockDim.x) {
    reinterpret_cast<float4*>(tw)[q] =
        __ldg(reinterpret_cast<const float4*>(twiddles) + q);
  }
  __syncthreads();

  // Pack: z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1] for each frame
  for (int idx = tid; idx < tile_frames * m; idx += blockDim.x) {
    const int f = idx >> log2m;
    const int n = idx & (m - 1);
    const int s = lead + f * hop + 2 * n;
    const float2 w = __ldg(reinterpret_cast<const float2*>(window) + n);
    z[f * frame_pad + pad(n)] =
        make_float2(span[s] * w.x, span[s + 1] * w.y);
  }

  // Decimation in frequency, radix 4, in place
  int tw_off = 0;
  int width = m;  // the span of this pass's sub-transforms
  const int butterflies = tile_frames * (m >> 2);
  for (; width >= 4; width >>= 2) {
    __syncthreads();
    const int quarter = width >> 2;
    const float2* w1 = tw + tw_off;
    const float2* w2 = w1 + quarter;
    const float2* w3 = w2 + quarter;
    for (int b = tid; b < butterflies; b += blockDim.x) {
      const int f = b >> (log2m - 2);
      const int q = b & ((m >> 2) - 1);
      const int j = q & (quarter - 1);
      float2* p = z + f * frame_pad;
      const int e = ((q - j) << 2) + j;
      const int i0 = pad(e);
      const int i1 = pad(e + quarter);
      const int i2 = pad(e + 2 * quarter);
      const int i3 = pad(e + 3 * quarter);
      const float2 a0 = p[i0];
      const float2 a1 = p[i1];
      const float2 a2 = p[i2];
      const float2 a3 = p[i3];
      const float2 s02 = make_float2(a0.x + a2.x, a0.y + a2.y);
      const float2 d02 = make_float2(a0.x - a2.x, a0.y - a2.y);
      const float2 s13 = make_float2(a1.x + a3.x, a1.y + a3.y);
      const float2 d13 = make_float2(a1.x - a3.x, a1.y - a3.y);
      p[i0] = make_float2(s02.x + s13.x, s02.y + s13.y);
      p[i1] = cmul(make_float2(d02.x + d13.y, d02.y - d13.x), w1[j]);
      p[i2] = cmul(make_float2(s02.x - s13.x, s02.y - s13.y), w2[j]);
      p[i3] = cmul(make_float2(d02.x - d13.y, d02.y + d13.x), w3[j]);
    }
    tw_off += 3 * quarter;
  }
  if (width == 2) {  // log2(m) odd: one radix-2 pass, no twiddles
    __syncthreads();
    for (int b = tid; b < tile_frames * (m >> 1); b += blockDim.x) {
      const int f = b >> (log2m - 1);
      const int q = b & ((m >> 1) - 1);
      float2* p = z + f * frame_pad;
      const int i0 = pad(2 * q);
      const int i1 = pad(2 * q + 1);
      const float2 a = p[i0];
      const float2 c = p[i1];
      p[i0] = make_float2(a.x + c.x, a.y + c.y);
      p[i1] = make_float2(a.x - c.x, a.y - c.y);
    }
  }
  __syncthreads();

  // Split into real-input bins, power, and write bin-major: consecutive
  // threads take consecutive frames of one bin pair (k, m - k)
  const float2* split = tw + tw_off;
  for (int idx = tid; idx < ((m >> 1) + 1) * tile_frames;
       idx += blockDim.x) {
    const int f = idx & (tile_frames - 1);
    const int k = idx >> log2f;
    const int t = t0 + f;
    if (t >= num_frames) continue;
    const float2* zf = z + f * frame_pad;
    const float2 zk = zf[pad(digit_reverse(k & (m - 1), log2m))];
    const float2 zc = zf[pad(digit_reverse((m - k) & (m - 1), log2m))];
    // X[k] = E + W_N^k O and X[m - k] = conj(E - W_N^k O), where
    // E = (Z[k] + conj Z[m-k]) / 2 and O = (Z[k] - conj Z[m-k]) / 2i
    const float2 even = make_float2(0.5f * (zk.x + zc.x),
                                    0.5f * (zk.y - zc.y));
    const float2 odd = make_float2(0.5f * (zk.y + zc.y),
                                   -0.5f * (zk.x - zc.x));
    const float2 wo = cmul(split[k], odd);
    float* plane = out + static_cast<size_t>(clip) * n_bins * num_frames + t;
    const float re = even.x + wo.x;
    const float im = even.y + wo.y;
    plane[static_cast<size_t>(k) * num_frames] = fmaf(re, re, im * im);
    if (2 * k != m) {
      const float re_c = even.x - wo.x;
      const float im_c = even.y - wo.y;
      plane[static_cast<size_t>(m - k) * num_frames] =
          fmaf(re_c, re_c, im_c * im_c);
    }
  }
}

}  // namespace

// audio (batch, num_samples), bank (n_fft, 2 * n_bins), out
// (batch, n_bins, num_frames), all float32 and contiguous on the device.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int stft_power_f32(const float* audio, const float* bank,
                              float* out, int batch, int num_samples,
                              int n_fft, int hop, int pad_left,
                              int num_frames, int n_bins,
                              cudaStream_t stream) {
  const dim3 grid((n_bins + kTileBins - 1) / kTileBins,
                  (num_frames + kTileFrames - 1) / kTileFrames, batch);
  stft_power_kernel<<<grid, kThreads, 0, stream>>>(
      audio, bank, out, num_samples, n_fft, hop, pad_left, num_frames,
      n_bins);
  return static_cast<int>(cudaGetLastError());
}

// The FFT route. audio (batch, num_samples), window (n_fft) (the bank's
// bin-0 cosine column), twiddles (n_tw, 2) from stft_kernel.fft_twiddles,
// out (batch, n_fft / 2 + 1, num_frames), all float32 and contiguous on the
// device. n_fft is a power of two and tile_frames a power of two. The
// block's shared-memory layout is the wrapper's (stft_kernel.fft_geometry):
// frames of frame_pad complex values (m + m / 8 + 1, for `pad`), z_count
// of them in all, then the n_tw twiddles, then span_len audio floats,
// smem_bytes in all, within 227 KB. Launches on `stream` and returns the
// first CUDA error of the set-up or the launch.
extern "C" int stft_power_fft_f32(const float* audio, const float* window,
                                  const float* twiddles, float* out,
                                  int batch, int num_samples, int n_fft,
                                  int hop, int pad_left, int num_frames,
                                  int tile_frames, int frame_pad, int z_count,
                                  int n_tw, int span_len, int smem_bytes,
                                  cudaStream_t stream) {
  if (n_fft < 2 || (n_fft & (n_fft - 1)) || tile_frames < 1 ||
      (tile_frames & (tile_frames - 1)) || smem_bytes > kMaxSharedBytes ||
      z_count < tile_frames * frame_pad || n_tw % 2 || span_len % 4 ||
      smem_bytes < 8 * (z_count + n_tw) + 4 * span_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t status = cudaFuncSetAttribute(
      stft_power_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (status != cudaSuccess) return static_cast<int>(status);

  const dim3 grid((num_frames + tile_frames - 1) / tile_frames, batch);
  stft_power_fft_kernel<<<grid, kFftThreads, smem_bytes, stream>>>(
      audio, window, reinterpret_cast<const float2*>(twiddles), out,
      num_samples, n_fft, hop, pad_left, num_frames, n_fft / 2 + 1,
      tile_frames, frame_pad, z_count, n_tw, span_len);
  return static_cast<int>(cudaGetLastError());
}
