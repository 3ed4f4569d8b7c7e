// STFT power spectrum for Hopper (sm_90a), IEEE float32.
//
// Replaces: amt_tools_tpu/ops/pallas_stft.py, _stft_kernel (pallas_call in
// stft_power_pallas). Same function, not the same blocking: frame the audio
// with centre padding, contract each frame against the windowed
// [cos | -sin] DFT bank (spectral.dft_bank, n_fft x 2*n_bins) and write
// re^2 + im^2 as (B, n_bins, T).
//
// What bounds it on this card: at the serving shape (128 clips x 60 s at
// 16 kHz, n_fft 2048, hop 512) the contraction is 2.02 TFLOP, about 30 ms
// on the float32 CUDA cores at 67 TFLOP/s, while the bytes it must move
// (0.49 GB of audio in, 0.98 GB of power out) take about 0.45 ms at
// 3.35 TB/s. It is bound by operations.
//
// Design: an implicit GEMM, M = frames, N = 2 * bins, K = n_fft.
//   - One block per (clip, 64 frames, 64 bins), 256 threads.
//   - K is walked in chunks of 16 taps. Each chunk's frame patch
//     (64 frames x 16 taps) is gathered straight from the audio into shared
//     memory, with zeros standing in for the centre padding: no frame matrix
//     ever lands in device memory, and the 4x overlap of frames at
//     hop = n_fft / 4 is served from L1/L2.
//   - The bank slice (16 taps x 64 re + 64 im columns) goes through shared
//     memory too; the whole bank (16.8 MB) stays resident in the 50 MB L2.
//   - Each thread keeps a 4-frame x 4-bin tile of re and im accumulators
//     (32 floats) and reads its operands as float4, three 16-byte shared
//     loads for 32 FMAs.
//   - Accumulation is IEEE fp32 FMA: no TF32, no bf16 pass, because a
//     single low-precision pass puts the quiet bins of tonal audio tens of
//     dB off (pallas_stft.py explains the same trap on the TPU).
//   - The hop is free: it need not divide n_fft nor be a multiple of 128.
// Later work: three bf16 passes (hi/lo split) on wgmma fed by TMA, and the
// mel projection and dB scaling fused into the epilogue.

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
