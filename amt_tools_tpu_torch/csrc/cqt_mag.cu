// Constant-Q / variable-Q magnitudes for Hopper (sm_90a), IEEE float32.
//
// Replaces: amt_tools_tpu/ops/pallas_cqt.py, _cqt_kernel (pallas_call in
// cqt_mag_pallas) and _cqt_grouped_kernel (pallas_call in
// cqt_mag_pallas_grouped). One kernel body serves both: the full bank is a
// table of one group. For clip b, frame t and bin k of group g:
//
//   re[b,k,t] = sum_m x[b, t*hop + m - support_g/2] * bank_g[m, k]
//   im[b,k,t] = sum_m x[b, t*hop + m - support_g/2] * bank_g[m, gb + k]
//   out[b, bin0_g + k, t] = sqrt(re^2 + im^2)
//
// with the audio zero outside [0, N) and T = 1 + N / hop frames. bank_g is
// rows row0_g .. row0_g + support_g of the (sum support_g, 2 * gb) bank
// stack, [cos | -sin] halves, column-padded to the widest group gb.
//
// What bounds it on this card: at the guitar serving shape (64 clips x 60 s
// at 22.05 kHz, hop 512, 192 bins, support 24,576) the full-bank
// contraction is 3.12 TFLOP, at least 46.6 ms on the float32 CUDA cores at
// 67 TFLOP/s; the support-grouped banks (24,576 / 4,096 / 2,048 rows for
// 64 bins each) cut it to 1.30 TFLOP, 19.5 ms. The bytes the function must
// move (0.34 GB of audio, the bank, 0.13 GB of magnitudes) take about
// 0.15 ms at 3.35 TB/s, and an FFT-based transform needs far fewer
// operations, so the function is bound by bytes while this contraction
// design is bound by operations.
//
// Design: an implicit GEMM, M = frames, N = 2 * bins, K = support.
//   - One block per (clip, 128 frames, group and 64 bins), 256 threads.
//     The grid's x axis walks the groups' bin tiles; a group's blocks walk
//     K = its own support only, from its own rows of the bank stack, and
//     centre their frames at its own support / 2.
//   - K is walked in chunks of 16 taps. Each chunk's frame patch
//     (128 frames x 16 taps) is copied straight from the audio into shared
//     memory by cp.async, zeros (a zero-byte source) standing in for the
//     centre padding: no frame matrix lands in device memory, and the
//     48-fold overlap of frames at hop 512 is served from L1/L2. A warp
//     copies 8 taps of 4 frames, so its 32 stores hit 32 banks.
//   - The bank slab (16 taps x 64 re + 64 im columns) is copied the same
//     way; the whole bank (37.7 MB full, 15.7 MB grouped) stays resident in
//     the 50 MB L2.
//   - Two buffers: the copies of chunk c + 1 are in flight while the block
//     computes chunk c, one barrier a chunk.
//   - Each thread keeps an 8-frame x 4-bin tile of re and im accumulators
//     (64 floats): frames 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3,
//     so a warp's float4 reads of the patch are contiguous; four 16-byte
//     shared loads feed 64 FMAs.
//   - Accumulation is IEEE fp32 FMA for exact=True and exact='high': no
//     TF32, because a single low-precision pass puts the quiet bins of
//     tonal audio tens of dB off (pallas_cqt.py explains the same trap on
//     the TPU). exact=False rounds the patch and the bank values to bf16 as
//     they leave shared memory and still sums in fp32: what one bf16
//     matrix-unit pass computes.
//   - Offsets into the audio, bank and output are 64-bit: 64 clips of
//     1.32 M samples and 31.7 M output values.
// Later work: three bf16 passes (hi/lo split) on wgmma fed by TMA for
// 'high', or an FFT-based transform, which the byte bound points to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 32;
constexpr int kTileFrames = 128;
constexpr int kTileBins = 64;
constexpr int kChunk = 16;
constexpr int kThreads = 256;
constexpr int kPatchStride = kTileFrames + 4;  // keeps float4 rows aligned
constexpr int kCopies = kTileFrames * kChunk / kThreads;  // 8 a thread

struct GroupTable {
  int tiles_per_group;         // bin tiles of kTileBins per group
  int support[kMaxGroups];     // taps (bank rows) of group g
  int bins[kMaxGroups];        // true bins of group g
  int bin0[kMaxGroups];        // first output row of group g
  long long row0[kMaxGroups];  // first bank-stack row of group g
};

struct Stage {
  float patch[kChunk][kPatchStride];
  float slab[kChunk][2 * kTileBins];
};

template <bool kRoundBf16>
__device__ __forceinline__ float operand(float v) {
  if (kRoundBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  return v;
}

// 4-byte asynchronous copy into shared memory; zero-filled when !valid
// (a zero-byte source reads nothing, so src need only be a valid address)
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool kRoundBf16>
__global__ void __launch_bounds__(kThreads, 2)
cqt_mag_kernel(const float* __restrict__ audio,
               const float* __restrict__ bank,
               float* __restrict__ out, const GroupTable table,
               int num_samples, int hop, int num_frames, int n_bins, int gb) {
  __shared__ __align__(16) Stage stages[2];

  const int group = blockIdx.x / table.tiles_per_group;
  const int b0 = (blockIdx.x % table.tiles_per_group) * kTileBins;
  const int t0 = blockIdx.y * kTileFrames;
  const int clip = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // frames 4 tx + {0..3} and 64 + 4 tx + {0..3}
  const int ty = tid / 16;  // bins 4 ty .. 4 ty + 3

  const int support = table.support[group];
  const int pad_left = support / 2;
  const int group_bins = table.bins[group];

  const float* x = audio + static_cast<size_t>(clip) * num_samples;
  const size_t bank_cols = 2 * static_cast<size_t>(gb);
  const float* w = bank + static_cast<size_t>(table.row0[group]) * bank_cols;

  // This thread's patch copies: tap pk of frames pf + 16 j, j < kCopies
  const int lane = tid % 32;
  const int pk = lane % 8 + 8 * ((tid / 32) % 2);
  const int pf = lane / 8 + 4 * (tid / 64);
  const long long first_sample =
      static_cast<long long>(t0 + pf) * hop + pk - pad_left;
  const long long frame_step = static_cast<long long>(16) * hop;
  // and its slab copies: column sc of taps sk + 2 j
  const int sc = tid % (2 * kTileBins);
  const int sk = tid / (2 * kTileBins);
  const int sbin = b0 + sc % kTileBins;
  const bool sbin_ok = sbin < group_bins;
  const int scol = sc < kTileBins ? sbin : gb + sbin;

  auto load_chunk = [&](int k0, Stage& st) {
    const bool tap_ok = k0 + pk < support;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int f = pf + 16 * j;
      const long long s = first_sample + j * frame_step + k0;
      const bool ok = tap_ok && t0 + f < num_frames && s >= 0 &&
                      s < num_samples;
      copy4(&st.patch[pk][f], ok ? x + s : x, ok);
    }
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int k = sk + 2 * j;
      const bool ok = sbin_ok && k0 + k < support;
      copy4(&st.slab[k][sc],
            ok ? w + static_cast<size_t>(k0 + k) * bank_cols + scol : w, ok);
    }
    copy_commit();
  };

  float re[4][8];
  float im[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  }

  load_chunk(0, stages[0]);
  const int num_chunks = (support + kChunk - 1) / kChunk;
  for (int c = 0; c < num_chunks; ++c) {
    copy_wait_all();
    // Chunk c is in shared memory, and every thread is done with c - 1,
    // whose buffer the next copies overwrite
    __syncthreads();
    if (c + 1 < num_chunks) {
      load_chunk((c + 1) * kChunk, stages[(c + 1) % 2]);
    }
    const Stage& st = stages[c % 2];

#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&st.patch[k][4 * tx]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&st.patch[k][64 + 4 * tx]);
      const float4 br = *reinterpret_cast<const float4*>(&st.slab[k][4 * ty]);
      const float4 bi =
          *reinterpret_cast<const float4*>(&st.slab[k][kTileBins + 4 * ty]);
      float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float rv[4] = {br.x, br.y, br.z, br.w};
      float iv[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) av[j] = operand<kRoundBf16>(av[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rv[i] = operand<kRoundBf16>(rv[i]);
        iv[i] = operand<kRoundBf16>(iv[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          re[i][j] = fmaf(av[j], rv[i], re[i][j]);
          im[i][j] = fmaf(av[j], iv[i], im[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int bin = b0 + 4 * ty + i;
    if (bin >= group_bins) continue;
    float* row = out + (static_cast<size_t>(clip) * n_bins +
                        table.bin0[group] + bin) * num_frames;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (t < num_frames) {
        row[t] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
      }
    }
  }
}

int launch(const float* audio, const float* bank, float* out, int batch,
           int num_samples, int hop, int num_frames, int n_bins, int gb,
           int num_groups, const int* supports, const int* bins,
           int round_bf16, cudaStream_t stream) {
  if (num_groups < 1 || num_groups > kMaxGroups || gb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  GroupTable table;
  table.tiles_per_group = (gb + kTileBins - 1) / kTileBins;
  long long row0 = 0;
  int bin0 = 0;
  for (int g = 0; g < num_groups; ++g) {
    table.support[g] = supports[g];
    table.bins[g] = bins[g];
    table.bin0[g] = bin0;
    table.row0[g] = row0;
    row0 += supports[g];
    bin0 += bins[g];
  }

  const dim3 grid(num_groups * table.tiles_per_group,
                  (num_frames + kTileFrames - 1) / kTileFrames, batch);
  if (round_bf16) {
    cqt_mag_kernel<true><<<grid, kThreads, 0, stream>>>(
        audio, bank, out, table, num_samples, hop, num_frames, n_bins, gb);
  } else {
    cqt_mag_kernel<false><<<grid, kThreads, 0, stream>>>(
        audio, bank, out, table, num_samples, hop, num_frames, n_bins, gb);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel C. audio (batch, num_samples), bank (support, 2 * n_bins), out
// (batch, n_bins, num_frames), all float32 and contiguous on the device.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int cqt_mag_f32(const float* audio, const float* bank, float* out,
                           int batch, int num_samples, int support, int hop,
                           int num_frames, int n_bins, int round_bf16,
                           cudaStream_t stream) {
  return launch(audio, bank, out, batch, num_samples, hop, num_frames, n_bins,
                n_bins, 1, &support, &n_bins, round_bf16, stream);
}

// Kernel D. bank_stack (sum(supports), 2 * gb): group g's rows follow
// group g-1's, columns [re | im] each padded to gb; supports and bins are
// host arrays of num_groups ints (at most 32). out (batch, sum(bins),
// num_frames). Launches on `stream` and returns cudaGetLastError().
extern "C" int cqt_mag_grouped_f32(const float* audio, const float* bank_stack,
                                   float* out, int batch, int num_samples,
                                   int hop, int num_frames, int n_bins, int gb,
                                   int num_groups, const int* supports,
                                   const int* bins, int round_bf16,
                                   cudaStream_t stream) {
  return launch(audio, bank_stack, out, batch, num_samples, hop, num_frames,
                n_bins, gb, num_groups, supports, bins, round_bf16, stream);
}
