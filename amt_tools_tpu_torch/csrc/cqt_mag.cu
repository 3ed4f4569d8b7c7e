// Constant-Q / variable-Q magnitudes for Hopper (sm_90a).
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
// 64 bins each) cut it to 1.30 TFLOP, 19.5 ms. As three bf16 tensor-core
// passes the grouped contraction is 3.9 TFLOP, at least 3.9 ms at
// 989 TFLOP/s (9.5 ms for the full bank). The bytes the function must
// move (0.34 GB of audio, the bank, 0.13 GB of magnitudes) take about
// 0.15 ms at 3.35 TB/s, and an FFT-based transform needs far fewer
// operations, so the function is bound by bytes while this contraction
// design is bound by operations.
//
// Two bodies, chosen by the route of `exact` (ops/cqt_kernel.py cqt_route):
//
// 'high' and False: the tensor-core body (cqt_mag_tc_kernel), the TPU
// kernel's own arithmetic (pallas_cqt.py _contract_tile). An implicit GEMM,
// M = frames, N = the re and im columns of 64 bins, K = taps.
//   - One block per (group, 64-bin tile, clip, 256 frames), 8 warps. The
//     grid is one axis over a table that puts the groups in falling support:
//     a group-0 block walks 24,576 taps, a group-2 block 2,048, so the heavy
//     blocks start first and the light ones fill the last wave.
//   - K in chunks of 32 taps. Each chunk's patch (256 frames x 32 taps)
//     and bank slab (32 taps x 128 columns) are copied as float32 by
//     cp.async into a staging buffer, 16 bytes a copy where the hop, the
//     centre and the row lengths allow it (4 bytes otherwise), with a
//     zero-byte (or short) source for the centre padding, the taps past a
//     group's support and the bins past its width.
//   - Once a chunk has landed, every float32 value is split once into
//     hi = bf16(x) and lo = bf16(x - hi), round to nearest even, into bf16
//     tiles: each patch value feeds both bin halves of every warp and each
//     bank value every frame tile, so splitting per fragment would repeat
//     the work 2 to 4 times.
//   - mma.sync m16n8k16 bf16 with float32 accumulation: each warp owns 64
//     frames x 32 bins (their re and im columns: 4 m-tiles x 8 n-tiles,
//     128 accumulators a thread). Every 16-tap step forms hi*hi, hi*lo,
//     lo*hi ('high') or hi*hi (False) in a zeroed fragment and adds it to
//     the accumulator by an IEEE float32 add. The tensor cores add their
//     terms to the accumulator operand with truncation, so passes chained
//     into one running sum over 24,576 taps drift from the round-to-nearest
//     sum (2.5e-5 of the clip peak against the plain version on the card;
//     the float32 route is within 1e-7); a zeroed fragment keeps that
//     truncation at the size of one step's terms. A fragments
//     by ldmatrix from the frame-major patch, B by ldmatrix.trans from the
//     tap-major slab; rows padded by 16 bytes so the 8 row addresses of an
//     ldmatrix hit 32 different banks.
//   - Registers bound the tile: the 128 accumulators and the hi and lo
//     fragments take all 255 of a thread's registers (ptxas spills a few
//     bytes), so a block of 8 such warps (256 threads) is the most an SM
//     holds, and a wider warp tile would spill. The block's shared memory
//     (two staging buffers, two split buffers: 210 KB) fits the same one
//     block an SM. (128 frames and 16-tap chunks, two blocks an SM, were
//     no faster on an H100.)
//   - Pipelining with one barrier a chunk: after the barrier the block
//     issues the copies of chunk c + 2, splits chunk c + 1 and runs the
//     mma of chunk c, whose split happened before the barrier.
//   - The magnitude sqrt(re^2 + im^2) is taken in the registers that hold
//     re and im of one bin and frame.
//
// True: the IEEE float32 FMA body (cqt_mag_kernel): no TF32, because a
// single low-precision pass puts the quiet bins of tonal audio tens of dB
// off (pallas_cqt.py explains the same trap on the TPU).
//   - One block per (clip, 128 frames, group and 64 bins), 256 threads;
//     the grid's x axis walks the groups' bin tiles.
//   - K in chunks of 16 taps, copied by cp.async into two buffers (the
//     copies of chunk c + 1 in flight while chunk c computes), zero-byte
//     sources standing in for the centre padding. A warp copies 8 taps of
//     4 frames, so its 32 stores hit 32 banks.
//   - Each thread keeps an 8-frame x 4-bin tile of re and im accumulators
//     (64 floats), frames 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3,
//     so a warp's float4 reads of the patch are contiguous.
//
// In both, a group's blocks walk K = its own support only, from its own
// rows of the bank stack, centre their frames at its own support / 2, and
// read the audio straight from device memory: no frame matrix lands there,
// and the 48-fold overlap of frames at hop 512 is served from L1/L2, the
// whole bank (37.7 MB full, 15.7 MB grouped) from the 50 MB L2. Offsets
// into the audio, bank and output are 64-bit: 64 clips of 1.32 M samples
// and 31.7 M output values.
// Later work: wgmma fed by TMA (every group's centre is a multiple of hop
// 512, so a block's patch is a box of the audio viewed as rows of hop
// samples), then an FFT-based transform, which the byte bound points to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxGroups = 32;
constexpr int kMaxSharedBytes = 232448;

struct GroupTable {
  int num_groups;
  int tiles_per_group;         // bin tiles per group
  int support[kMaxGroups];     // taps (bank rows) of group g
  int bins[kMaxGroups];        // true bins of group g
  int bin0[kMaxGroups];        // first output row of group g
  long long row0[kMaxGroups];  // first bank-stack row of group g
  // The tensor-core body's launch order: slot s runs group order[s], whose
  // blocks start at first_block[s]
  int order[kMaxGroups];
  int first_block[kMaxGroups];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy into shared memory; zero-filled when !valid
// (a zero-byte source reads nothing, so src need only be a valid address)
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16-byte asynchronous copy of the first `bytes` (0..16) bytes; the rest
// of the 16 is zero-filled
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------------------
// exact=True: IEEE float32 FMAs

constexpr int kTileFrames = 128;
constexpr int kTileBins = 64;
constexpr int kChunk = 16;
constexpr int kThreads = 256;
constexpr int kPatchStride = kTileFrames + 4;  // keeps float4 rows aligned
constexpr int kCopies = kTileFrames * kChunk / kThreads;  // 8 a thread

struct Stage {
  float patch[kChunk][kPatchStride];
  float slab[kChunk][2 * kTileBins];
};

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
    copy_wait<0>();
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
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rv[4] = {br.x, br.y, br.z, br.w};
      const float iv[4] = {bi.x, bi.y, bi.z, bi.w};
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

// ---------------------------------------------------------------------------
// exact='high' and False: bf16 passes of a hi/lo split on the tensor cores

constexpr int kTcFrames = 256;
constexpr int kTcBins = 64;
constexpr int kTcCols = 2 * kTcBins;  // re | im
constexpr int kTcChunk = 32;
constexpr int kTcWarpsM = kTcFrames / 64;       // warps along the frames
constexpr int kTcThreads = 32 * kTcWarpsM * 2;  // and 2 along the bins
constexpr int kTcPieces = kTcChunk / 4;         // 16-byte pieces a frame
constexpr int kTcPatchStride = kTcChunk + 8;  // bf16, +16 bytes a row
constexpr int kTcSlabStride = kTcCols + 8;

struct TcStage {  // float32 as copied
  float patch[kTcFrames * kTcChunk];  // frame-major
  float slab[kTcChunk * kTcCols];     // tap-major
};

struct TcSplit {  // bf16 hi and lo
  __nv_bfloat16 patch_hi[kTcFrames * kTcPatchStride];
  __nv_bfloat16 patch_lo[kTcFrames * kTcPatchStride];
  __nv_bfloat16 slab_hi[kTcChunk * kTcSlabStride];
  __nv_bfloat16 slab_lo[kTcChunk * kTcSlabStride];
};

constexpr size_t kTcSharedBytes = 2 * sizeof(TcStage) + 2 * sizeof(TcSplit);
static_assert(kTcSharedBytes <= kMaxSharedBytes, "tile exceeds shared memory");

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Not volatile: a pure function of its registers, which the compiler may
// interleave with the independent mma around it
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// Split four float32 values into their bf16 hi and lo, 8 bytes each
__device__ __forceinline__ void split4(float4 v, __nv_bfloat16* hi,
                                       __nv_bfloat16* lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f01 = __bfloat1622float2(h01);
  const float2 f23 = __bfloat1622float2(h23);
  *reinterpret_cast<uint2*>(hi) = make_uint2(bits(h01), bits(h23));
  *reinterpret_cast<uint2*>(lo) = make_uint2(
      bits(__floats2bfloat162_rn(v.x - f01.x, v.y - f01.y)),
      bits(__floats2bfloat162_rn(v.z - f23.x, v.w - f23.y)));
}

template <int kPasses>
__global__ void __launch_bounds__(kTcThreads, 1)
cqt_mag_tc_kernel(const float* __restrict__ audio,
                  const float* __restrict__ bank, float* __restrict__ out,
                  const GroupTable table, int batch, int num_samples, int hop,
                  int num_frames, int n_bins, int gb, int wide_patch,
                  int wide_slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  TcStage* raw = reinterpret_cast<TcStage*>(smem);
  TcSplit* split = reinterpret_cast<TcSplit*>(smem + 2 * sizeof(TcStage));

  // The block's group (slot in the launch order), clip, bin and frame tile
  int slot = 0;
  while (slot + 1 < table.num_groups &&
         static_cast<int>(blockIdx.x) >= table.first_block[slot + 1]) {
    ++slot;
  }
  const int group = table.order[slot];
  const int frame_tiles = (num_frames + kTcFrames - 1) / kTcFrames;
  int local = blockIdx.x - table.first_block[slot];
  const int t0 = (local % frame_tiles) * kTcFrames;
  local /= frame_tiles;
  const int clip = local % batch;
  const int b0 = (local / batch) * kTcBins;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % kTcWarpsM;  // frames 64 wm .. 64 wm + 63
  const int wn = warp / kTcWarpsM;  // bins 32 wn .. 32 wn + 31 of the tile

  const int support = table.support[group];
  const int pad_left = support / 2;
  const int group_bins = table.bins[group];
  const float* x = audio + static_cast<size_t>(clip) * num_samples;
  const size_t bank_cols = 2 * static_cast<size_t>(gb);
  const float* w = bank + static_cast<size_t>(table.row0[group]) * bank_cols;
  const bool wide_x = wide_patch && pad_left % 4 == 0;

  auto load_chunk = [&](int k0, TcStage& st) {
    if (wide_x) {
      // 8 pieces of 4 taps a frame; neighbouring threads, neighbouring
      // pieces of one frame
#pragma unroll
      for (int j = 0; j < kTcFrames * kTcChunk / 4 / kTcThreads; ++j) {
        const int idx = tid + kTcThreads * j;
        const int f = idx / kTcPieces;
        const int k = k0 + 4 * (idx % kTcPieces);
        const long long s =
            static_cast<long long>(t0 + f) * hop + k - pad_left;
        int taps = min(4, support - k);
        if (t0 + f >= num_frames || s < 0 || s >= num_samples) taps = 0;
        const int bytes = taps > 0 ? 4 * taps : 0;
        copy16(&st.patch[f * kTcChunk + 4 * (idx % kTcPieces)],
               bytes ? x + s : x, bytes);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kTcFrames * kTcChunk / kTcThreads; ++j) {
        const int idx = tid + kTcThreads * j;
        const int f = idx / kTcChunk;
        const int k = k0 + idx % kTcChunk;
        const long long s =
            static_cast<long long>(t0 + f) * hop + k - pad_left;
        const bool ok = k < support && t0 + f < num_frames && s >= 0 &&
                        s < num_samples;
        copy4(&st.patch[idx], ok ? x + s : x, ok);
      }
    }
    if (wide_slab) {
      // 32 pieces of 4 columns a tap: 16 re, then 16 im
#pragma unroll
      for (int j = 0; j < kTcChunk * kTcCols / 4 / kTcThreads; ++j) {
        const int idx = tid + kTcThreads * j;
        const int k = idx >> 5;
        const int col = 4 * (idx & 31);
        const int bin = b0 + (col & (kTcBins - 1));
        int cols = min(4, group_bins - bin);
        if (k0 + k >= support) cols = 0;
        const int bytes = cols > 0 ? 4 * cols : 0;
        const float* src = w + static_cast<size_t>(k0 + k) * bank_cols +
                           (col < kTcBins ? bin : gb + bin);
        copy16(&st.slab[k * kTcCols + col], bytes ? src : w, bytes);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kTcChunk * kTcCols / kTcThreads; ++j) {
        const int idx = tid + kTcThreads * j;
        const int k = idx >> 7;
        const int col = idx & (kTcCols - 1);
        const int bin = b0 + (col & (kTcBins - 1));
        const bool ok = bin < group_bins && k0 + k < support;
        copy4(&st.slab[idx],
              ok ? w + static_cast<size_t>(k0 + k) * bank_cols +
                       (col < kTcBins ? bin : gb + bin)
                 : w,
              ok);
      }
    }
    copy_commit();
  };

  // Each float32 value of a landed chunk into its bf16 hi and lo, once
  // (unrolled by 2 only, to leave registers beside the 128 accumulators)
  auto split_chunk = [&](const TcStage& st, TcSplit& sp) {
#pragma unroll 2
    for (int j = 0; j < kTcFrames * kTcChunk / 4 / kTcThreads; ++j) {
      const int idx = tid + kTcThreads * j;
      const int f = idx / kTcPieces;
      const int k = 4 * (idx % kTcPieces);
      const float4 v =
          *reinterpret_cast<const float4*>(&st.patch[f * kTcChunk + k]);
      split4(v, &sp.patch_hi[f * kTcPatchStride + k],
             &sp.patch_lo[f * kTcPatchStride + k]);
    }
#pragma unroll 2
    for (int j = 0; j < kTcChunk * kTcCols / 4 / kTcThreads; ++j) {
      const int idx = tid + kTcThreads * j;
      const int k = idx >> 5;
      const int col = 4 * (idx & 31);
      const float4 v =
          *reinterpret_cast<const float4*>(&st.slab[k * kTcCols + col]);
      split4(v, &sp.slab_hi[k * kTcSlabStride + col],
             &sp.slab_lo[k * kTcSlabStride + col]);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // ldmatrix addresses: A rows (frames) lane & 15, k half lane >> 4; B
  // (.trans) k rows lane & 7 plus 8 for lanes 8-15 and 24-31, n half
  // lane >> 4
  const int a_row = 64 * wm + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = (lane >> 4) * 8;

  auto mma_chunk = [&](const TcSplit& sp) {
#pragma unroll 1
    for (int kk = 0; kk < kTcChunk; kk += 16) {
      unsigned a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int off = (a_row + 16 * mt) * kTcPatchStride + kk + a_col;
        ldmatrix_x4(a_hi[mt], smem_addr(&sp.patch_hi[off]));
        if (kPasses == 3) ldmatrix_x4(a_lo[mt], smem_addr(&sp.patch_lo[off]));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // n-tiles 2 np, 2 np + 1: re columns of bins 32 wn + 16 np .. for
        // np < 2, the im columns of the same bins for np >= 2
        const int col = (np < 2 ? 0 : kTcBins) + 32 * wn + 16 * (np & 1);
        const int off = (kk + b_row) * kTcSlabStride + col + b_col;
        unsigned b_hi[4], b_lo[4];
        ldmatrix_x4_trans(b_hi, smem_addr(&sp.slab_hi[off]));
        if (kPasses == 3) ldmatrix_x4_trans(b_lo, smem_addr(&sp.slab_lo[off]));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // The step's passes into a zeroed fragment, then an IEEE add
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(part, a_hi[mt], b_hi[2 * h], b_hi[2 * h + 1]);
            if (kPasses == 3) {
              mma_bf16(part, a_hi[mt], b_lo[2 * h], b_lo[2 * h + 1]);
              mma_bf16(part, a_lo[mt], b_hi[2 * h], b_hi[2 * h + 1]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][2 * np + h][e] += part[e];
          }
        }
      }
    }
  };

  const int num_chunks = (support + kTcChunk - 1) / kTcChunk;
  load_chunk(0, raw[0]);
  if (num_chunks > 1) {
    load_chunk(kTcChunk, raw[1]);
  } else {
    copy_commit();  // an empty group keeps the count of pending groups
  }
  copy_wait<1>();
  __syncthreads();
  split_chunk(raw[0], split[0]);
  for (int c = 0; c < num_chunks; ++c) {
    copy_wait<0>();
    // Chunk c's split and chunk c + 1's copies are visible; every thread
    // is done with the mma of c - 1 (split buffer (c + 1) & 1) and with
    // the split of c (staging buffer c & 1)
    __syncthreads();
    if (c + 2 < num_chunks) load_chunk((c + 2) * kTcChunk, raw[c & 1]);
    if (c + 1 < num_chunks) split_chunk(raw[(c + 1) & 1], split[(c + 1) & 1]);
    mma_chunk(split[c & 1]);
  }

  // Accumulator e of an n-tile: frame row g + 8 (e >> 1), column
  // 2 tq + (e & 1); n-tile nt < 4 holds re and nt + 4 im of the same bins
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bin = b0 + 32 * wn + 8 * nt + 2 * tq + (e & 1);
      if (bin >= group_bins) continue;
      float* row = out + (static_cast<size_t>(clip) * n_bins +
                          table.bin0[group] + bin) * num_frames;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int t = t0 + 64 * wm + 16 * mt + g + 8 * (e >> 1);
        if (t < num_frames) {
          const float r = acc[mt][nt][e];
          const float i = acc[mt][nt + 4][e];
          row[t] = sqrtf(r * r + i * i);
        }
      }
    }
  }
}

// route: 0 IEEE float32 FMAs, 3 bf16x3, 1 one bf16 pass
int launch(const float* audio, const float* bank, float* out, int batch,
           int num_samples, int hop, int num_frames, int n_bins, int gb,
           int num_groups, const int* supports, const int* bins, int route,
           cudaStream_t stream) {
  if (num_groups < 1 || num_groups > kMaxGroups || gb < 1 ||
      (route != 0 && route != 1 && route != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  GroupTable table;
  table.num_groups = num_groups;
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

  if (route == 0) {
    table.tiles_per_group = (gb + kTileBins - 1) / kTileBins;
    const dim3 grid(num_groups * table.tiles_per_group,
                    (num_frames + kTileFrames - 1) / kTileFrames, batch);
    cqt_mag_kernel<<<grid, kThreads, 0, stream>>>(
        audio, bank, out, table, num_samples, hop, num_frames, n_bins, gb);
    return static_cast<int>(cudaGetLastError());
  }

  // Groups by falling support (a stable insertion sort), then each group's
  // blocks in one run
  table.tiles_per_group = (gb + kTcBins - 1) / kTcBins;
  for (int s = 0; s < num_groups; ++s) {
    int g = s;
    while (g > 0 && supports[table.order[g - 1]] < supports[s]) {
      table.order[g] = table.order[g - 1];
      --g;
    }
    table.order[g] = s;
  }
  const long long per_group =
      static_cast<long long>(table.tiles_per_group) *
      ((num_frames + kTcFrames - 1) / kTcFrames) * batch;
  if (per_group * num_groups > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < num_groups; ++s) {
    table.first_block[s] = static_cast<int>(s * per_group);
  }

  const bool wide_patch = hop % 4 == 0 && num_samples % 4 == 0 &&
                          reinterpret_cast<uintptr_t>(audio) % 16 == 0;
  const bool wide_slab =
      gb % 4 == 0 && reinterpret_cast<uintptr_t>(bank) % 16 == 0;
  auto kernel = route == 3 ? cqt_mag_tc_kernel<3> : cqt_mag_tc_kernel<1>;
  const cudaError_t status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTcSharedBytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<static_cast<unsigned>(per_group * num_groups), kTcThreads,
           kTcSharedBytes, stream>>>(audio, bank, out, table, batch,
                                     num_samples, hop, num_frames, n_bins, gb,
                                     wide_patch, wide_slab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel C. audio (batch, num_samples), bank (support, 2 * n_bins), out
// (batch, n_bins, num_frames), all float32 and contiguous on the device.
// route: 0 IEEE float32 FMAs (exact=True), 3 bf16x3 ('high'), 1 one bf16
// pass (False). Launches on `stream` and returns cudaGetLastError() of the
// launch.
extern "C" int cqt_mag_f32(const float* audio, const float* bank, float* out,
                           int batch, int num_samples, int support, int hop,
                           int num_frames, int n_bins, int route,
                           cudaStream_t stream) {
  return launch(audio, bank, out, batch, num_samples, hop, num_frames, n_bins,
                n_bins, 1, &support, &n_bins, route, stream);
}

// Kernel D. bank_stack (sum(supports), 2 * gb): group g's rows follow
// group g-1's, columns [re | im] each padded to gb; supports and bins are
// host arrays of num_groups ints (at most 32). out (batch, sum(bins),
// num_frames); route as for cqt_mag_f32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int cqt_mag_grouped_f32(const float* audio, const float* bank_stack,
                                   float* out, int batch, int num_samples,
                                   int hop, int num_frames, int n_bins, int gb,
                                   int num_groups, const int* supports,
                                   const int* bins, int route,
                                   cudaStream_t stream) {
  return launch(audio, bank_stack, out, batch, num_samples, hop, num_frames,
                n_bins, gb, num_groups, supports, bins, route, stream);
}
