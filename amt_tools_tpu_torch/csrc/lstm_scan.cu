// Whole-sequence LSTM recurrence for Hopper (sm_90a), forward.
//
// Replaces: amt_tools_tpu/ops/pallas_lstm.py, _lstm_kernel (pallas_call in
// lstm_scan_pallas; kernel B) and _lstm_fwd_res_kernel (pallas_call in
// _lstm_fwd_res; kernel E). From a zero carry, over hoisted input projections
// xw (B, T, 4H) that already hold the bias, with recurrent weights
// W_h (H, 4H) in gate order i, f, g, o:
//   gates = xw[:, t] + h @ W_h;  c = f * c + i * g;  h = o * tanh(c)
// writing h as (B, T, H). `reverse` walks t from T-1 down to 0 and still
// writes each h at its natural position.
//
// Numerics follow the Pallas kernel, not the JAX XLA scan:
//   - the carry c, h is float32 in both modes;
//   - float32 xw: float32 W_h, float32 gates, logistic sigmoid;
//   - bf16 xw: h is rounded to bf16 for the recurrent product (bf16 W_h,
//     float32 accumulation), the gates are rounded to bf16, sigmoid takes
//     the tanh form 0.5 * tanh(0.5 x) + 0.5 with bf16 results, i * g is a
//     bf16 product, and the output is h rounded to bf16.
//
// What bounds it on this card: at the serving shape (B = 128, T = 1876,
// H = 256, bf16) one direction moves 0.49 GB of xw and 0.12 GB of h, about
// 0.18 ms at 3.35 TB/s, and does 126 GFLOP of recurrent products. Neither
// is the real floor: the 1876 steps depend on each other, so the time is
// 1876 times the latency of one step.
//
// Design: a thread-block cluster of 8 CTAs owns R batch rows for the whole
// sequence, and the clusters never wait on each other.
//   - CTA j owns hidden units [j H/8, (j+1) H/8): their 4 x H/8 gate
//     columns i, f, g, o, so the cell update of its units needs nothing
//     from another CTA. Its slice of W_h, H x 4H/8 (64 KiB in bf16, 128 KiB
//     in float32 at H = 256), is loaded once into shared memory. Where it
//     does not fit (float32 above H = 256, bf16 above H = 448) the same
//     body streams it from L2 every step in chunks of rows through two
//     shared buffers (kResident = false), 8x less per SM than all of W_h.
//   - Each step, the CTA takes the gates of its R rows x 4H/8 columns
//     against the h of all H units, held in shared memory:
//       bf16: mma.sync m16n8k16 with float32 accumulation, operands
//       swapped so the W_h slice (ldmatrix.trans from shared memory) is the
//       16-row operand and the batch rows are n = 8 (two n-tiles for
//       R > 8); each warp owns 8 units, so the i, f, g, o of one unit for
//       two rows land in one thread's accumulators;
//       float32: FFMA, no TF32, in the same thread-to-(unit, rows) map;
//       with the slice resident, k is split over up to 4 groups of warps
//       (512 threads at H = 256), whose partial sums group 0 adds in a
//       fixed order.
//   - xw for the next step (R x 4H/8 values) is copied by cp.async into a
//     second buffer while the current step runs.
//   - The cell update keeps c in registers; the new h of the CTA's units
//     goes to a staging buffer (bf16 in bf16 mode: exactly the value the
//     next product reads; float32 otherwise), and from there, in 16-byte
//     pieces, into the next-step h buffer of all 8 CTAs through distributed
//     shared memory.
//   - One cluster barrier a step; h is double-buffered, so one barrier
//     suffices. Its arrive (release) follows the DSMEM stores; the stores to
//     device memory (h to the output, E's residuals) are issued between the
//     arrive and the wait, so the release does not wait on them.
//   - R is chosen by the wrapper (ops/lstm_kernel.py) so that every cluster
//     is resident in one wave (cudaOccupancyMaxActiveClusters); at B = 128,
//     R = 8 gives 16 clusters on 128 SMs.
// Exactly T steps run, so a ragged T needs no padding. H is a multiple of
// 16 up to 1024.
//
// Per-row lengths (kMasked): bucketed evaluation and masked training pad
// each track to a multiple of the bucket (or to the crop) and pass its true
// length. At a step with
// t >= lengths[b], row b keeps its carry (c in registers, h in the
// exchanged buffer: the h sent through DSMEM is the old one) and writes 0
// to `out`, as the JAX package's masked scan step (ops/lstm.py,
// _masked_step_outputs). A reverse scan so starts each row at its true end,
// and every valid step does the unmasked step's arithmetic, so the valid
// frames equal an unpadded launch's bit for bit. The schedule, the cp.async
// prefetch and the one barrier a step are unchanged; the unmasked
// instantiation compiles to the code without the flag.
//
// A carry in and out (kCarry): streaming feeds one frame a launch and
// threads the state, and carried training differentiates through it. The kernel starts from a given float32 (c0, h0)
// (B, H) in place of zeros: c0 into the registers that hold c, h0 into the
// first h buffer, rounded to bf16 in bf16 mode as every h the product reads
// is. After the last step it writes the final c and the h the next step
// would read (the staged value, so in bf16 mode bf16(h) widened) as float32
// (B, H); the loop itself is the launch's without a carry.
// So a sequence cut into chunks, each launch given the previous one's
// carry, equals one whole launch bit for bit in both dtypes. With kMasked, a
// row's carry is the state at its last valid step. The launch without the
// flag compiles to the code without it.
//
// Kernel E, the training forward, is the same body with kResiduals set: it
// also writes, for every step, the four gate activations as float32 (in
// bf16 mode the bf16-rounded values the step used, widened) and the float32
// cell state c_t, which the BPTT kernel (lstm_bptt.cu) reads back, from the
// same registers. Its arithmetic is B's, so its h equals B's bit for bit.
// It takes kMasked and kCarry as B does: at a masked step it writes the
// kept c as c_t, so that a reverse row's first valid step (t = len - 1)
// reads the carry it started from as c_prev at t = len; the gates written
// there are the ones the step computed, which the BPTT does not read.
// At the training shape (B = 8, T = 625, H = 256, float32) it moves about
// 51 MB, 0.015 ms at 3.35 TB/s, and does 2.6 GFLOP of recurrent products,
// 0.039 ms at the 67 TFLOP/s float32 peak; 625 dependent steps are the floor.
//
// Groups (B and E): G independent sequences with their own W_h in one
// launch, the card's counterpart of the JAX package's one grouped scan over
// all directions of its grouped BiLSTM (ops/lstm.py, _grouped_lstm_scan).
// blockIdx.y is the group; it offsets xw, W_h, out and the residuals by its
// slab, and the groups from `reverse_from` on walk back to front (a
// BiLSTM's backward directions, with no flipped copy). A group's rows and
// arithmetic are those of an ungrouped launch, which is G = 1. Since the
// steps depend on each other, G launches one after another cost G times one
// step chain; in one launch the groups' chains run side by side on idle
// SMs (at the training batch an ungrouped launch fills 8 of 16 clusters).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kMaxRows = 16;
constexpr int kMaxThreads = 512;  // H = 1024: 128 units a CTA, 16 warps
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16 logistic in the Pallas kernel's tanh form, rounded as bf16 ops round
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return round_bf16(0.5f * round_bf16(tanhf(0.5f * x)) + 0.5f);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The two halves of a cluster barrier: arrive publishes this thread's
// writes (to distributed shared memory) to the cluster, wait acquires
// everyone's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory layout of one CTA, shared by the host launch and the kernel
// (ops/lstm_kernel.py scan_geometry mirrors it, and a card test holds the
// two equal). The kernel computes it rather than taking it from the
// wrapper: with the dtype and residency known at compile time part of it
// folds to constants, and passed as a kernel parameter it made B's bf16
// step about 10% slower on an H100. Offsets and sizes are in bytes and
// multiples of 16.
//   w:     the W_h slice, rows k x (4 * units_pad) local columns, padded
//          by 16 bytes a row; local column 32 w + 8 q + g is gate q of
//          unit 8 w + g (warp w owns units 8 w .. 8 w + 7). Resident: all H
//          rows; streamed: two chunks of `chunk` rows.
//   h:     two buffers of row_pad x H values (+16 bytes a row), row r the
//          h of batch row r of the cluster.
//   xw:    two buffers of R x 4 x units values.
//   stage: R x units values, the new h of the CTA's units.
//   red:   float32 resident only, where k is split over `slices` groups of
//          warps: the partial gate sums of groups 1.. for group 0 to add.
struct ScanGeometry {
  int units;
  int units_pad;
  int slices;  // float32 resident: k is split over this many warp groups
  int threads;
  int chunk;
  int w_stride;  // elements
  int h_stride;  // elements
  int row_pad;
  size_t w_off, h_off, x_off, stage_off, red_off, bytes;
};

__host__ __device__ inline ScanGeometry scan_geometry(int hidden, int size,
                                                      int rows, bool resident) {
  ScanGeometry g;
  g.units = hidden / kCluster;
  g.units_pad = (g.units + 7) / 8 * 8;
  g.slices = 1;
  if (size == 4 && resident) {
    while (g.slices < 4 && 8 * g.units_pad * g.slices <= kMaxThreads &&
           hidden % (8 * g.slices) == 0) {
      g.slices *= 2;
    }
  }
  g.threads = 4 * g.units_pad * g.slices;
  g.chunk = resident ? hidden : (size == 2 ? 32 : 16);
  if (g.chunk > hidden) g.chunk = hidden;
  g.w_stride = 4 * g.units_pad + 16 / size;
  g.h_stride = hidden + 16 / size;
  g.row_pad = rows <= 8 ? 8 : 16;
  const size_t w_rows = resident ? hidden : 2 * g.chunk;
  g.w_off = 0;
  g.h_off = g.w_off + w_rows * g.w_stride * size;
  g.x_off = g.h_off + 2 * static_cast<size_t>(g.row_pad) * g.h_stride * size;
  g.stage_off = g.x_off + 2 * static_cast<size_t>(rows) * 4 * g.units * size;
  g.red_off = g.stage_off +
              (static_cast<size_t>(rows) * g.units * size + 15) / 16 * 16;
  g.bytes = g.red_off + static_cast<size_t>(g.slices - 1) * 4 * g.units_pad *
                            4 * (rows <= 8 ? 2 : 4) * sizeof(float);
  return g;
}

// Issue the copy of `elems` consecutive values (16 bytes or 4 bytes)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool wide) {
  if (wide) {
    cp_async16(dst, src);
  } else {
    cp_async4(dst, src);
  }
}

// One 16-byte or 4-byte piece
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src,
                                           bool wide) {
  if (wide) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
  }
}

// Copy W_h rows [k0, k0 + rows) of this CTA's columns into `dst`, laid out
// as ScanGeometry says. Columns of units past `units` are never written.
template <typename T>
__device__ __forceinline__ void load_w_rows(T* dst, const T* w_h, int hidden,
                                            const ScanGeometry& geo, int rank,
                                            int k0, int rows, bool wide) {
  const int vec = (wide ? 16 : 4) / static_cast<int>(sizeof(T));
  const int per_gate = geo.units / vec;
  const int per_row = 4 * per_gate;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
    const int kk = idx / per_row;
    const int rem = idx - kk * per_row;
    const int q = rem / per_gate;
    const int u = (rem - q * per_gate) * vec;
    const int col = 32 * (u >> 3) + 8 * q + (u & 7);
    copy_async(dst + kk * geo.w_stride + col,
               w_h + static_cast<size_t>(k0 + kk) * 4 * hidden + q * hidden +
                   rank * geo.units + u,
               wide);
  }
}

// Copy xw of step t for the cluster's rows into `dst` (R x 4 x units)
template <typename T>
__device__ __forceinline__ void load_xw(T* dst, const T* xw, int batch,
                                        int frames, int hidden, int row0,
                                        int rows, int t,
                                        const ScanGeometry& geo, int rank,
                                        bool wide) {
  const int vec = (wide ? 16 : 4) / static_cast<int>(sizeof(T));
  const int per_gate = geo.units / vec;
  const int per_row = 4 * per_gate;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
    const int r = idx / per_row;
    if (row0 + r >= batch) break;
    const int rem = idx - r * per_row;
    const int q = rem / per_gate;
    const int u = (rem - q * per_gate) * vec;
    copy_async(dst + (r * 4 + q) * geo.units + u,
               xw + (static_cast<size_t>(row0 + r) * frames + t) * 4 * hidden +
                   q * hidden + rank * geo.units + u,
               wide);
  }
}

// Accumulate the recurrent products of W rows [k0, k0 + rows) (chunk-local
// in `w`) into gate[q][i] for this thread's unit and rows
template <bool kBf16, int kRowTiles, typename T>
__device__ __forceinline__ void gate_products(float (&gate)[4][2 * kRowTiles],
                                              const T* w, const T* h,
                                              const ScanGeometry& geo,
                                              int k0, int rows) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) % (geo.units_pad / 8);
  const int g = lane >> 2;
  const int tq = lane & 3;
  if constexpr (kBf16) {
    // A from ldmatrix.trans: lanes 0-7 / 8-15 / 16-23 / 24-31 address the
    // (k 0-7, m 0-7) / (k 0-7, m 8-15) / (k 8-15, m 0-7) / (k 8-15, m 8-15)
    // 8x8 matrices of the 16 x 16 tile, stored k-major
    const int a_row = (lane & 7) + ((lane >> 4) << 3);
    const int a_col = 32 * warp + ((lane >> 3) & 1) * 8;
    const T* a_base = w + a_row * geo.w_stride + a_col;
    float acc[2][kRowTiles][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < kRowTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    // The addresses advance as induction variables. Left to the compiler
    // (a + kk * w_stride), the masked and carried instantiations
    // recomputed them with multiplies on the ldmatrix's dependency chain
    // (SASS); written so, masked and carried B in bf16 run 5% faster on an
    // H100 and the launch without either is level (PERF.md)
    unsigned a_addr = smem_addr(a_base);
    const unsigned a_step = 16 * geo.w_stride * sizeof(T);
    const T* hk = h + g * geo.h_stride + k0 + 2 * tq;
    for (int kk = 0; kk < rows; kk += 16, a_addr += a_step, hk += 16) {
      unsigned a0[4], a1[4];
      ldmatrix_x4_trans(a0, a_addr);
      ldmatrix_x4_trans(a1, a_addr + 16 * sizeof(T));
#pragma unroll
      for (int n = 0; n < kRowTiles; ++n) {
        const T* hb = hk + 8 * n * geo.h_stride;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(hb);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(hb + 8);
        mma_bf16(acc[0][n], a0, b0, b1);
        mma_bf16(acc[1][n], a1, b0, b1);
      }
    }
    // m-tile 0 rows 0-7 / 8-15: gates i / f; m-tile 1: g / o. Columns
    // (batch rows) 2 tq, 2 tq + 1 of each n-tile
#pragma unroll
    for (int n = 0; n < kRowTiles; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        gate[0][2 * n + e] += acc[0][n][e];
        gate[1][2 * n + e] += acc[0][n][2 + e];
        gate[2][2 * n + e] += acc[1][n][e];
        gate[3][2 * n + e] += acc[1][n][2 + e];
      }
  } else {
    const T* wc = w + 32 * warp + g;
    for (int kk = 0; kk < rows; kk += 4) {
      float4 hv[2 * kRowTiles];
#pragma unroll
      for (int i = 0; i < 2 * kRowTiles; ++i) {
        const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
        hv[i] = *reinterpret_cast<const float4*>(h + r * geo.h_stride + k0 +
                                                 kk);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const T* wr = wc + (kk + s) * geo.w_stride;
        const float wq[4] = {wr[0], wr[8], wr[16], wr[24]};
#pragma unroll
        for (int i = 0; i < 2 * kRowTiles; ++i) {
          const float hk = s == 0 ? hv[i].x
                         : s == 1 ? hv[i].y
                         : s == 2 ? hv[i].z
                                  : hv[i].w;
#pragma unroll
          for (int q = 0; q < 4; ++q) gate[q][i] = fmaf(hk, wq[q], gate[q][i]);
        }
      }
    }
  }
}

// One 16-byte or 4-byte piece of zeros
__device__ __forceinline__ void zero_piece(unsigned char* dst, bool wide) {
  if (wide) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else {
    *reinterpret_cast<unsigned*>(dst) = 0u;
  }
}

// The carry of kCarry launches: (c0, h0) read at the start, (c_last,
// h_last) written at the end, each float32 (batch, hidden)
struct Carry {
  const float* c0;
  const float* h0;
  float* c_last;
  float* h_last;
};

template <typename T, bool kBf16, bool kResiduals, bool kResident,
          int kRowTiles, bool kMasked, bool kCarry>
__global__ void __launch_bounds__(kMaxThreads)
lstm_scan_kernel(const T* __restrict__ xw, const T* __restrict__ w_h,
                 T* __restrict__ out, float* __restrict__ gates_out,
                 float* __restrict__ c_out, const int* __restrict__ lengths,
                 Carry carry, int batch, int frames, int hidden,
                 int reverse_from, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ScanGeometry geo = scan_geometry(hidden, sizeof(T), rows, kResident);
  // Group blockIdx.y runs its own slab of xw, W_h, out and the residuals;
  // the groups from reverse_from on walk back to front. The lengths are
  // every group's.
  const int group = static_cast<int>(blockIdx.y);
  const bool reverse = group >= reverse_from;
  const size_t seq = static_cast<size_t>(batch) * frames * hidden;
  xw += group * 4 * seq;
  w_h += static_cast<size_t>(group) * hidden * 4 * hidden;
  out += group * seq;
  if constexpr (kResiduals) {
    gates_out += group * 4 * seq;
    c_out += group * seq;
  }
  T* w_buf = reinterpret_cast<T*>(smem + geo.w_off);
  T* h_buf = reinterpret_cast<T*>(smem + geo.h_off);
  T* x_buf = reinterpret_cast<T*>(smem + geo.x_off);
  T* stage = reinterpret_cast<T*>(smem + geo.stage_off);
  float* red = reinterpret_cast<float*>(smem + geo.red_off);

  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kCluster) * rows;
  const int units = geo.units;
  const int lane = threadIdx.x & 31;
  const int warps = geo.units_pad / 8;  // warps a slice
  const int slice = (threadIdx.x >> 5) / warps;
  const int u = 8 * ((threadIdx.x >> 5) % warps) + (lane >> 2);
  const int tq = lane & 3;
  const bool unit_ok = u < units;
  const int slice_k = hidden / geo.slices;
  const int slice_threads = 4 * geo.units_pad;
  const bool wide = (units * sizeof(T)) % 16 == 0;
  const int h_size = geo.row_pad * geo.h_stride;
  const int x_size = rows * 4 * units;
  const int n_chunks = (hidden + geo.chunk - 1) / geo.chunk;
  const int w_chunk = geo.chunk * geo.w_stride;

  // Zero everything (padding columns of W, h and the rows past the batch
  // stay zero), then start the copies of W (all of it, or the first
  // chunk) and of step 0's xw
  for (size_t i = threadIdx.x; i < geo.bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_w_rows(w_buf, w_h, hidden, geo, rank, 0, geo.chunk, wide);
  load_xw(x_buf, xw, batch, frames, hidden, row0, rows,
          reverse ? frames - 1 : 0, geo, rank, wide);
  cp_async_commit();
  if constexpr (kCarry) {  // h0 of the cluster's rows, all H units
    for (int idx = threadIdx.x; idx < rows * hidden; idx += blockDim.x) {
      const int r = idx / hidden;
      const int k = idx - r * hidden;
      if (row0 + r < batch) {
        h_buf[r * geo.h_stride + k] =
            from_float<T>(carry.h0[static_cast<size_t>(row0 + r) * hidden + k]);
      }
    }
  }
  cp_async_wait<0>();
  // Every CTA of the cluster is running and zeroed (and holds h0) before
  // any remote write
  cluster.sync();

  // kMasked: the length of the row of the first piece this thread stores
  // to the output each step (most threads store one piece or none)
  const int out_pieces = units * static_cast<int>(sizeof(T)) / (wide ? 16 : 4);
  const int out_row = row0 + static_cast<int>(threadIdx.x) / out_pieces;
  const int out_len =
      kMasked && static_cast<int>(threadIdx.x) < rows * out_pieces &&
              out_row < batch
          ? lengths[out_row]
          : frames;

  float c[2 * kRowTiles];
  int row_len[2 * kRowTiles];  // kMasked: the true length of each row
#pragma unroll
  for (int i = 0; i < 2 * kRowTiles; ++i) {
    const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
    c[i] = kCarry && slice == 0 && unit_ok && r < rows && row0 + r < batch
               ? carry.c0[static_cast<size_t>(row0 + r) * hidden +
                          rank * units + u]
               : 0.f;
    row_len[i] = kMasked && r < rows && row0 + r < batch ? lengths[row0 + r]
                                                         : frames;
  }

  for (int s = 0; s < frames; ++s) {
    const int t = reverse ? frames - 1 - s : s;
    const T* h_cur = h_buf + (s & 1) * h_size;
    T* h_next = h_buf + ((s & 1) ^ 1) * h_size;

    // Next step's xw into the other buffer, during this step
    if (s + 1 < frames) {
      load_xw(x_buf + ((s + 1) & 1) * x_size, xw, batch, frames, hidden, row0,
              rows, reverse ? frames - 2 - s : s + 1, geo, rank, wide);
    }
    cp_async_commit();

    float gate[4][2 * kRowTiles];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 2 * kRowTiles; ++i) gate[q][i] = 0.f;

    if constexpr (kResident) {
      const int k0 = slice * slice_k;
      gate_products<kBf16, kRowTiles>(gate, w_buf + k0 * geo.w_stride, h_cur,
                                      geo, k0, slice_k);
      if (slice > 0) {  // hand the partial sums to slice 0
        float* dst = red + (slice - 1) * 8 * kRowTiles * slice_threads +
                     (threadIdx.x - slice * slice_threads);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 2 * kRowTiles; ++i)
            dst[(q * 2 * kRowTiles + i) * slice_threads] = gate[q][i];
      }
    } else {
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int slot = (s * n_chunks + ci) & 1;
        cp_async_wait<0>();
        __syncthreads();
        // The next chunk (the first again after the last, for the next
        // step) into the slot everyone has finished with
        const int next = ci + 1 < n_chunks ? ci + 1 : 0;
        if (ci + 1 < n_chunks || s + 1 < frames) {
          const int k_next = next * geo.chunk;
          load_w_rows(w_buf + (slot ^ 1) * w_chunk, w_h, hidden, geo, rank,
                      k_next, min(geo.chunk, hidden - k_next), wide);
        }
        cp_async_commit();
        const int k0 = ci * geo.chunk;
        gate_products<kBf16, kRowTiles>(gate, w_buf + slot * w_chunk, h_cur,
                                        geo, k0, min(geo.chunk, hidden - k0));
      }
    }

    // This step's xw has landed (only the next step's may be in flight)
    if constexpr (kResident) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (slice == 0) {
      for (int other = 1; other < geo.slices; ++other) {
        const float* src = red + (other - 1) * 8 * kRowTiles * slice_threads +
                           threadIdx.x;
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < 2 * kRowTiles; ++i)
            gate[q][i] += src[(q * 2 * kRowTiles + i) * slice_threads];
      }
    }

    // The cell update of this thread's unit and rows (slice 0). The
    // residuals stay in registers until the step's h is published.
    float res_gate[4][2 * kRowTiles];
    float res_c[2 * kRowTiles];
    const T* x_cur = x_buf + (s & 1) * x_size;
#pragma unroll
    for (int i = 0; i < 2 * kRowTiles; ++i) {
      const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
      const bool live = slice == 0 && unit_ok && r < rows;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = to_float(x_cur[(r * 4 + q) * units + u]);
      }
      float gi = x[0] + gate[0][i];
      float gf = x[1] + gate[1][i];
      float gg = x[2] + gate[2][i];
      float go = x[3] + gate[3][i];
      float i_g, f_g, g_g, o_g, c_new;
      if (kBf16) {
        gi = round_bf16(gi);
        gf = round_bf16(gf);
        gg = round_bf16(gg);
        go = round_bf16(go);
        i_g = sigmoid_bf16(gi);
        f_g = sigmoid_bf16(gf);
        g_g = round_bf16(tanhf(gg));
        o_g = sigmoid_bf16(go);
        c_new = f_g * c[i] + round_bf16(i_g * g_g);
      } else {
        i_g = sigmoid_f32(gi);
        f_g = sigmoid_f32(gf);
        g_g = tanhf(gg);
        o_g = sigmoid_f32(go);
        c_new = f_g * c[i] + i_g * g_g;
      }
      const float h = o_g * tanhf(c_new);
      // A padded step (kMasked) keeps the carry: c as it was, and the h this
      // row's product read, from this step's buffer
      const bool keep = kMasked && t >= row_len[i];
      if (!keep) c[i] = c_new;
      if (live) {
        stage[r * units + u] =
            keep ? h_cur[r * geo.h_stride + rank * units + u] : from_float<T>(h);
      }
      res_gate[0][i] = i_g;
      res_gate[1][i] = f_g;
      res_gate[2][i] = g_g;
      res_gate[3][i] = o_g;
      res_c[i] = c[i];
    }
    __syncthreads();

    // The staged h, through distributed shared memory, into the next-step
    // h buffer of every CTA of the cluster, then released to the cluster
    const int piece = wide ? 16 : 4;
    const int per_row = units * static_cast<int>(sizeof(T)) / piece;
    const int per_dest = rows * per_row;
    for (int idx = threadIdx.x; idx < kCluster * per_dest; idx += blockDim.x) {
      const int dest = idx / per_dest;
      const int rem = idx - dest * per_dest;
      const int r = rem / per_row;
      const int v = rem - r * per_row;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(stage + r * units) + v * piece;
      T* remote = cluster.map_shared_rank(h_next, dest);
      unsigned char* dst = reinterpret_cast<unsigned char*>(
                               remote + r * geo.h_stride + rank * units) +
                           v * piece;
      copy_piece(dst, src, wide);
    }
    cluster_arrive();

    // Device-memory stores after the arrive, so its release does not wait
    // on them: the staged h to the output (0 on a padded step), and E's
    // residuals
    for (int idx = threadIdx.x; idx < per_dest; idx += blockDim.x) {
      const int r = idx / per_row;
      const int v = idx - r * per_row;
      if (row0 + r >= batch) continue;
      unsigned char* dst = reinterpret_cast<unsigned char*>(
                               out + (static_cast<size_t>(row0 + r) * frames +
                                      t) * hidden +
                               rank * units) +
                           v * piece;
      if (kMasked &&
          t >= (idx == static_cast<int>(threadIdx.x) ? out_len
                                                     : lengths[row0 + r])) {
        zero_piece(dst, wide);
      } else {
        copy_piece(dst,
                   reinterpret_cast<const unsigned char*>(stage + r * units) +
                       v * piece,
                   wide);
      }
    }
    if (kResiduals && slice == 0 && unit_ok) {
#pragma unroll
      for (int i = 0; i < 2 * kRowTiles; ++i) {
        const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
        if (r >= rows || row0 + r >= batch) continue;
        const size_t step = static_cast<size_t>(row0 + r) * frames + t;
        float* gp = gates_out + step * 4 * hidden + rank * units + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) gp[q * hidden] = res_gate[q][i];
        c_out[step * hidden + rank * units + u] = res_c[i];
      }
    }
    cluster_wait();
  }

  // The final carry, after the loop so that no step pays for it: c from
  // the registers, and the h the next step would read, which this thread
  // staged at the last step
  if constexpr (kCarry) {
    if (slice == 0 && unit_ok) {
#pragma unroll
      for (int i = 0; i < 2 * kRowTiles; ++i) {
        const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
        if (r >= rows || row0 + r >= batch) continue;
        const size_t at =
            static_cast<size_t>(row0 + r) * hidden + rank * units + u;
        carry.c_last[at] = c[i];
        carry.h_last[at] = to_float(stage[r * units + u]);
      }
    }
  }
}

// The launch carries the group count and the first reversed group (G = 1 is
// the ungrouped launch: reverse_from 0 for a reverse scan, 1 for a forward
// one). Group g takes the slabs xw + g B T 4H, W_h + g H 4H, out + g B T H
// (and the residuals'), and its clusters tile blockIdx.x as the ungrouped
// launch's do; blockIdx.y is the group, so no cluster spans two groups.
struct Launch {
  int groups;
  int reverse_from;
  int batch;
  int frames;
  int hidden;
  int rows;
  cudaStream_t stream;
  int* active_clusters;  // not null: only ask how many clusters fit
};

template <typename T, bool kBf16, bool kResiduals, bool kResident,
          int kRowTiles, bool kMasked, bool kCarry>
int launch(const void* xw, const void* w_h, void* out, float* gates,
           float* c_seq, const int* lengths, Carry carry, const Launch& l) {
  const ScanGeometry geo = scan_geometry(l.hidden, sizeof(T), l.rows, kResident);
  if (geo.bytes > kMaxSharedBytes || geo.threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = lstm_scan_kernel<T, kBf16, kResiduals, kResident, kRowTiles,
                                 kMasked, kCarry>;
  cudaError_t status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(geo.bytes));
  if (status != cudaSuccess) return static_cast<int>(status);

  const int clusters = (l.batch + l.rows - 1) / l.rows;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = kCluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster * (clusters > 0 ? clusters : 1), l.groups);
  config.blockDim = dim3(geo.threads);
  config.dynamicSmemBytes = geo.bytes;
  config.stream = l.stream;
  config.attrs = attribute;
  config.numAttrs = 1;

  if (l.active_clusters != nullptr) {
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(l.active_clusters, kernel, &config));
  }
  status = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(xw),
                              static_cast<const T*>(w_h), static_cast<T*>(out),
                              gates, c_seq, lengths, carry, l.batch, l.frames,
                              l.hidden, l.reverse_from, l.rows);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBf16, bool kResiduals, bool kMasked, bool kCarry>
int dispatch(const void* xw, const void* w_h, void* out, float* gates,
             float* c_seq, const int* lengths, Carry carry, int resident,
             const Launch& l) {
  if (l.hidden % 16 || l.hidden < 16 || l.rows < 1 || l.rows > kMaxRows ||
      l.groups < 1 || l.groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (resident) {
    if (l.rows <= 8) {
      return launch<T, kBf16, kResiduals, true, 1, kMasked, kCarry>(
          xw, w_h, out, gates, c_seq, lengths, carry, l);
    }
    return launch<T, kBf16, kResiduals, true, 2, kMasked, kCarry>(
        xw, w_h, out, gates, c_seq, lengths, carry, l);
  }
  if (l.rows <= 8) {
    return launch<T, kBf16, kResiduals, false, 1, kMasked, kCarry>(
        xw, w_h, out, gates, c_seq, lengths, carry, l);
  }
  return launch<T, kBf16, kResiduals, false, 2, kMasked, kCarry>(
      xw, w_h, out, gates, c_seq, lengths, carry, l);
}

// Kernel B, or E with kResiduals, with a carry or without
template <typename T, bool kBf16, bool kResiduals, bool kMasked>
int dispatch_carry(const void* xw, const void* w_h, void* out, float* gates,
                   float* c_seq, const int* lengths, Carry carry,
                   int resident, const Launch& l) {
  if (carry.c0 != nullptr) {
    return dispatch<T, kBf16, kResiduals, kMasked, true>(
        xw, w_h, out, gates, c_seq, lengths, carry, resident, l);
  }
  return dispatch<T, kBf16, kResiduals, kMasked, false>(
      xw, w_h, out, gates, c_seq, lengths, carry, resident, l);
}

// Kernel B or E with lengths, a carry, both or neither. Each combination is
// its own instantiation, so the launch without either compiles to the code
// without the flags. A carry is one group's (streaming, or carried
// training).
template <typename T, bool kBf16, bool kResiduals>
int dispatch_flags(const void* xw, const void* w_h, void* out, float* gates,
                   float* c_seq, const int* lengths, Carry carry,
                   int resident, const Launch& l) {
  const bool carried = carry.c0 != nullptr;
  if (carried && (carry.h0 == nullptr || carry.c_last == nullptr ||
                  carry.h_last == nullptr || l.groups != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lengths != nullptr) {
    return dispatch_carry<T, kBf16, kResiduals, true>(
        xw, w_h, out, gates, c_seq, lengths, carry, resident, l);
  }
  return dispatch_carry<T, kBf16, kResiduals, false>(
      xw, w_h, out, gates, c_seq, nullptr, carry, resident, l);
}

template <typename T, bool kBf16>
int dispatch_type(const void* xw, const void* w_h, void* out, float* gates,
                  float* c_seq, const int* lengths, Carry carry, int residuals,
                  int resident, const Launch& l) {
  if (residuals) {
    return dispatch_flags<T, kBf16, true>(xw, w_h, out, gates, c_seq,
                                          lengths, carry, resident, l);
  }
  return dispatch_flags<T, kBf16, false>(xw, w_h, out, nullptr, nullptr,
                                         lengths, carry, resident, l);
}

int run(const void* xw, const void* w_h, void* out, float* gates,
        float* c_seq, const int* lengths, Carry carry, int bf16,
        int residuals, int resident, const Launch& l) {
  if (bf16) {
    return dispatch_type<__nv_bfloat16, true>(xw, w_h, out, gates, c_seq,
                                              lengths, carry, residuals,
                                              resident, l);
  }
  return dispatch_type<float, false>(xw, w_h, out, gates, c_seq, lengths,
                                     carry, residuals, resident, l);
}

}  // namespace

// xw (batch, frames, 4 * hidden), w_h (hidden, 4 * hidden) and out
// (batch, frames, hidden), contiguous and 16-byte aligned on the device,
// all float32 or all bf16 (`bf16` != 0). `lengths` is null (every row runs
// all frames) or int32 (batch) on the device, each in [0, frames]. hidden
// is a multiple of 16; each cluster of 8 CTAs takes `rows` (1..16) batch
// rows; `resident` keeps the W_h slice in shared memory (else it is
// streamed each step). Launches on `stream` and returns the first CUDA
// error of the set-up or the launch.
extern "C" int lstm_scan(const void* xw, const void* w_h, void* out,
                         const int* lengths, int batch, int frames, int hidden,
                         int reverse, int bf16, int rows, int resident,
                         cudaStream_t stream) {
  return run(xw, w_h, out, nullptr, nullptr, lengths, Carry{}, bf16, 0,
             resident,
             Launch{1, reverse ? 0 : 1, batch, frames, hidden, rows, stream,
                    nullptr});
}

// Kernel B over `groups` independent sequences in one launch: xw (groups,
// batch, frames, 4 * hidden), w_h (groups, hidden, 4 * hidden), out
// (groups, batch, frames, hidden), the groups from `reverse_from` on
// walking back to front; `lengths` (null, or int32 (batch)) are every
// group's. Otherwise as lstm_scan.
extern "C" int lstm_scan_grouped(const void* xw, const void* w_h, void* out,
                                 const int* lengths, int groups,
                                 int reverse_from, int batch, int frames,
                                 int hidden, int bf16, int rows, int resident,
                                 cudaStream_t stream) {
  return run(xw, w_h, out, nullptr, nullptr, lengths, Carry{}, bf16, 0,
             resident,
             Launch{groups, reverse_from, batch, frames, hidden, rows, stream,
                    nullptr});
}

// Kernel B from a carry: lstm_scan starting from c0, h0 in place of zeros,
// writing the final c_last, h_last (all four float32 (batch, hidden),
// contiguous on the device; h_last is the h the next step would read, in
// bf16 mode bf16-rounded). `lengths` as lstm_scan's: a row's final carry is
// its state at its last valid step.
extern "C" int lstm_scan_carried(const void* xw, const void* w_h, void* out,
                                 const int* lengths, const float* c0,
                                 const float* h0, float* c_last,
                                 float* h_last, int batch, int frames,
                                 int hidden, int reverse, int bf16, int rows,
                                 int resident, cudaStream_t stream) {
  if (c0 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(xw, w_h, out, nullptr, nullptr, lengths,
             Carry{c0, h0, c_last, h_last}, bf16, 0, resident,
             Launch{1, reverse ? 0 : 1, batch, frames, hidden, rows, stream,
                    nullptr});
}

// Kernel E: lstm_scan, and also the float32 residuals gates
// (batch, frames, 4 * hidden) and c_seq (batch, frames, hidden), contiguous
// on the device. `lengths` as lstm_scan's; at a masked step c_seq holds the
// kept cell state (the c_prev of the row's next valid step in the BPTT) and
// the gates the step computed, which the BPTT does not read.
extern "C" int lstm_scan_residuals(const void* xw, const void* w_h, void* out,
                                   float* gates, float* c_seq,
                                   const int* lengths, int batch, int frames,
                                   int hidden, int reverse, int bf16, int rows,
                                   int resident, cudaStream_t stream) {
  return run(xw, w_h, out, gates, c_seq, lengths, Carry{}, bf16, 1, resident,
             Launch{1, reverse ? 0 : 1, batch, frames, hidden, rows, stream,
                    nullptr});
}

// Kernel E from a carry, as lstm_scan_carried is kernel B from one: the
// training forward of a carried recurrence (chunks that thread the state).
extern "C" int lstm_scan_residuals_carried(
    const void* xw, const void* w_h, void* out, float* gates, float* c_seq,
    const int* lengths, const float* c0, const float* h0, float* c_last,
    float* h_last, int batch, int frames, int hidden, int reverse, int bf16,
    int rows, int resident, cudaStream_t stream) {
  if (c0 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(xw, w_h, out, gates, c_seq, lengths,
             Carry{c0, h0, c_last, h_last}, bf16, 1, resident,
             Launch{1, reverse ? 0 : 1, batch, frames, hidden, rows, stream,
                    nullptr});
}

// Kernel E over `groups` sequences in one launch, as lstm_scan_grouped:
// gates (groups, batch, frames, 4 * hidden) and c_seq (groups, batch,
// frames, hidden); `lengths` (null, or int32 (batch)) are every group's.
extern "C" int lstm_scan_residuals_grouped(const void* xw, const void* w_h,
                                           void* out, float* gates,
                                           float* c_seq, const int* lengths,
                                           int groups, int reverse_from,
                                           int batch, int frames, int hidden,
                                           int bf16, int rows, int resident,
                                           cudaStream_t stream) {
  return run(xw, w_h, out, gates, c_seq, lengths, Carry{}, bf16, 1, resident,
             Launch{groups, reverse_from, batch, frames, hidden, rows, stream,
                    nullptr});
}

// How many clusters of the launch configuration for (hidden, dtype, rows,
// resident) the card holds at once (cudaOccupancyMaxActiveClusters), into
// *clusters. Returns the CUDA error of the query.
extern "C" int lstm_scan_max_active_clusters(int hidden, int bf16,
                                             int residuals, int rows,
                                             int resident, int* clusters) {
  *clusters = 0;
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, Carry{},
             bf16, residuals, resident,
             Launch{1, 1, kCluster * rows, 1, hidden, rows, nullptr,
                    clusters});
}

// Shared-memory bytes of one CTA; ops/lstm_kernel.py computes the same.
extern "C" int lstm_scan_smem(int hidden, int bf16, int rows, int resident) {
  return static_cast<int>(
      scan_geometry(hidden, bf16 ? 2 : 4, rows, resident != 0).bytes);
}
