// LSTM backpropagation through time for Hopper (sm_90a).
//
// Replaces: amt_tools_tpu/ops/pallas_lstm.py, _lstm_bwd_kernel (pallas_call
// in _lstm_grad_bwd; kernel F). From the residuals of the forward (kernel E
// in lstm_scan.cu: the float32 gate activations i, f, g, o and cell states
// c_t) and the output gradient dout, it walks the sequence in the opposite
// order from the forward with float32 carries dh and dc, and at each step t
//   dh   = dout[t] + dh_carry
//   da_o = dh * tanh(c_t) * o * (1 - o)
//   dc   = dc_carry + dh * o * (1 - tanh(c_t)^2)
//   da_i = dc * g * i * (1 - i)
//   da_g = dc * i * (1 - g^2)
//   da_f = dc * c_prev * f * (1 - f)
//   dc_carry = dc * f
//   da[t] = [da_i, da_f, da_g, da_o]             written as float32
//   dh_carry = round(da[t]) @ W_h^T               float32 accumulation
// where round is the bf16 rounding in bf16 mode (W_h^T then bf16) and the
// identity in float32 mode, and c_prev is c at the forward's previous step
// (t - 1, or t + 1 for a reverse forward), zero at the sequence's first
// step. dW_h = sum_t h_prev^T da stays one matmul outside the kernel.
//
// What bounds it on this card: at the training shape (B = 8, T = 625,
// H = 256, float32) it reads the gates (20.5 MB), c and dout (5.1 MB each)
// and writes da (20.5 MB), 0.015 ms at 3.35 TB/s, and does 2.6 GFLOP of
// recurrent products, 0.039 ms at the 67 TFLOP/s float32 peak. Neither is
// the floor: the 625 steps depend on each other, so the time is 625 times
// the latency of one step.
//
// Design: the mirror of kernel B's cluster (lstm_scan.cu). A thread-block
// cluster of 8 CTAs owns R batch rows for the whole sequence, and the
// clusters never wait on each other.
//   - CTA j owns hidden units [j H/8, (j+1) H/8). The gate gradients of its
//     units need only their own gates, c_t, c_prev, dout and carries, so dc
//     stays in the CTA's shared memory and dh is formed there. Its product
//     dh_carry[u] = sum_k da[k] W_h^T[k, u] needs all 4H of da, so the CTA
//     keeps the slice W_h^T[:, jH/8 : (j+1)H/8] (4H x H/8: 128 KiB float32,
//     64 KiB bf16 at H = 256, B's bytes) in shared memory, loaded once.
//     Where it does not fit (float32 above H = 256, bf16 above H = 352)
//     the same body streams it from L2 every step in chunks of rows through
//     two shared buffers (kResident = false).
//   - What crosses CTAs each step is da, not dh: each CTA sends its
//     R x 4 x H/8 gate gradients (in bf16 mode rounded to bf16, exactly
//     what the product reads) into the next-step da buffer of all 8 CTAs
//     through distributed shared memory, in 16-byte pieces. The sum over
//     4H then runs inside one CTA in a fixed order, so the result is the
//     same run to run (a reduce-scatter of partial dh would sum across
//     CTAs).
//   - One cluster barrier a step; da is double-buffered, so one barrier
//     suffices. Its arrive (release) follows the DSMEM stores; the float32
//     da goes to device memory between the arrive and the wait.
//   - The product, M = the CTA's units (padded to 16), N = the batch rows
//     (8 a tile), K = 4H:
//       bf16: mma.sync m16n8k16 with float32 accumulation, the W_h^T slice
//       by ldmatrix.trans from shared memory, da read as B fragments;
//       float32: FFMA, no TF32, one thread a unit and k group;
//     in both, the k steps are dealt round robin over `slices` groups of
//     warps (16 warps at H = 256), whose partial sums the cell update adds
//     in a fixed order (slice 0, 1, ...).
//   - The residuals of the next step (R x 4 x H/8 gates, c_t, c_prev and
//     dout of the CTA's units) are copied by cp.async into a second buffer
//     while the current step runs, c_prev straight from c_seq.
//   - The step walking first has no carry, so it skips the product; the
//     step walking last sends nothing.
//   - R is chosen by the wrapper (ops/lstm_kernel.py) so that every cluster
//     is resident in one wave (cudaOccupancyMaxActiveClusters at this
//     launch's shared memory); at the training batch B = 8 that is 8
//     clusters of one row, 64 SMs.
// Exactly T steps run, so a ragged T needs no padding. H is a multiple of
// 16 up to 1024; a CTA then owns an even number of units, and where they
// are fewer than 16 (H = 16, 48) the padded unit rows of the product are
// zero and never read.
//
// Groups: G independent sequences with their own W_h^T in one launch, as in
// lstm_scan.cu (blockIdx.y the group, its slabs of every tensor, the groups
// from `reverse_from` on with a reverse forward); G = 1 is the ungrouped
// launch.
//
// Per-row lengths (kMasked, ungrouped or grouped): the gradient of kernel
// E's masked forward, in which row b kept its carry and wrote 0 from
// t = lengths[b] on. At such a step the row writes da = 0, reads no dout
// and passes its dh and dc carries through: dc stays in its buffer, and dh
// goes to a held buffer (`dh` below), which the row's next step reads in
// place of the product (the product of a zero da is not the carry). The
// row still takes part in every product, exchange and cluster barrier:
// its cluster exchanges da through DSMEM each step, so no row can leave
// early. A reverse forward's first valid step (t = len - 1) reads c_prev
// at t = len, a masked step, where kernel E wrote the carry it kept.
//
// A carry (kCarry, one group): the gradient of kernel E's carried forward.
// c_prev at the forward's first step reads c0 in place of zero; the walk
// starts from the final carry's gradient (dc_last, dh_last) in place of
// zeros. Step s forms dh_carry only for s > 0, from the da of step s - 1,
// so after the last step the kernel exchanges that step's da too and runs
// one more carry product: dh0, the initial h's gradient (the held dh of a
// row whose last walked step was masked). dc0 is the last dc * f. The cost
// is one more DSMEM exchange and product a launch. A row of length 0 passes
// (dc_last, dh_last) through as (dc0, dh0).
//
// The launch without either flag compiles to the code without them, so it
// stays what it was bit for bit; with either, the CTA holds the dh buffer,
// which the wrapper's cluster plan sizes (ops/lstm_kernel.py, `hold`).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kMaxRows = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copy of one 16-byte or 4-byte piece; zero-filled when
// !valid (a zero-byte source reads nothing)
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool wide, bool valid = true) {
  if (wide) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

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

__host__ __device__ constexpr size_t round16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared-memory layout of one CTA, shared by the host launch and the kernel
// (ops/lstm_kernel.py bptt_geometry mirrors it, and a card test holds the
// two equal). The kernel computes it, as kernel B does, so that the parts
// known at compile time fold to constants. Offsets and sizes are in bytes
// and multiples of 16; T is the dtype of W_h^T, dout and the exchanged da.
//   w:     the W_h^T slice, rows k x units_pad local columns (padded by 16
//          bytes a row). Resident: all 4H rows; streamed: two chunks of
//          `chunk` rows.
//   da:    two buffers of row_pad x 4H values (+16 bytes a row), row r the
//          exchanged da of batch row r of the cluster, gate q of unit v at
//          column q H + v.
//   res:   two buffers of the step's residuals: gates R x 4 x units,
//          c_t and c_prev R x units (float32), dout R x units (T).
//   stage: R x 4 x units float32 da of the step; xstage (bf16 only) the
//          same rounded to bf16, what the exchange sends.
//   red:   slices x row_pad x units_pad float32 partial sums of dh_carry.
//   dc:    R x units float32, the dc carry.
//   dh:    (masked or carried launches only) R x units float32, the dh
//          carry a masked step passes on, or the walk starts from.
struct BpttGeometry {
  int units;
  int units_pad;
  int slices;
  int threads;
  int chunk;       // rows of W_h^T a chunk (4H when resident)
  int w_stride;    // elements
  int da_stride;   // elements
  int row_pad;
  size_t res_gates, res_c, res_dout, res_bytes;  // parts of one buffer
  size_t w_off, da_off, res_off, stage_off, xstage_off, red_off, dc_off,
      dh_off, bytes;
};

__host__ __device__ inline BpttGeometry bptt_geometry(int hidden, int size,
                                                      int rows, bool resident,
                                                      bool hold) {
  BpttGeometry g;
  const int four_h = 4 * hidden;
  g.units = hidden / kCluster;
  g.units_pad = (g.units + 15) / 16 * 16;
  g.chunk = resident ? four_h : (size == 2 ? 128 : 64);
  if (g.chunk > four_h) g.chunk = four_h;
  g.slices = 1;
  if (size == 2) {
    // warps = (units_pad / 16) m-tiles x slices; a slice takes whole
    // 16-row k steps
    const int m_tiles = g.units_pad / 16;
    while (2 * g.slices * m_tiles <= kMaxWarps &&
           (g.chunk / 16) % (2 * g.slices) == 0) {
      g.slices *= 2;
    }
    g.threads = 32 * m_tiles * g.slices;
  } else {
    // one thread a (unit, slice); a slice takes whole 4-row k steps
    while (2 * g.slices * g.units_pad <= kMaxThreads &&
           g.chunk % (8 * g.slices) == 0) {
      g.slices *= 2;
    }
    g.threads = g.units_pad * g.slices;
  }
  g.w_stride = g.units_pad + 16 / size;
  g.da_stride = four_h + 16 / size;
  g.row_pad = size == 2 ? (rows <= 8 ? 8 : 16) : rows;
  g.res_gates = round16(static_cast<size_t>(rows) * 4 * g.units * 4);
  g.res_c = round16(static_cast<size_t>(rows) * g.units * 4);
  g.res_dout = round16(static_cast<size_t>(rows) * g.units * size);
  g.res_bytes = g.res_gates + 2 * g.res_c + g.res_dout;
  const size_t w_rows = resident ? four_h : 2 * g.chunk;
  g.w_off = 0;
  g.da_off = g.w_off + w_rows * g.w_stride * size;
  g.res_off = g.da_off + 2 * static_cast<size_t>(g.row_pad) * g.da_stride * size;
  g.stage_off = g.res_off + 2 * g.res_bytes;
  g.xstage_off = g.stage_off + g.res_gates;
  g.red_off = g.xstage_off +
              (size == 2 ? round16(static_cast<size_t>(rows) * 4 * g.units * 2)
                         : 0);
  g.dc_off = g.red_off + static_cast<size_t>(g.slices) * g.row_pad *
                             g.units_pad * sizeof(float);
  g.dh_off = g.dc_off + g.res_c;
  g.bytes = g.dh_off + (hold ? g.res_c : 0);
  return g;
}

// Copy rows [k0, k0 + rows) of this CTA's columns of W_h^T into `dst`
template <typename T>
__device__ __forceinline__ void load_w_rows(T* dst, const T* w_ht, int hidden,
                                            const BpttGeometry& geo, int rank,
                                            int k0, int rows, bool wide) {
  const int vec = (wide ? 16 : 4) / static_cast<int>(sizeof(T));
  const int per_row = geo.units / vec;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
    const int kk = idx / per_row;
    const int u = (idx - kk * per_row) * vec;
    copy_async(dst + kk * geo.w_stride + u,
               w_ht + static_cast<size_t>(k0 + kk) * hidden +
                   rank * geo.units + u,
               wide);
  }
}

// Copy `count` spans of `len` values a row for the cluster's rows: span i
// of batch row b from src_of(b, i) to dst + (r * count + i) * len, or
// zeros where !valid (src_of then only names a valid address)
template <typename T, typename Src>
__device__ __forceinline__ void load_spans(T* dst, int rows, int row0,
                                           int batch, int count, int len,
                                           bool wide, bool valid,
                                           Src src_of) {
  const int vec = (wide ? 16 : 4) / static_cast<int>(sizeof(T));
  const int pieces = len / vec;
  const int per_row = count * pieces;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
    const int r = idx / per_row;
    if (row0 + r >= batch) break;
    const int rem = idx - r * per_row;
    const int i = rem / pieces;
    const int v = (rem - i * pieces) * vec;
    copy_async(dst + (r * count + i) * len + v, src_of(row0 + r, i) + v, wide,
               valid);
  }
}

// The residuals of step t for the cluster's rows into one buffer
template <bool kCarry, typename T>
__device__ __forceinline__ void load_residuals(
    unsigned char* buf, const float* gates, const float* c_seq, const T* dout,
    const float* c0, int batch, int frames, int hidden, int row0, int rows,
    int t, int t_prev, const BpttGeometry& geo, int rank) {
  const int units = geo.units;
  const int col = rank * units;
  const bool wide32 = units % 4 == 0;
  const bool wide_t = (units * sizeof(T)) % 16 == 0;
  float* g_dst = reinterpret_cast<float*>(buf);
  float* c_dst = reinterpret_cast<float*>(buf + geo.res_gates);
  float* p_dst = reinterpret_cast<float*>(buf + geo.res_gates + geo.res_c);
  T* o_dst = reinterpret_cast<T*>(buf + geo.res_gates + 2 * geo.res_c);
  load_spans(g_dst, rows, row0, batch, 4, units, wide32, true,
             [&](int b, int q) {
               return gates + (static_cast<size_t>(b) * frames + t) * 4 *
                                  hidden + q * hidden + col;
             });
  load_spans(c_dst, rows, row0, batch, 1, units, wide32, true,
             [&](int b, int) {
               return c_seq + (static_cast<size_t>(b) * frames + t) * hidden +
                      col;
             });
  // c_prev: at the sequence's first step zero, or the initial cell state
  // of a carried forward
  const bool has_prev = t_prev >= 0 && t_prev < frames;
  load_spans(p_dst, rows, row0, batch, 1, units, wide32, has_prev || kCarry,
             [&](int b, int) {
               if (kCarry && !has_prev) {
                 return c0 + static_cast<size_t>(b) * hidden + col;
               }
               return c_seq + (static_cast<size_t>(b) * frames +
                               (has_prev ? t_prev : t)) * hidden + col;
             });
  load_spans(o_dst, rows, row0, batch, 1, units, wide_t, true,
             [&](int b, int) {
               return dout + (static_cast<size_t>(b) * frames + t) * hidden +
                      col;
             });
}

// Partial dh_carry over W rows [k0, k0 + rows) of the chunk `w` (chunk
// local) against da columns k0 .. (global), for this thread's share
template <bool kBf16, int kRowTiles, typename T>
__device__ __forceinline__ void carry_products(
    float (&acc)[2][kRowTiles][4], float (&facc)[8 * kRowTiles], const T* w,
    const T* da, const BpttGeometry& geo, int k0, int rows, int n_rows) {
  if constexpr (kBf16) {
    const int lane = threadIdx.x & 31;
    const int m_tiles = geo.units_pad / 16;
    const int warp = threadIdx.x >> 5;
    const int mt = warp % m_tiles;
    const int slice = warp / m_tiles;
    const int g = lane >> 2;
    const int tq = lane & 3;
    // A from ldmatrix.trans: lanes 0-7 / 8-15 / 16-23 / 24-31 address the
    // (k 0-7, m 0-7) / (k 0-7, m 8-15) / (k 8-15, m 0-7) / (k 8-15, m 8-15)
    // 8x8 matrices of the 16 x 16 tile, stored k-major
    const int a_row = (lane & 7) + ((lane >> 4) << 3);
    const int a_col = 16 * mt + ((lane >> 3) & 1) * 8;
    auto k_step = [&](int ks, float (&d)[kRowTiles][4]) {
      unsigned a[4];
      ldmatrix_x4_trans(a, smem_addr(w + (16 * ks + a_row) * geo.w_stride +
                                     a_col));
#pragma unroll
      for (int n = 0; n < kRowTiles; ++n) {
        const T* b = da + (8 * n + g) * geo.da_stride + k0 + 16 * ks + 2 * tq;
        mma_bf16(d[n], a, *reinterpret_cast<const unsigned*>(b),
                 *reinterpret_cast<const unsigned*>(b + 8));
      }
    };
    // Two accumulators take alternate k steps of the slice, which halves
    // the chain of dependent mma
    const int steps = rows / 16;
    for (int ks = slice; ks < steps; ks += 2 * geo.slices) {
      k_step(ks, acc[0]);
      if (ks + geo.slices < steps) k_step(ks + geo.slices, acc[1]);
    }
  } else {
    const int u = threadIdx.x % geo.units_pad;
    const int slice = threadIdx.x / geo.units_pad;
    const int steps = rows / 4;
    for (int ks = slice; ks < steps; ks += geo.slices) {
      const T* wr = w + 4 * ks * geo.w_stride + u;
      const float wk[4] = {wr[0], wr[geo.w_stride], wr[2 * geo.w_stride],
                           wr[3 * geo.w_stride]};
#pragma unroll
      for (int r = 0; r < 8 * kRowTiles; ++r) {
        if (r < n_rows) {
          const float4 d = *reinterpret_cast<const float4*>(
              da + r * geo.da_stride + k0 + 4 * ks);
          facc[r] = fmaf(d.x, wk[0], facc[r]);
          facc[r] = fmaf(d.y, wk[1], facc[r]);
          facc[r] = fmaf(d.z, wk[2], facc[r]);
          facc[r] = fmaf(d.w, wk[3], facc[r]);
        }
      }
    }
  }
}

// The carry of kCarry launches: c0, the forward's initial cell state (the
// first step's c_prev), and the gradient of its final carry (dc_last,
// dh_last) read at the start; the gradient of its initial carry (dc0, dh0)
// written at the end; each float32 (batch, hidden)
struct Carry {
  const float* c0;
  const float* dc_last;
  const float* dh_last;
  float* dc0;
  float* dh0;
};

template <typename T, bool kBf16, bool kResident, int kRowTiles, bool kMasked,
          bool kCarry>
__global__ void __launch_bounds__(kMaxThreads)
lstm_bptt_kernel(const float* __restrict__ gates,
                 const float* __restrict__ c_seq, const T* __restrict__ dout,
                 const T* __restrict__ w_ht, float* __restrict__ da,
                 const int* __restrict__ lengths, Carry state, int batch,
                 int frames, int hidden, int reverse_from, int rows) {
  constexpr bool kHold = kMasked || kCarry;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const BpttGeometry geo =
      bptt_geometry(hidden, sizeof(T), rows, kResident, kHold);
  // Group blockIdx.y runs its own slab of the residuals, dout, W_h^T and
  // da; the groups from reverse_from on had a reverse forward. The lengths
  // are every group's.
  const int group = static_cast<int>(blockIdx.y);
  const bool reverse = group >= reverse_from;
  const size_t seq = static_cast<size_t>(batch) * frames * hidden;
  gates += group * 4 * seq;
  c_seq += group * seq;
  dout += group * seq;
  w_ht += static_cast<size_t>(group) * 4 * hidden * hidden;
  da += group * 4 * seq;
  T* w_buf = reinterpret_cast<T*>(smem + geo.w_off);
  T* da_buf = reinterpret_cast<T*>(smem + geo.da_off);
  unsigned char* res_buf = smem + geo.res_off;
  float* stage = reinterpret_cast<float*>(smem + geo.stage_off);
  T* xstage = kBf16 ? reinterpret_cast<T*>(smem + geo.xstage_off)
                    : reinterpret_cast<T*>(stage);
  float* red = reinterpret_cast<float*>(smem + geo.red_off);
  float* dc_buf = reinterpret_cast<float*>(smem + geo.dc_off);
  float* dh_buf = reinterpret_cast<float*>(smem + geo.dh_off);

  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kCluster) * rows;
  const int units = geo.units;
  const int four_h = 4 * hidden;
  const bool wide_w = (units * sizeof(T)) % 16 == 0;
  const int da_size = geo.row_pad * geo.da_stride;
  const int n_chunks = (four_h + geo.chunk - 1) / geo.chunk;
  const int w_chunk = geo.chunk * geo.w_stride;
  // The forward walked t = 0..T-1 (reverse: T-1..0); this walks back
  auto step_t = [&](int s) { return reverse ? s : frames - 1 - s; };
  auto prev_t = [&](int t) { return reverse ? t + 1 : t - 1; };
  // kMasked: the true length of batch row r of the cluster
  auto row_len = [&](int r) {
    return kMasked && row0 + r < batch ? lengths[row0 + r] : frames;
  };

  for (size_t i = threadIdx.x; i < geo.bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_w_rows(w_buf, w_ht, hidden, geo, rank, 0, geo.chunk, wide_w);
  load_residuals<kCarry>(res_buf, gates, c_seq, dout, state.c0, batch, frames,
                         hidden, row0, rows, step_t(0), prev_t(step_t(0)),
                         geo, rank);
  cp_async_commit();
  if constexpr (kCarry) {  // the walk starts from the final carry's gradient
    for (int idx = threadIdx.x; idx < rows * units; idx += blockDim.x) {
      const int r = idx / units;
      if (row0 + r >= batch) continue;
      const size_t at = static_cast<size_t>(row0 + r) * hidden + rank * units +
                        (idx - r * units);
      dc_buf[idx] = state.dc_last[at];
      dh_buf[idx] = state.dh_last[at];
    }
  }
  cp_async_wait<0>();
  // Every CTA of the cluster is running and zeroed before any remote write
  cluster.sync();

  // dh_carry of step s (the partial sums in `red`) from the da of step s - 1
  // in `da_prev`; `more`: a product follows, whose first W chunk a
  // streamed slice loads during this one's last
  auto carry_partials = [&](int s, const T* da_prev, bool more) {
    float acc[2][kRowTiles][4];
    float facc[8 * kRowTiles];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int n = 0; n < kRowTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 8 * kRowTiles; ++r) facc[r] = 0.f;

    if constexpr (kResident) {
      carry_products<kBf16, kRowTiles>(acc, facc, w_buf, da_prev, geo, 0,
                                       four_h, rows);
    } else {
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int slot = ((s - 1) * n_chunks + ci) & 1;
        cp_async_wait<0>();
        __syncthreads();
        // The next chunk (the first again after the last, for the next
        // product) into the slot everyone has finished with
        const int next = ci + 1 < n_chunks ? ci + 1 : 0;
        if (ci + 1 < n_chunks || more) {
          const int k_next = next * geo.chunk;
          load_w_rows(w_buf + (slot ^ 1) * w_chunk, w_ht, hidden, geo, rank,
                      k_next, min(geo.chunk, four_h - k_next), wide_w);
        }
        cp_async_commit();
        const int k0 = ci * geo.chunk;
        carry_products<kBf16, kRowTiles>(acc, facc, w_buf + slot * w_chunk,
                                         da_prev, geo, k0,
                                         min(geo.chunk, four_h - k0), rows);
      }
    }

    // This thread's partial sums, for the cell update to add in slice order
    if constexpr (kBf16) {
      const int lane = threadIdx.x & 31;
      const int m_tiles = geo.units_pad / 16;
      const int warp = threadIdx.x >> 5;
      const int slice = warp / m_tiles;
      const int u = 16 * (warp % m_tiles) + (lane >> 2);
      float* dst = red + slice * geo.row_pad * geo.units_pad;
#pragma unroll
      for (int n = 0; n < kRowTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // C fragment: unit g (e < 2) or g + 8, batch row 2 tq + (e & 1)
          const int r = 8 * n + 2 * (lane & 3) + (e & 1);
          dst[r * geo.units_pad + u + 8 * (e >> 1)] =
              acc[0][n][e] + acc[1][n][e];
        }
    } else {
      const int u = threadIdx.x % geo.units_pad;
      const int slice = threadIdx.x / geo.units_pad;
      float* dst = red + slice * geo.row_pad * geo.units_pad;
#pragma unroll
      for (int r = 0; r < 8 * kRowTiles; ++r) {
        if (r < rows) dst[r * geo.units_pad + u] = facc[r];
      }
    }
  };

  for (int s = 0; s < frames; ++s) {
    const int t = step_t(s);
    const T* da_cur = da_buf + (s & 1) * da_size;
    T* da_next = da_buf + ((s & 1) ^ 1) * da_size;
    const unsigned char* res = res_buf + (s & 1) * geo.res_bytes;

    // Next step's residuals into the other buffer, during this step
    if (s + 1 < frames) {
      load_residuals<kCarry>(res_buf + ((s + 1) & 1) * geo.res_bytes, gates,
                             c_seq, dout, state.c0, batch, frames, hidden,
                             row0, rows, step_t(s + 1),
                             prev_t(step_t(s + 1)), geo, rank);
    }
    cp_async_commit();

    // dh_carry of this step from the previous step's da (none at s = 0);
    // a carried launch runs one more product after the last step
    if (s > 0) carry_partials(s, da_cur, s + 1 < frames || kCarry);

    // This step's residuals have landed (only younger groups may be in
    // flight: the next step's residuals, or its first W chunk)
    cp_async_wait<1>();
    __syncthreads();

    // The gate gradients of the CTA's units, one (row, unit) a thread
    const float* r_gates = reinterpret_cast<const float*>(res);
    const float* r_c = reinterpret_cast<const float*>(res + geo.res_gates);
    const float* r_prev =
        reinterpret_cast<const float*>(res + geo.res_gates + geo.res_c);
    const T* r_dout =
        reinterpret_cast<const T*>(res + geo.res_gates + 2 * geo.res_c);
    for (int idx = threadIdx.x; idx < rows * units; idx += blockDim.x) {
      const int r = idx / units;
      const int u = idx - r * units;
      float carry = 0.f;
      if (s > 0) {
        for (int sl = 0; sl < geo.slices; ++sl) {
          carry += red[(sl * geo.row_pad + r) * geo.units_pad + u];
        }
      }
      float* st = stage + r * 4 * units + u;
      if constexpr (kHold) {
        // The walk's first step starts from the held dh (the final carry's
        // gradient, or zero), and so does a step after a masked one: the
        // product of a masked step's da is not its carry
        const int len = row_len(r);
        const int t_before = reverse ? t - 1 : t + 1;
        if (s == 0 || (kMasked && t_before >= len)) carry = dh_buf[idx];
        if (kMasked && t >= len) {
          // A masked step kept the forward's carry: da = 0, dout unread,
          // and dh and dc pass through
          dh_buf[idx] = carry;
          st[0] = st[units] = st[2 * units] = st[3 * units] = 0.f;
          if constexpr (kBf16) {
            T* xs = xstage + r * 4 * units + u;
            xs[0] = xs[units] = xs[2 * units] = xs[3 * units] =
                from_float<T>(0.f);
          }
          continue;
        }
      }
      const float* gq = r_gates + r * 4 * units + u;
      const float i_g = gq[0];
      const float f_g = gq[units];
      const float g_g = gq[2 * units];
      const float o_g = gq[3 * units];
      const float c_t = r_c[idx];
      const float c_prev = r_prev[idx];
      const float tanh_c = tanhf(c_t);

      const float dh = to_float(r_dout[idx]) + carry;
      const float da_o = dh * tanh_c * o_g * (1.f - o_g);
      const float dc = dc_buf[idx] + dh * o_g * (1.f - tanh_c * tanh_c);
      const float da_i = dc * g_g * i_g * (1.f - i_g);
      const float da_g = dc * i_g * (1.f - g_g * g_g);
      const float da_f = dc * c_prev * f_g * (1.f - f_g);
      dc_buf[idx] = dc * f_g;

      st[0] = da_i;
      st[units] = da_f;
      st[2 * units] = da_g;
      st[3 * units] = da_o;
      if constexpr (kBf16) {
        T* xs = xstage + r * 4 * units + u;
        xs[0] = from_float<T>(da_i);
        xs[units] = from_float<T>(da_f);
        xs[2 * units] = from_float<T>(da_g);
        xs[3 * units] = from_float<T>(da_o);
      }
    }
    __syncthreads();

    // The step's da (as the product reads it), through distributed shared
    // memory, into the next-step da buffer of every CTA of the cluster,
    // then released to the cluster. The last step has no next, unless the
    // launch is carried: its da then feeds the initial carry's product.
    const bool exchange = kCarry || s + 1 < frames;
    if (exchange) {
      const int piece = wide_w ? 16 : 4;
      const int per_gate = units * static_cast<int>(sizeof(T)) / piece;
      const int per_dest = rows * 4 * per_gate;
      for (int idx = threadIdx.x; idx < kCluster * per_dest;
           idx += blockDim.x) {
        const int dest = idx / per_dest;
        const int rem = idx - dest * per_dest;
        const int rq = rem / per_gate;  // r * 4 + q
        const int v = rem - rq * per_gate;
        const int r = rq >> 2;
        const int q = rq & 3;
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(xstage + rq * units) +
            v * piece;
        T* remote = cluster.map_shared_rank(da_next, dest);
        unsigned char* dst =
            reinterpret_cast<unsigned char*>(remote + r * geo.da_stride +
                                             q * hidden + rank * units) +
            v * piece;
        if (wide_w) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          *reinterpret_cast<unsigned*>(dst) =
              *reinterpret_cast<const unsigned*>(src);
        }
      }
      cluster_arrive();
    }

    // The float32 da to device memory after the arrive, so its release
    // does not wait on these stores
    const bool wide32 = units % 4 == 0;
    const int vec = wide32 ? 4 : 1;
    const int per_gate = units / vec;
    for (int idx = threadIdx.x; idx < rows * 4 * per_gate;
         idx += blockDim.x) {
      const int rq = idx / per_gate;
      const int v = (idx - rq * per_gate) * vec;
      const int r = rq >> 2;
      const int q = rq & 3;
      if (row0 + r >= batch) continue;
      float* dst = da + (static_cast<size_t>(row0 + r) * frames + t) * four_h +
                   q * hidden + rank * units + v;
      const float* src = stage + rq * units + v;
      if (wide32) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        *dst = *src;
      }
    }
    if (exchange) cluster_wait();
  }

  // The gradient of the initial carry, after the loop so that no step pays
  // for it: dh0 is the product of the last step's da (the held dh where
  // that step was masked), dc0 the dc carry
  if constexpr (kCarry) {
    carry_partials(frames, da_buf + (frames & 1) * da_size, false);
    __syncthreads();
    const int t_last = step_t(frames - 1);
    for (int idx = threadIdx.x; idx < rows * units; idx += blockDim.x) {
      const int r = idx / units;
      const int u = idx - r * units;
      if (row0 + r >= batch) continue;
      float dh0 = 0.f;
      for (int sl = 0; sl < geo.slices; ++sl) {
        dh0 += red[(sl * geo.row_pad + r) * geo.units_pad + u];
      }
      if (kMasked && t_last >= row_len(r)) dh0 = dh_buf[idx];
      const size_t at =
          static_cast<size_t>(row0 + r) * hidden + rank * units + u;
      state.dh0[at] = dh0;
      state.dc0[at] = dc_buf[idx];
    }
  }
}

// The launch carries the group count and the first group whose forward
// was reversed (G = 1 is the ungrouped launch); blockIdx.y is the group, so
// no cluster spans two groups.
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

template <typename T, bool kBf16, bool kResident, int kRowTiles, bool kMasked,
          bool kCarry>
int launch(const float* gates, const float* c_seq, const void* dout,
           const void* w_ht, float* da, const int* lengths, Carry carry,
           const Launch& l) {
  const BpttGeometry geo = bptt_geometry(l.hidden, sizeof(T), l.rows,
                                         kResident, kMasked || kCarry);
  if (geo.bytes > kMaxSharedBytes || geo.threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel =
      lstm_bptt_kernel<T, kBf16, kResident, kRowTiles, kMasked, kCarry>;
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
  status = cudaLaunchKernelEx(&config, kernel, gates, c_seq,
                              static_cast<const T*>(dout),
                              static_cast<const T*>(w_ht), da, lengths, carry,
                              l.batch, l.frames, l.hidden, l.reverse_from,
                              l.rows);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBf16, bool kMasked, bool kCarry>
int dispatch(const float* gates, const float* c_seq, const void* dout,
             const void* w_ht, float* da, const int* lengths, Carry carry,
             int resident, const Launch& l) {
  if (l.hidden % 16 || l.hidden < 16 || l.rows < 1 || l.rows > kMaxRows ||
      l.groups < 1 || l.groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (resident) {
    if (l.rows <= 8) {
      return launch<T, kBf16, true, 1, kMasked, kCarry>(
          gates, c_seq, dout, w_ht, da, lengths, carry, l);
    }
    return launch<T, kBf16, true, 2, kMasked, kCarry>(
        gates, c_seq, dout, w_ht, da, lengths, carry, l);
  }
  if (l.rows <= 8) {
    return launch<T, kBf16, false, 1, kMasked, kCarry>(
        gates, c_seq, dout, w_ht, da, lengths, carry, l);
  }
  return launch<T, kBf16, false, 2, kMasked, kCarry>(gates, c_seq, dout, w_ht,
                                                     da, lengths, carry, l);
}

// With lengths, a carry, both or neither: each combination is its own
// instantiation, so the launch without either compiles to the code without
// the flags. A carry is one group's. `hold` (an occupancy query only) asks
// for a masked launch's configuration.
template <typename T, bool kBf16>
int dispatch_flags(const float* gates, const float* c_seq, const void* dout,
                   const void* w_ht, float* da, const int* lengths,
                   Carry carry, int hold, int resident, const Launch& l) {
  if (carry.c0 != nullptr) {
    if (carry.dc_last == nullptr || carry.dh_last == nullptr ||
        carry.dc0 == nullptr || carry.dh0 == nullptr || l.groups != 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (lengths != nullptr) {
      return dispatch<T, kBf16, true, true>(gates, c_seq, dout, w_ht, da,
                                            lengths, carry, resident, l);
    }
    return dispatch<T, kBf16, false, true>(gates, c_seq, dout, w_ht, da,
                                           nullptr, carry, resident, l);
  }
  if (lengths != nullptr || hold) {
    return dispatch<T, kBf16, true, false>(gates, c_seq, dout, w_ht, da,
                                           lengths, carry, resident, l);
  }
  return dispatch<T, kBf16, false, false>(gates, c_seq, dout, w_ht, da,
                                          nullptr, carry, resident, l);
}

int run(const float* gates, const float* c_seq, const void* dout,
        const void* w_ht, float* da, const int* lengths, Carry carry,
        int hold, int bf16, int resident, const Launch& l) {
  if (bf16) {
    return dispatch_flags<__nv_bfloat16, true>(gates, c_seq, dout, w_ht, da,
                                               lengths, carry, hold, resident,
                                               l);
  }
  return dispatch_flags<float, false>(gates, c_seq, dout, w_ht, da, lengths,
                                      carry, hold, resident, l);
}

}  // namespace

// Kernel F over `groups` independent sequences in one launch: gates
// (groups, batch, frames, 4 * hidden) and c_seq (groups, batch, frames,
// hidden) as float32 from the forward with residuals, dout (groups, batch,
// frames, hidden) and w_ht (groups, 4 * hidden, hidden) both float32 or
// both bf16 (`bf16` != 0), and da (groups, batch, frames, 4 * hidden)
// float32, contiguous and 16-byte aligned on the device. The groups from
// `reverse_from` on had a reverse forward. `lengths` is null (every row ran
// all frames) or int32 (batch) on the device, each in [0, frames], every
// group's: row b has da = 0 from t = lengths[b] on, and carries its dh and
// dc through those steps. With c0 not null the forward was carried: c0 is
// its initial cell state, (dc_last, dh_last) the gradient of its final
// carry, which the walk starts from, and the launch writes (dc0, dh0), the
// gradient of the initial carry (all five float32 (batch, hidden) on the
// device); a carry is one group's, so `groups` is then 1. hidden is a
// multiple of 16; each cluster of 8 CTAs takes `rows` (1..16) batch rows of
// one group; `resident` keeps the W_h^T slice in shared memory (else it is
// streamed each step). Launches on `stream` and returns the first CUDA
// error of the set-up or the launch.
extern "C" int lstm_bptt(const float* gates, const float* c_seq,
                         const void* dout, const void* w_ht, float* da,
                         const int* lengths, const float* c0,
                         const float* dc_last, const float* dh_last,
                         float* dc0, float* dh0, int groups, int reverse_from,
                         int batch, int frames, int hidden, int bf16,
                         int rows, int resident, cudaStream_t stream) {
  return run(gates, c_seq, dout, w_ht, da, lengths,
             Carry{c0, dc_last, dh_last, dc0, dh0}, 0, bf16, resident,
             Launch{groups, reverse_from, batch, frames, hidden, rows, stream,
                    nullptr});
}

// How many clusters of the launch configuration for (hidden, dtype, rows,
// resident; `hold`: a masked or carried launch) the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters. Returns the CUDA error
// of the query.
extern "C" int lstm_bptt_max_active_clusters(int hidden, int bf16, int hold,
                                             int rows, int resident,
                                             int* clusters) {
  *clusters = 0;
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, Carry{},
             hold, bf16, resident,
             Launch{1, 1, kCluster * rows, 1, hidden, rows, nullptr,
                    clusters});
}

// Shared-memory bytes of one CTA (`hold`: of a masked or carried launch);
// ops/lstm_kernel.py computes the same.
extern "C" int lstm_bptt_smem(int hidden, int bf16, int rows, int resident,
                              int hold) {
  return static_cast<int>(bptt_geometry(hidden, bf16 ? 2 : 4, rows,
                                        resident != 0, hold != 0)
                              .bytes);
}
