// Whole-sequence GRU recurrence for Hopper (sm_90a), forward, over groups of
// independent sequences: kernel G.
//
// No TPU kernel stands behind it: the JAX package has no GRU. It serves the
// bidirectional GRUs of the High-resolution Piano Transcription model
// (ops/gru.py), whose recurrences run 6,001 dependent steps over a 60 s
// clip. From a zero carry, over hoisted input projections xw (B, T, 3H)
// that already hold b_ih and the hidden biases of the r and z gates, with
// recurrent weights W_h (H, 3H) (PyTorch's weight_hh transposed: gate
// columns r, z, n) and the n gate's hidden bias b_hn (H):
//   hp = h @ W_h
//   r = sigmoid(xw_r + hp_r);  z = sigmoid(xw_z + hp_z)
//   n = tanh(xw_n + r * (hp_n + b_hn))
//   h = n + z * (h - n)                  (torch.nn.GRU's order of operations)
// writing h as (B, T, H). Group g of G takes its own slab of xw, W_h, b_hn
// and out; the groups from `reverse_from` on walk t from T-1 down to 0 (a
// BiGRU's backward directions) and still write each h at its position.
//
// Numerics: h is float32 across the steps in both modes, and so is the gate
// arithmetic. bf16 xw: W_h is bf16, h is rounded to bf16 for the recurrent
// product (float32 accumulation), and the output is h rounded to bf16.
// float32 xw: float32 W_h and FFMA products, no TF32.
//
// Design: kernel B's (csrc/lstm_scan.cu), for three gates. A cluster of 8
// CTAs owns R batch rows of one group for the whole sequence.
//   - CTA j owns hidden units [j H/8, (j+1) H/8): their 3 x H/8 gate
//     columns, so the update of its units needs nothing from another CTA.
//     Its slice of W_h, H x 3H/8 (48 KiB in bf16 at H = 256), stays in
//     shared memory for the whole launch.
//   - Warp w owns units [8 w, 8 w + 8). Its 24 columns are local columns
//     24 w + 8 q + g (gate q of unit 8 w + g). In bf16 each step takes
//     mma.sync m16n8k16 with the W_h slice as the 16-row operand (ldmatrix
//     .trans) and the batch rows as n = 8 (an n-tile a 8 rows): m-tile 0
//     is the r and z columns, m-tile 1 the n columns and 8 columns past them
//     (the next warp's, or the row's padding), whose sums are not read. So
//     the r, z and n of one unit for two rows land in one thread's
//     accumulators. float32 takes FFMA in the same thread-to-(unit, rows)
//     map. Up to four n-tiles (R up to 32), so that a grouped launch's
//     clusters fit in one wave (8 groups of 64 rows: 24 clusters of 22 rows
//     where 16 rows make 32, over the 30 the card holds).
//   - xw of the next step is copied by cp.async into a second buffer while
//     the current step runs.
//   - h of the thread's unit and rows stays in registers as float32; the new
//     h goes to a staging buffer in T (the value the next product reads),
//     and from there, in 16-byte pieces, into the next-step h buffer of all
//     8 CTAs through distributed shared memory.
//   - One cluster barrier a step, h double-buffered; the output stores are
//     issued between its arrive and its wait.
// The rows a cluster (R, up to 32) are chosen by the wrapper
// (ops/gru_kernel.py) so that the launch's clusters fit in one wave where
// they can. H is a multiple of 16 whose slice fits in shared memory.
//
// What bounds it: the T dependent steps. At the serving shape (8 groups x
// 64 rows x 6001 steps, H = 256, bf16) a launch moves 1.6 GB and does
// 0.6 TFLOP of recurrent products, 0.5 ms at 3.35 TB/s; each step's chain
// (product, gates, exchange, barrier) takes microseconds.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kMaxRows = 32;
constexpr int kMaxThreads = 512;
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

__device__ __forceinline__ float sigmoid(float x) {
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

// Shared-memory layout of one CTA (ops/gru_kernel.py gru_geometry mirrors
// it; a card test holds the two equal). Bytes, each part a multiple of 16.
//   w:     H rows x (3 units_pad + 16 bytes) values, the W_h slice; local
//          column 24 w + 8 q + g is gate q of unit 8 w + g.
//   h:     two buffers of row_pad (R rounded up to 8) x (H + 16 bytes)
//          values, row r the h of batch row r of the cluster, as the
//          product reads it.
//   xw:    two buffers of R x 3 x units values.
//   stage: R x units values, the new h of the CTA's units.
struct GruGeometry {
  int units;
  int units_pad;
  int threads;
  int w_stride;  // elements
  int h_stride;  // elements
  int row_pad;
  size_t w_off, h_off, x_off, stage_off, bytes;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline GruGeometry gru_geometry(int hidden, int size,
                                                    int rows) {
  GruGeometry g;
  g.units = hidden / kCluster;
  g.units_pad = (g.units + 7) / 8 * 8;
  g.threads = 4 * g.units_pad;
  g.w_stride = 3 * g.units_pad + 16 / size;
  g.h_stride = hidden + 16 / size;
  g.row_pad = (rows + 7) / 8 * 8;
  g.w_off = 0;
  g.h_off = round16(static_cast<size_t>(hidden) * g.w_stride * size);
  g.x_off = g.h_off + round16(2 * static_cast<size_t>(g.row_pad) *
                              g.h_stride * size);
  g.stage_off =
      g.x_off + round16(2 * static_cast<size_t>(rows) * 3 * g.units * size);
  g.bytes = g.stage_off + round16(static_cast<size_t>(rows) * g.units * size);
  return g;
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool wide) {
  if (wide) {
    cp_async16(dst, src);
  } else {
    cp_async4(dst, src);
  }
}

__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src,
                                           bool wide) {
  if (wide) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
  }
}

// Copy this CTA's columns of all H rows of W_h into `dst`, laid out as
// GruGeometry says. Columns of units past `units` are never written.
template <typename T>
__device__ __forceinline__ void load_w(T* dst, const T* w_h, int hidden,
                                       const GruGeometry& geo, int rank,
                                       bool wide) {
  const int vec = (wide ? 16 : 4) / static_cast<int>(sizeof(T));
  const int per_gate = geo.units / vec;
  const int per_row = 3 * per_gate;
  for (int idx = threadIdx.x; idx < hidden * per_row; idx += blockDim.x) {
    const int k = idx / per_row;
    const int rem = idx - k * per_row;
    const int q = rem / per_gate;
    const int u = (rem - q * per_gate) * vec;
    const int col = 24 * (u >> 3) + 8 * q + (u & 7);
    copy_async(dst + k * geo.w_stride + col,
               w_h + static_cast<size_t>(k) * 3 * hidden + q * hidden +
                   rank * geo.units + u,
               wide);
  }
}

// Copy xw of step t for the cluster's rows into `dst` (R x 3 x units)
template <typename T>
__device__ __forceinline__ void load_xw(T* dst, const T* xw, int batch,
                                        int frames, int hidden, int row0,
                                        int rows, int t,
                                        const GruGeometry& geo, int rank,
                                        bool wide) {
  const int vec = (wide ? 16 : 4) / static_cast<int>(sizeof(T));
  const int per_gate = geo.units / vec;
  const int per_row = 3 * per_gate;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += blockDim.x) {
    const int r = idx / per_row;
    if (row0 + r >= batch) break;
    const int rem = idx - r * per_row;
    const int q = rem / per_gate;
    const int u = (rem - q * per_gate) * vec;
    copy_async(dst + (r * 3 + q) * geo.units + u,
               xw + (static_cast<size_t>(row0 + r) * frames + t) * 3 * hidden +
                   q * hidden + rank * geo.units + u,
               wide);
  }
}

// The recurrent products of this thread's unit and rows into gate[q][i]
template <bool kBf16, int kRowTiles, typename T>
__device__ __forceinline__ void gate_products(float (&gate)[3][2 * kRowTiles],
                                              const T* w, const T* h,
                                              const GruGeometry& geo,
                                              int hidden) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  if constexpr (kBf16) {
    // A from ldmatrix.trans: lanes 0-7 / 8-15 / 16-23 / 24-31 address the
    // (k 0-7, m 0-7) / (k 0-7, m 8-15) / (k 8-15, m 0-7) / (k 8-15, m 8-15)
    // 8x8 matrices of the 16 x 16 tile, stored k-major
    const int a_row = (lane & 7) + ((lane >> 4) << 3);
    const int a_col = 24 * warp + ((lane >> 3) & 1) * 8;
    float acc[2][kRowTiles][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < kRowTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    unsigned a_addr = smem_addr(w + a_row * geo.w_stride + a_col);
    const unsigned a_step = 16 * geo.w_stride * sizeof(T);
    const T* hk = h + g * geo.h_stride + 2 * tq;
    for (int kk = 0; kk < hidden; kk += 16, a_addr += a_step, hk += 16) {
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
    // m-tile 0 rows 0-7 / 8-15: gates r / z; m-tile 1 rows 0-7: gate n.
    // Columns (batch rows) 2 tq, 2 tq + 1 of each n-tile
#pragma unroll
    for (int n = 0; n < kRowTiles; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        gate[0][2 * n + e] = acc[0][n][e];
        gate[1][2 * n + e] = acc[0][n][2 + e];
        gate[2][2 * n + e] = acc[1][n][e];
      }
  } else {
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < 2 * kRowTiles; ++i) gate[q][i] = 0.f;
    const T* wc = w + 24 * warp + g;
    for (int kk = 0; kk < hidden; kk += 4) {
      float4 hv[2 * kRowTiles];
#pragma unroll
      for (int i = 0; i < 2 * kRowTiles; ++i) {
        const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
        hv[i] = *reinterpret_cast<const float4*>(h + r * geo.h_stride + kk);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const T* wr = wc + (kk + s) * geo.w_stride;
        const float wq[3] = {wr[0], wr[8], wr[16]};
#pragma unroll
        for (int i = 0; i < 2 * kRowTiles; ++i) {
          const float hk = s == 0 ? hv[i].x
                         : s == 1 ? hv[i].y
                         : s == 2 ? hv[i].z
                                  : hv[i].w;
#pragma unroll
          for (int q = 0; q < 3; ++q) gate[q][i] = fmaf(hk, wq[q], gate[q][i]);
        }
      }
    }
  }
}

template <typename T, bool kBf16, int kRowTiles>
__global__ void __launch_bounds__(kMaxThreads)
gru_scan_kernel(const T* __restrict__ xw, const T* __restrict__ w_h,
                const float* __restrict__ b_hn, T* __restrict__ out,
                int batch, int frames, int hidden, int reverse_from,
                int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const GruGeometry geo = gru_geometry(hidden, sizeof(T), rows);
  const int group = static_cast<int>(blockIdx.y);
  const bool reverse = group >= reverse_from;
  const size_t seq = static_cast<size_t>(batch) * frames * hidden;
  xw += group * 3 * seq;
  w_h += static_cast<size_t>(group) * hidden * 3 * hidden;
  b_hn += static_cast<size_t>(group) * hidden;
  out += group * seq;
  T* w_buf = reinterpret_cast<T*>(smem + geo.w_off);
  T* h_buf = reinterpret_cast<T*>(smem + geo.h_off);
  T* x_buf = reinterpret_cast<T*>(smem + geo.x_off);
  T* stage = reinterpret_cast<T*>(smem + geo.stage_off);

  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / kCluster) * rows;
  const int units = geo.units;
  const int lane = threadIdx.x & 31;
  const int u = 8 * (threadIdx.x >> 5) + (lane >> 2);
  const int tq = lane & 3;
  const bool unit_ok = u < units;
  const bool wide = (units * sizeof(T)) % 16 == 0;
  const int h_size = geo.row_pad * geo.h_stride;
  const int x_size = rows * 3 * units;

  // Zero everything (padding columns, h and the rows past the batch stay
  // zero), then start the copies of W and of step 0's xw
  for (size_t i = threadIdx.x; i < geo.bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  load_w(w_buf, w_h, hidden, geo, rank, wide);
  load_xw(x_buf, xw, batch, frames, hidden, row0, rows,
          reverse ? frames - 1 : 0, geo, rank, wide);
  cp_async_commit();
  cp_async_wait<0>();
  // Every CTA of the cluster is running and zeroed before any remote write
  cluster.sync();

  const float bias_n = unit_ok ? b_hn[rank * units + u] : 0.f;
  float h_reg[2 * kRowTiles];
#pragma unroll
  for (int i = 0; i < 2 * kRowTiles; ++i) h_reg[i] = 0.f;

  const int piece = wide ? 16 : 4;
  const int per_row = units * static_cast<int>(sizeof(T)) / piece;
  const int per_dest = rows * per_row;

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

    float gate[3][2 * kRowTiles];
    gate_products<kBf16, kRowTiles>(gate, w_buf, h_cur, geo, hidden);

    // This step's xw has landed (only the next step's may be in flight)
    cp_async_wait<1>();
    __syncthreads();

    const T* x_cur = x_buf + (s & 1) * x_size;
#pragma unroll
    for (int i = 0; i < 2 * kRowTiles; ++i) {
      const int r = 2 * tq + (i & 1) + 8 * (i >> 1);
      const bool live = unit_ok && r < rows;
      float x[3] = {0.f, 0.f, 0.f};
      if (live) {
#pragma unroll
        for (int q = 0; q < 3; ++q) x[q] = to_float(x_cur[(r * 3 + q) * units + u]);
      }
      const float r_g = sigmoid(x[0] + gate[0][i]);
      const float z_g = sigmoid(x[1] + gate[1][i]);
      const float n_g = tanhf(x[2] + r_g * (gate[2][i] + bias_n));
      h_reg[i] = n_g + z_g * (h_reg[i] - n_g);
      if (live) stage[r * units + u] = from_float<T>(h_reg[i]);
    }
    __syncthreads();

    // The staged h, through distributed shared memory, into the next-step
    // h buffer of every CTA of the cluster, then released to the cluster
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

    // The staged h to the output, after the arrive
    for (int idx = threadIdx.x; idx < per_dest; idx += blockDim.x) {
      const int r = idx / per_row;
      const int v = idx - r * per_row;
      if (row0 + r >= batch) continue;
      copy_piece(reinterpret_cast<unsigned char*>(
                     out + (static_cast<size_t>(row0 + r) * frames + t) *
                               hidden +
                     rank * units) +
                     v * piece,
                 reinterpret_cast<const unsigned char*>(stage + r * units) +
                     v * piece,
                 wide);
    }
    cluster_wait();
  }
}

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

template <typename T, bool kBf16, int kRowTiles>
int launch(const void* xw, const void* w_h, const float* b_hn, void* out,
           const Launch& l) {
  const GruGeometry geo = gru_geometry(l.hidden, sizeof(T), l.rows);
  if (geo.bytes > kMaxSharedBytes || geo.threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = gru_scan_kernel<T, kBf16, kRowTiles>;
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
                              static_cast<const T*>(w_h), b_hn,
                              static_cast<T*>(out), l.batch, l.frames,
                              l.hidden, l.reverse_from, l.rows);
  if (status != cudaSuccess) return static_cast<int>(status);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBf16>
int dispatch(const void* xw, const void* w_h, const float* b_hn, void* out,
             const Launch& l) {
  if (l.hidden % 16 || l.hidden < 16 || l.rows < 1 || l.rows > kMaxRows ||
      l.groups < 1 || l.groups > 65535 || l.reverse_from < 0 ||
      l.reverse_from > l.groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch ((l.rows + 7) / 8) {
    case 1:
      return launch<T, kBf16, 1>(xw, w_h, b_hn, out, l);
    case 2:
      return launch<T, kBf16, 2>(xw, w_h, b_hn, out, l);
    case 3:
      return launch<T, kBf16, 3>(xw, w_h, b_hn, out, l);
    default:
      return launch<T, kBf16, 4>(xw, w_h, b_hn, out, l);
  }
}

int run(const void* xw, const void* w_h, const float* b_hn, void* out,
        int bf16, const Launch& l) {
  if (bf16) {
    return dispatch<__nv_bfloat16, true>(xw, w_h, b_hn, out, l);
  }
  return dispatch<float, false>(xw, w_h, b_hn, out, l);
}

}  // namespace

// xw (groups, batch, frames, 3 * hidden), w_h (groups, hidden, 3 * hidden)
// and out (groups, batch, frames, hidden), contiguous and 16-byte aligned on
// the device, all float32 or all bf16 (`bf16` != 0); b_hn (groups, hidden)
// float32. The groups from `reverse_from` on walk back to front. hidden is a
// multiple of 16; each cluster of 8 CTAs takes `rows` (1..32) batch rows of
// one group. Launches on `stream` and returns the first CUDA error of the
// set-up or the launch.
extern "C" int gru_scan_grouped(const void* xw, const void* w_h,
                                const float* b_hn, void* out, int groups,
                                int reverse_from, int batch, int frames,
                                int hidden, int bf16, int rows,
                                cudaStream_t stream) {
  return run(xw, w_h, b_hn, out, bf16,
             Launch{groups, reverse_from, batch, frames, hidden, rows, stream,
                    nullptr});
}

// How many clusters of the launch configuration for (hidden, dtype, rows)
// the card holds at once (cudaOccupancyMaxActiveClusters), into *clusters.
// Returns the CUDA error of the query.
extern "C" int gru_scan_max_active_clusters(int hidden, int bf16, int rows,
                                            int* clusters) {
  *clusters = 0;
  return run(nullptr, nullptr, nullptr, nullptr, bf16,
             Launch{1, 1, kCluster * rows, 1, hidden, rows, nullptr,
                    clusters});
}

// Shared-memory bytes of one CTA; ops/gru_kernel.py computes the same.
extern "C" int gru_scan_smem(int hidden, int bf16, int rows) {
  return static_cast<int>(gru_geometry(hidden, bf16 ? 2 : 4, rows).bytes);
}
