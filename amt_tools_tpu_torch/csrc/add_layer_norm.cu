// Residual add and LayerNorm of a post-LN transformer sublayer for Hopper
// (sm_90a): out = LayerNorm(y + residual) over rows of H values, in one
// pass over the rows.
//
// Replaces no TPU kernel: the JAX package has no transformer. The port's
// hFT-Transformer layers (ops/attention.py `_PostLN`, through
// ops/add_layer_norm.py) end every sublayer with the LayerNorm of its
// residual sum. Run eagerly that is two passes: an add that writes the sum
// and PyTorch's LayerNorm kernel that reads it back, five tensors moved where
// this kernel moves three.
//
// What bounds it on this card: bytes. y and the residual are read once and
// the output written once, against about ten float operations a value, far
// under the ~295 operations a byte where the tensor cores would bind. At the
// hft-serve-bf16 cell's frequency encoder (61,440 x 256 rows of 256 bf16
// values, 8.05 GB a tensor) a launch moves 24.2 GB: 7.2 ms at 3.35 TB/s.
//
// Design: a warp a row, a block 8 rows, one block for every 8 rows (at most
// 2^32 rows, 64 GB of bf16 at the narrowest). Lane l holds the row's 16-byte
// vectors l, l + 32, ...: at H = 256 in bf16 that is one vector of y and
// one of the residual a lane, and each warp-wide load is one contiguous
// 512-byte span; the weight and bias sit in registers beside them, read
// through the read-only cache. The row's statistics come from two butterfly
// reductions of warp shuffles over the values in registers, the mean first,
// then the mean squared deviation: no shared memory, no atomics, and every
// lane ends with the same bits, every run. y streams through (evict-first
// loads and stores). A residual of R rows for more rows than R is read at
// row r % R through the read-only cache (hFT's first decoder layer adds its
// 88 shared queries to every segment's frames); a residual of y's rows
// streams as y does. A persistent grid, as many blocks as the card holds at
// once each walking many rows, ran 6% slower at the cell's shapes (85% of
// the byte bound against 91%): a warp's next loads waited for its last
// row's reductions and stores, where fresh blocks start theirs at once.
//
// Arithmetic, with T the activations' type (bf16 or float32):
//   s    = round_T(y + residual)            float32 sum rounded once, as
//                                           PyTorch's add rounds it
//   mean = sum(s) / H                       float32
//   var  = sum((s - mean)^2) / H            float32, biased, as LayerNorm's
//   out  = round_T((s - mean) * rsqrt(var + eps) * w + b)
//                                           float32, cast once
// PyTorch's LayerNorm takes the same statistics in float32 by Welford's
// update; the two differ only in the order of the float32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps (rows in flight) a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWidth = 2048;
constexpr int kWidthMultiple = 8;
constexpr long long kMaxRows = 0xffffffffLL;  // row indices in 32 bits

// A value of type T as its raw bits, and its conversions
template <typename T>
struct Type;

template <>
struct Type<float> {
  using Raw = float;
  static __device__ __forceinline__ float load(Raw v) { return v; }
  static __device__ __forceinline__ Raw store(float v) { return v; }
};

template <>
struct Type<__nv_bfloat16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float load(Raw v) {
    return __uint_as_float(static_cast<unsigned int>(v) << 16);
  }
  static __device__ __forceinline__ Raw store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// The sum over the warp, the same bits in every lane: at each step a lane
// and its partner add the same two values
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// kSlots: 16-byte vectors a lane holds of a row (H / (32 kVec), rounded up
// to a power of two); kBroadcast: the residual has fewer rows than y
template <typename T, int kSlots, bool kBroadcast>
__global__ void __launch_bounds__(kThreads)
add_layer_norm_kernel(const typename Type<T>::Raw* __restrict__ y,
                      const typename Type<T>::Raw* __restrict__ residual,
                      const typename Type<T>::Raw* __restrict__ weight,
                      const typename Type<T>::Raw* __restrict__ bias,
                      typename Type<T>::Raw* __restrict__ out,
                      long long rows, long long residual_rows, int width,
                      float eps) {
  using Raw = typename Type<T>::Raw;
  constexpr int kVec = 16 / sizeof(Raw);
  union Pack {
    uint4 v;
    Raw e[kVec];
  };

  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const long long res_row =
      kBroadcast ? static_cast<unsigned int>(row) %
                       static_cast<unsigned int>(residual_rows)
                 : row;
  const uint4* src = reinterpret_cast<const uint4*>(y + row * width);
  const uint4* res =
      reinterpret_cast<const uint4*>(residual + res_row * width);
  const int lane = threadIdx.x % 32;
  const int vectors = width / kVec;
  bool active[kSlots];
  Pack a[kSlots], r[kSlots], w[kSlots], b[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int v = lane + 32 * j;
    active[j] = v < vectors;
    if (active[j]) {
      a[j].v = __ldcs(src + v);
      r[j].v = kBroadcast ? __ldg(res + v) : __ldcs(res + v);
      w[j].v = __ldg(reinterpret_cast<const uint4*>(weight) + v);
      b[j].v = __ldg(reinterpret_cast<const uint4*>(bias) + v);
    }
  }

  float s[kSlots][kVec];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      s[j][k] = 0.0f;
      if (active[j]) {
        s[j][k] = Type<T>::load(Type<T>::store(__fadd_rn(
            Type<T>::load(a[j].e[k]), Type<T>::load(r[j].e[k]))));
        sum += s[j][k];
      }
    }
  }
  const float inv_width = 1.0f / static_cast<float>(width);
  const float mean = warp_sum(sum) * inv_width;

  float squares = 0.0f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (active[j]) {
        s[j][k] -= mean;
        squares = fmaf(s[j][k], s[j][k], squares);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(squares) * inv_width + eps);

  uint4* dst = reinterpret_cast<uint4*>(out + row * width);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (active[j]) {
      Pack o;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        o.e[k] = Type<T>::store(fmaf(s[j][k] * rstd,
                                     Type<T>::load(w[j].e[k]),
                                     Type<T>::load(b[j].e[k])));
      }
      __stcs(dst + lane + 32 * j, o.v);
    }
  }
}

template <typename T, int kSlots, bool kBroadcast>
int launch(const void* y, const void* residual, const void* weight,
           const void* bias, void* out, long long rows,
           long long residual_rows, int width, float eps,
           cudaStream_t stream) {
  using Raw = typename Type<T>::Raw;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  add_layer_norm_kernel<T, kSlots, kBroadcast>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const Raw*>(y), static_cast<const Raw*>(residual),
      static_cast<const Raw*>(weight), static_cast<const Raw*>(bias),
      static_cast<Raw*>(out), rows, residual_rows, width, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kBroadcast>
int by_slots(const void* y, const void* residual, const void* weight,
             const void* bias, void* out, long long rows,
             long long residual_rows, int width, float eps,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(typename Type<T>::Raw);
  const int slots = (width / kVec + 31) / 32;
  if (slots <= 1) {
    return launch<T, 1, kBroadcast>(y, residual, weight, bias, out, rows,
                                    residual_rows, width, eps, stream);
  }
  if (slots <= 2) {
    return launch<T, 2, kBroadcast>(y, residual, weight, bias, out, rows,
                                    residual_rows, width, eps, stream);
  }
  if (slots <= 4) {
    return launch<T, 4, kBroadcast>(y, residual, weight, bias, out, rows,
                                    residual_rows, width, eps, stream);
  }
  if constexpr (kVec == 8) {  // bf16: at most 2048 / 8 / 32 = 8 slots
    return launch<T, 8, kBroadcast>(y, residual, weight, bias, out, rows,
                                    residual_rows, width, eps, stream);
  } else {
    if (slots <= 8) {
      return launch<T, 8, kBroadcast>(y, residual, weight, bias, out, rows,
                                      residual_rows, width, eps, stream);
    }
    return launch<T, 16, kBroadcast>(y, residual, weight, bias, out, rows,
                                     residual_rows, width, eps, stream);
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T>
int dispatch(const void* y, const void* residual, const void* weight,
             const void* bias, void* out, long long rows,
             long long residual_rows, int width, float eps,
             cudaStream_t stream) {
  if (rows < 0 || rows > kMaxRows || width < kWidthMultiple ||
      width % kWidthMultiple || width > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (residual_rows < 1 || residual_rows > rows || rows % residual_rows ||
      !aligned(y) || !aligned(residual) || !aligned(weight) ||
      !aligned(bias) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (residual_rows == rows) {
    return by_slots<T, false>(y, residual, weight, bias, out, rows,
                              residual_rows, width, eps, stream);
  }
  return by_slots<T, true>(y, residual, weight, bias, out, rows,
                           residual_rows, width, eps, stream);
}

}  // namespace

// y (rows, width), the sublayer's output, and residual (residual_rows,
// width), row r of y adding row r % residual_rows, both contiguous in T;
// weight and bias (width) in T; out (rows, width) in T. width a multiple of
// 8 up to 2048, rows under 2^32, residual_rows dividing rows, every pointer
// 16-byte aligned.
// Launches on `stream` and returns the first CUDA error of the launch.
extern "C" int add_layer_norm_f32(const void* y, const void* residual,
                                  const void* weight, const void* bias,
                                  void* out, long long rows,
                                  long long residual_rows, int width,
                                  float eps, cudaStream_t stream) {
  return dispatch<float>(y, residual, weight, bias, out, rows, residual_rows,
                         width, eps, stream);
}

extern "C" int add_layer_norm_bf16(const void* y, const void* residual,
                                   const void* weight, const void* bias,
                                   void* out, long long rows,
                                   long long residual_rows, int width,
                                   float eps, cudaStream_t stream) {
  return dispatch<__nv_bfloat16>(y, residual, weight, bias, out, rows,
                                 residual_rows, width, eps, stream);
}
