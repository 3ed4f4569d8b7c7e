// Eval epilogue of a conv block for Hopper (sm_90a): conv bias, BatchNorm
// with running statistics, ReLU and an optional (1, 2) max- or average
// pool, in one pass over the conv's output.
//
// Replaces no TPU kernel. The JAX package leaves this chain to XLA, which
// fuses it; the port's eager PyTorch ran it as eight passes over the
// activation (the bias add, a float32 copy, three in-place float32 passes,
// the cast back, ReLU, the pool), 47 bytes a bf16 value. It serves the
// eval forward of the O&F acoustic stacks and of the High-resolution
// Piano Transcription model's ConvBlocks (ops/layers.py conv_block, through
// ops/conv_epilogue.py), whose conv runs without its bias; that model's
// convs have none, and its blocks average-pool.
//
// What bounds it on this card: bytes. A value is read once and written
// once, or half written when pooled: 4 bytes a bf16 value unpooled, 3
// pooled, against about 6 operations, far under the ~295 operations a byte
// where the tensor cores would bind. At the piano serving shape (128 clips
// x 48 channels x 1876 frames x 229 bins, 2.64e9 values) that is 3.15 ms
// unpooled and 2.36 ms pooled at 3.35 TB/s.
//
// Arithmetic, bit for bit the eager chain (conv_epilogue_plain), with T the
// activation's type (bf16 or float32):
//   s = round_T(x + conv_bias)          float32 sum, rounded once
//   y = round_T(((s - mean) * mul) + shift)
//                                       __fsub_rn, __fmul_rn, __fadd_rn:
//                                       no FMA contraction; round to
//                                       nearest even
//   r = isnan(y) ? y : fmaxf(y, 0)      ATen's clamp_min, which relu is
//   max pool: m = -inf, then for v in the pair: if (v > m || isnan(v))
//         m = v, as ATen's max_pool_forward_nhwc and _nchw;
//   average pool: round_T(((0 + a) + b) / 2) in float32, as ATen's
//         avg_pool2d kernels sum a window into a float32 zero and divide by
//         its size; an odd width drops its last column either way.
//   A conv without a bias comes with a bias of -0.0 from the wrapper, which
//         leaves every value as it is (x + -0.0 = x, signed zeros
//         included).
// mul = rsqrt(running_var + eps) * weight comes computed from the wrapper,
// as BatchNorm computes it; the kernel takes no rsqrt of its own.
//
// Design. The output keeps x's layout, so the next conv reads what it read
// before. Both layouts occur: cuDNN gives NCHW outputs to the serving
// pipelines, whose features reach the stacks as a transposed view, and
// channels-last ones to features that arrive as (B, T, F, 1) or
// (B, T, F, C), whose permute to (B, C, T, F) has channels-last strides.
// Four routes, chosen by the host from the layout and the alignment:
//   - NCHW unpooled (the pipelines' first block): flat over the tensor in
//     16-byte vectors, two a thread.
//   - NCHW pooled (their second and third blocks): a block for a run of
//     whole (b, c, t) rows, about 24 KB of them, through shared memory.
//   - Channels-last, C a multiple of 8 (bf16) or 4 (float32): each thread
//     owns one 16-byte vector of channels and two pixels.
//   - Anything else (misaligned, C not a multiple of the vector, rows too
//     wide for shared memory): one output value a thread, indices by
//     division. Correct and slow; no model takes it.
// The last rounding's result is a T value already, so it is stored by its
// bits, with no third conversion; an average is rounded once more. Each
// route's comment below says more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;             // vectors or pixels a thread
constexpr int kRowTileBytes = 24576;  // input a block (NCHW pooled)

// The pool of a launch
constexpr int kNoPool = 0;
constexpr int kMaxPool = 1;
constexpr int kAvgPool = 2;

// A value of type T as its raw bits, and its conversions
template <typename T>
struct Type;

template <>
struct Type<float> {
  using Raw = float;
  static __device__ __forceinline__ float load(Raw v) { return v; }
  static __device__ __forceinline__ Raw store(float v) { return v; }
  static __device__ __forceinline__ Raw bits(float v) { return v; }
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
  // The bits of a value that T holds exactly
  static __device__ __forceinline__ Raw bits(float v) {
    return static_cast<Raw>(__float_as_uint(v) >> 16);
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Type<T>::load(Type<T>::store(v));
}

struct Params {
  const void* conv_bias;  // (C,) in T
  const float* mean;      // (C,) running mean
  const float* mul;       // (C,) rsqrt(running_var + eps) * weight
  const float* shift;     // (C,) BatchNorm bias
};

struct Channel {
  float bias, mean, mul, shift;
};

template <typename T>
__device__ __forceinline__ Channel channel(const Params& p, int c) {
  using Raw = typename Type<T>::Raw;
  return {Type<T>::load(__ldg(static_cast<const Raw*>(p.conv_bias) + c)),
          __ldg(p.mean + c), __ldg(p.mul + c), __ldg(p.shift + c)};
}

// Bias, norm, cast and ReLU of one value
template <typename T>
__device__ __forceinline__ float epilogue(float x, const Channel& ch) {
  const float s = round_to<T>(__fadd_rn(x, ch.bias));
  const float y = round_to<T>(
      __fadd_rn(__fmul_rn(__fsub_rn(s, ch.mean), ch.mul), ch.shift));
  return isnan(y) ? y : fmaxf(y, 0.0f);
}

// The pool of a pair of ReLU outputs, as ATen's max-pool and avg-pool
// kernels take it, and its bits in T: a maximum is one of the pair, an
// average is rounded to T
template <typename T, int kPool>
__device__ __forceinline__ typename Type<T>::Raw pool_pair(float a, float b) {
  if constexpr (kPool == kAvgPool) {
    return Type<T>::store(__fdiv_rn(__fadd_rn(__fadd_rn(0.0f, a), b), 2.0f));
  } else {
    float m = -INFINITY;
    if (a > m || isnan(a)) m = a;
    if (b > m || isnan(b)) m = b;
    return Type<T>::bits(m);
  }
}

// q = a / d, r = a % d for 0 <= a < 2^51, d >= 1, with inv_d = 1.0 / d
__device__ __forceinline__ void divmod(long long a, long long d, double inv_d,
                                       long long& q, long long& r) {
  q = static_cast<long long>(static_cast<double>(a) * inv_d);
  r = a - q * d;
  if (r < 0) {
    --q;
    r += d;
  } else if (r >= d) {
    ++q;
    r -= d;
  }
}

// The channels-last route: x and out hold (B, T, F, C) in memory, C a
// multiple of the vector's width. Thread (g, y) of a block owns channels
// [g kVec, (g + 1) kVec), so their conv bias and norm vectors sit in its
// registers; the block's y threads take kUnroll output pixels (b, t, f)
// each, every load issued before any arithmetic. A pooled pixel (b, t, k)
// reads input pixels (b, t, 2k) and (b, t, 2k + 1), C values apart: two
// aligned 16-byte loads. The threads of a warp cover consecutive pixels, so
// each load and store of the warp is one contiguous span. (A grid capped at
// one block an SM slot, each block walking many pixels, ran 10% slower at
// the serving shapes.)
template <typename T, int kPool>
__global__ void __launch_bounds__(kThreads)
epilogue_nhwc_kernel(const typename Type<T>::Raw* __restrict__ x, Params p,
                     typename Type<T>::Raw* __restrict__ out,
                     long long pixels, int channels, int width,
                     int out_width, double inv_out_width) {
  using Raw = typename Type<T>::Raw;
  constexpr int kVec = 16 / sizeof(Raw);
  union Pack {
    uint4 v;
    Raw e[kVec];
  };

  const int c0 = threadIdx.x * kVec;
  Channel ch[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) ch[j] = channel<T>(p, c0 + j);

  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.y * kUnroll + threadIdx.y;
  Pack a[kUnroll], b[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long q = first + u * static_cast<long long>(blockDim.y);
    if (q >= pixels) break;
    long long at = q;
    if (kPool) {
      long long row, k;
      divmod(q, out_width, inv_out_width, row, k);
      at = row * width + 2 * k;
    }
    const uint4* src = reinterpret_cast<const uint4*>(x + at * channels +
                                                      c0);
    a[u].v = __ldcs(src);
    if (kPool) b[u].v = __ldcs(src + channels / kVec);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long q = first + u * static_cast<long long>(blockDim.y);
    if (q >= pixels) break;
    Pack res;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float v = epilogue<T>(Type<T>::load(a[u].e[j]), ch[j]);
      if constexpr (kPool != kNoPool) {
        res.e[j] = pool_pair<T, kPool>(
            v, epilogue<T>(Type<T>::load(b[u].e[j]), ch[j]));
      } else {
        res.e[j] = Type<T>::bits(v);
      }
    }
    __stcs(reinterpret_cast<uint4*>(out + q * channels + c0), res.v);
  }
}

// The NCHW route unpooled: flat over the tensor in 16-byte vectors, kUnroll
// a thread, the loads issued before any arithmetic. A vector finds its
// (b, c) plane once (a double-precision reciprocal and one correction, no
// 64-bit division) and steps to the next channel where it crosses a plane's
// end, so any T * F works. Block 0 also takes the tail of fewer than kVec
// values.
template <typename T>
__global__ void __launch_bounds__(kThreads)
epilogue_flat_kernel(const typename Type<T>::Raw* __restrict__ x, Params p,
                     typename Type<T>::Raw* __restrict__ out, long long n,
                     long long plane, double inv_plane, int channels) {
  using Raw = typename Type<T>::Raw;
  constexpr int kVec = 16 / sizeof(Raw);
  union Pack {
    uint4 v;
    Raw e[kVec];
  };

  const long long n_vec = n / kVec;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  Pack in[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = first + u * kThreads;
    if (v < n_vec) in[u].v = __ldcs(reinterpret_cast<const uint4*>(x) + v);
  }

#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = first + u * kThreads;
    if (v >= n_vec) break;
    long long q, r;
    divmod(v * kVec, plane, inv_plane, q, r);
    int c = static_cast<int>(static_cast<unsigned int>(q) %
                             static_cast<unsigned int>(channels));
    Channel ch = channel<T>(p, c);
    Pack res;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (r == plane) {  // the next (b, c) plane
        r = 0;
        c = c + 1 == channels ? 0 : c + 1;
        ch = channel<T>(p, c);
      }
      res.e[j] = Type<T>::bits(epilogue<T>(Type<T>::load(in[u].e[j]), ch));
      ++r;
    }
    __stcs(reinterpret_cast<uint4*>(out) + v, res.v);
  }

  const long long i = n_vec * kVec + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    long long q, r;
    divmod(i, plane, inv_plane, q, r);
    const Channel ch = channel<T>(
        p, static_cast<int>(static_cast<unsigned int>(q) %
                            static_cast<unsigned int>(channels)));
    out[i] = Type<T>::bits(epilogue<T>(Type<T>::load(x[i]), ch));
  }
}

// The NCHW route pooled: one block for `rows_per_block` consecutive (b, c, t)
// rows, a multiple of the vector's width, so that every block's input and
// output start 16-byte aligned whatever F is. The block copies its rows
// into shared memory in 16-byte loads, looks up each row's channel once,
// computes its outputs there (a warp a row, consecutive lanes on
// consecutive outputs: a pair is 4 or 8 bytes apart in shared memory, so no
// bank conflicts), stages them in shared memory and stores them in 16-byte
// vectors. A row of 229 bf16 values is 458 bytes, so in device memory pairs
// straddle vectors and rows straddle blocks' vectors; in shared memory
// neither matters.
template <typename T, int kPool>
__global__ void __launch_bounds__(kThreads)
epilogue_pool_rows_kernel(const typename Type<T>::Raw* __restrict__ x,
                          Params p, typename Type<T>::Raw* __restrict__ out,
                          long long rows, int rows_per_block, int channels,
                          int frames, double inv_frames, int width,
                          int out_width) {
  using Raw = typename Type<T>::Raw;
  constexpr int kVec = 16 / sizeof(Raw);
  extern __shared__ __align__(16) unsigned char smem[];
  Raw* in_tile = reinterpret_cast<Raw*>(smem);
  Raw* out_tile = in_tile + rows_per_block * width;
  Channel* row_channel =
      reinterpret_cast<Channel*>(out_tile + rows_per_block * out_width);

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int n_rows = static_cast<int>(
      rows - row0 < rows_per_block ? rows - row0 : rows_per_block);
  const int n_in = n_rows * width;
  const int n_out = n_rows * out_width;

  for (int r = threadIdx.x; r < n_rows; r += kThreads) {
    long long plane, t;
    divmod(row0 + r, frames, inv_frames, plane, t);
    row_channel[r] = channel<T>(
        p, static_cast<int>(static_cast<unsigned int>(plane) %
                            static_cast<unsigned int>(channels)));
  }
  const Raw* src = x + row0 * width;
  const int in_vectors = n_in / kVec;
  for (int i = threadIdx.x; i < in_vectors; i += kThreads) {
    reinterpret_cast<uint4*>(in_tile)[i] =
        __ldcs(reinterpret_cast<const uint4*>(src) + i);
  }
  for (int i = in_vectors * kVec + threadIdx.x; i < n_in; i += kThreads) {
    in_tile[i] = src[i];
  }
  __syncthreads();

  // A warp a row, consecutive lanes on consecutive outputs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n_rows; r += kThreads / 32) {
    const Channel ch = row_channel[r];
    const Raw* row_in = in_tile + r * width;
    Raw* row_out = out_tile + r * out_width;
    for (int k = lane; k < out_width; k += 32) {
      row_out[k] = pool_pair<T, kPool>(
          epilogue<T>(Type<T>::load(row_in[2 * k]), ch),
          epilogue<T>(Type<T>::load(row_in[2 * k + 1]), ch));
    }
  }
  __syncthreads();

  Raw* dst = out + row0 * out_width;
  const int out_vectors = n_out / kVec;
  for (int i = threadIdx.x; i < out_vectors; i += kThreads) {
    __stcs(reinterpret_cast<uint4*>(dst) + i,
           reinterpret_cast<const uint4*>(out_tile)[i]);
  }
  for (int i = out_vectors * kVec + threadIdx.x; i < n_out; i += kThreads) {
    dst[i] = out_tile[i];
  }
}

// Any contiguous layout, one output value a thread: what neither route above
// takes. Slow, and off the models' path.
struct Shape {
  long long n_out;
  int channels, frames, width, out_width;
  double inv_channels, inv_frames, inv_out_width;
  bool channels_last;
};

template <typename T, int kPool>
__global__ void __launch_bounds__(kThreads)
epilogue_any_kernel(const typename Type<T>::Raw* __restrict__ x, Params p,
                    typename Type<T>::Raw* __restrict__ out, Shape s) {
  const long long o =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= s.n_out) return;
  const int step = kPool ? 2 : 1;
  long long at, next, q, r, row, k;
  int c;
  if (s.channels_last) {  // o = ((b T + t) out_width + k) C + c
    divmod(o, s.channels, s.inv_channels, q, r);
    c = static_cast<int>(r);
    divmod(q, s.out_width, s.inv_out_width, row, k);
    at = (row * s.width + step * k) * s.channels + c;
    next = at + s.channels;
  } else {  // o = ((b C + c) T + t) out_width + k
    divmod(o, s.out_width, s.inv_out_width, row, k);
    divmod(row, s.frames, s.inv_frames, q, r);
    c = static_cast<int>(static_cast<unsigned int>(q) %
                         static_cast<unsigned int>(s.channels));
    at = row * s.width + step * k;
    next = at + 1;
  }
  const Channel ch = channel<T>(p, c);
  const float v = epilogue<T>(Type<T>::load(x[at]), ch);
  if constexpr (kPool != kNoPool) {
    out[o] = pool_pair<T, kPool>(v, epilogue<T>(Type<T>::load(x[next]), ch));
  } else {
    out[o] = Type<T>::bits(v);
  }
}

template <typename T, int kPool>
int launch(const void* x, Params p, void* out, long long batch, int channels,
           int frames, int width, bool channels_last, cudaStream_t stream) {
  using Raw = typename Type<T>::Raw;
  constexpr int kVec = 16 / sizeof(Raw);
  const int out_width = kPool ? width / 2 : width;
  const long long pixels = batch * frames * out_width;
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  const Raw* in = static_cast<const Raw*>(x);
  Raw* dst = static_cast<Raw*>(out);

  const bool aligned = reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int groups = channels / kVec;
  if (channels_last && channels % kVec == 0 && groups <= kThreads &&
      aligned) {
    const dim3 block(groups, kThreads / groups);
    const long long blocks = (pixels + block.y * kUnroll - 1) /
                             (block.y * kUnroll);
    epilogue_nhwc_kernel<T, kPool>
        <<<static_cast<unsigned int>(blocks), block, 0, stream>>>(
            in, p, dst, pixels, channels, width, out_width, 1.0 / out_width);
    return static_cast<int>(cudaGetLastError());
  }

  if (!channels_last && aligned && kPool == kNoPool) {
    const long long n = pixels * channels;
    const long long per_block = static_cast<long long>(kThreads) * kUnroll *
                                kVec;
    const long long plane = static_cast<long long>(frames) * width;
    epilogue_flat_kernel<T>
        <<<static_cast<unsigned int>((n + per_block - 1) / per_block),
           kThreads, 0, stream>>>(in, p, dst, n, plane, 1.0 / plane,
                                  channels);
    return static_cast<int>(cudaGetLastError());
  }

  // Rows of about kRowTileBytes a block, a multiple of the vector's width
  // of them (a larger tile ran faster, up to 24 KB)
  constexpr int kTile = kRowTileBytes / sizeof(Raw);
  const int rows_per_block =
      width < kTile / kVec ? kTile / width / kVec * kVec : kVec;
  const size_t smem =
      static_cast<size_t>(rows_per_block) * (width + out_width) * sizeof(Raw) +
      rows_per_block * sizeof(Channel);
  if (kPool && !channels_last && aligned && smem <= 48 * 1024) {
    const long long rows = batch * channels * frames;
    const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    epilogue_pool_rows_kernel<T, kPool>
        <<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
            in, p, dst, rows, rows_per_block, channels, frames, 1.0 / frames,
            width, out_width);
    return static_cast<int>(cudaGetLastError());
  }

  const Shape s{pixels * channels, channels, frames, width, out_width,
                1.0 / channels, 1.0 / frames, 1.0 / out_width,
                channels_last};
  const long long blocks = (s.n_out + kThreads - 1) / kThreads;
  epilogue_any_kernel<T, kPool>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(in, p,
                                                                    dst, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int pool, int channels_last, const void* x, Params p, void* out,
             long long batch, int channels, int frames, int width,
             cudaStream_t stream) {
  // (b, c) planes are counted in 32 bits
  if (batch < 0 || channels < 1 || frames < 0 || width < 0 || pool < 0 ||
      pool > kAvgPool || (pool && width < 2) ||
      batch * channels > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (pool) {
    case kMaxPool:
      return launch<T, kMaxPool>(x, p, out, batch, channels, frames, width,
                                 channels_last, stream);
    case kAvgPool:
      return launch<T, kAvgPool>(x, p, out, batch, channels, frames, width,
                                 channels_last, stream);
    default:
      return launch<T, kNoPool>(x, p, out, batch, channels, frames, width,
                                channels_last, stream);
  }
}

}  // namespace

// x (batch, channels, frames, width), the conv's output without its bias,
// contiguous as NCHW (channels_last 0) or as channels-last, (batch, frames,
// width, channels) in memory (channels_last 1); conv_bias (channels) in x's
// type (-0.0 for a conv without a bias); mean, mul and shift (channels)
// float32; pool 0 (none), 1 (max) or 2 (average) over (1, 2); out (batch,
// channels, frames, width / 2 if pool else width) in x's type and layout.
// Launches on `stream` and returns the first CUDA error of the launch.
extern "C" int conv_epilogue_f32(int pool, int channels_last, const void* x,
                                 const void* conv_bias, const float* mean,
                                 const float* mul, const float* shift,
                                 void* out, long long batch, int channels,
                                 int frames, int width, cudaStream_t stream) {
  return dispatch<float>(pool, channels_last, x,
                         Params{conv_bias, mean, mul, shift}, out, batch,
                         channels, frames, width, stream);
}

extern "C" int conv_epilogue_bf16(int pool, int channels_last, const void* x,
                                  const void* conv_bias, const float* mean,
                                  const float* mul, const float* shift,
                                  void* out, long long batch, int channels,
                                  int frames, int width,
                                  cudaStream_t stream) {
  return dispatch<__nv_bfloat16>(pool, channels_last, x,
                                 Params{conv_bias, mean, mul, shift}, out,
                                 batch, channels, frames, width, stream);
}
