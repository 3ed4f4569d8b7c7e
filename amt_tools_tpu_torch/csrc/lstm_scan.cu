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
// Design (the simple first version): batch rows are independent, so one
// block owns kRows rows for the whole sequence and no block ever waits on
// another. h (double-buffered) and c for its rows live in shared memory.
// Each step, thread u computes gates u, H+u, 2H+u and 3H+u of every row,
// streaming W_h through L1/L2 (0.5 MB in bf16 stays resident in L2), then
// one __syncthreads hands the new h to the next step. Exactly T steps run,
// so a ragged T needs no padding.
// Later work: split the 4H columns over a thread-block cluster with h
// broadcast through distributed shared memory, so W_h stays on chip.
//
// Kernel E, the training forward, is the same body with kResiduals set: it
// also writes, for every step, the four gate activations as float32 (in
// bf16 mode the bf16-rounded values the step used, widened) and the float32
// cell state c_t, which the BPTT kernel (lstm_bptt.cu) reads back. Its
// arithmetic is B's, so its h equals B's bit for bit. At the training shape
// (B = 8, T = 625, H = 256, float32) it moves about 51 MB (xw and the gates
// 20.5 MB each, c and h 5.1 MB each), 0.015 ms at 3.35 TB/s, and does
// 2.6 GFLOP of recurrent products, 0.039 ms at the 67 TFLOP/s float32
// peak. Neither is the floor: 625 dependent steps are, and with B = 8 only
// 2 blocks run, each streaming W_h from L2 every step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;
constexpr int kThreads = 256;

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

template <typename T, bool kBf16, bool kResiduals>
__global__ void __launch_bounds__(kThreads)
lstm_scan_kernel(const T* __restrict__ xw, const T* __restrict__ w_h,
                 T* __restrict__ out, float* __restrict__ gates_out,
                 float* __restrict__ c_out, int batch, int frames, int hidden,
                 int reverse) {
  extern __shared__ float smem[];
  float* h_buf = smem;                          // [2][kRows][hidden]
  float* c_buf = smem + 2 * kRows * hidden;     // [kRows][hidden]

  const int row0 = blockIdx.x * kRows;
  const int four_h = 4 * hidden;

  for (int i = threadIdx.x; i < 3 * kRows * hidden; i += blockDim.x) {
    smem[i] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < frames; ++s) {
    const int t = reverse ? frames - 1 - s : s;
    const float* h_cur = h_buf + (s & 1) * kRows * hidden;
    float* h_next = h_buf + ((s & 1) ^ 1) * kRows * hidden;

    for (int u = threadIdx.x; u < hidden; u += blockDim.x) {
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      }

      const T* w = w_h + u;
#pragma unroll 4
      for (int k = 0; k < hidden; ++k) {
        const T* wk = w + static_cast<size_t>(k) * four_h;
        const float w0 = to_float(wk[0]);
        const float w1 = to_float(wk[hidden]);
        const float w2 = to_float(wk[2 * hidden]);
        const float w3 = to_float(wk[3 * hidden]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hk = h_cur[r * hidden + k];
          acc[r][0] = fmaf(hk, w0, acc[r][0]);
          acc[r][1] = fmaf(hk, w1, acc[r][1]);
          acc[r][2] = fmaf(hk, w2, acc[r][2]);
          acc[r][3] = fmaf(hk, w3, acc[r][3]);
        }
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        if (b >= batch) continue;

        const size_t step = static_cast<size_t>(b) * frames + t;
        const T* x = xw + step * four_h + u;
        float gi = to_float(x[0]) + acc[r][0];
        float gf = to_float(x[hidden]) + acc[r][1];
        float gg = to_float(x[2 * hidden]) + acc[r][2];
        float go = to_float(x[3 * hidden]) + acc[r][3];

        float c = c_buf[r * hidden + u];
        float i_g, f_g, g_g, o_g;
        if (kBf16) {
          gi = round_bf16(gi);
          gf = round_bf16(gf);
          gg = round_bf16(gg);
          go = round_bf16(go);
          i_g = sigmoid_bf16(gi);
          f_g = sigmoid_bf16(gf);
          g_g = round_bf16(tanhf(gg));
          o_g = sigmoid_bf16(go);
          c = f_g * c + round_bf16(i_g * g_g);
        } else {
          i_g = sigmoid_f32(gi);
          f_g = sigmoid_f32(gf);
          g_g = tanhf(gg);
          o_g = sigmoid_f32(go);
          c = f_g * c + i_g * g_g;
        }
        const float h = o_g * tanhf(c);

        if (kResiduals) {
          float* g = gates_out + step * four_h + u;
          g[0] = i_g;
          g[hidden] = f_g;
          g[2 * hidden] = g_g;
          g[3 * hidden] = o_g;
          c_out[step * hidden + u] = c;
        }

        c_buf[r * hidden + u] = c;
        out[step * hidden + u] = from_float<T>(h);
        h_next[r * hidden + u] = kBf16 ? round_bf16(h) : h;
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kBf16, bool kResiduals>
int launch(const void* xw, const void* w_h, void* out, float* gates,
           float* c_seq, int batch, int frames, int hidden, int reverse,
           cudaStream_t stream) {
  const int blocks = (batch + kRows - 1) / kRows;
  const size_t smem = 3 * kRows * static_cast<size_t>(hidden) * sizeof(float);
  lstm_scan_kernel<T, kBf16, kResiduals><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xw), static_cast<const T*>(w_h),
      static_cast<T*>(out), gates, c_seq, batch, frames, hidden, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xw (batch, frames, 4 * hidden), w_h (hidden, 4 * hidden) and out
// (batch, frames, hidden), contiguous on the device, all float32 or all
// bf16 (`bf16` != 0). hidden <= 1024 keeps the carry within 48 KB of shared
// memory. Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int lstm_scan(const void* xw, const void* w_h, void* out,
                         int batch, int frames, int hidden, int reverse,
                         int bf16, cudaStream_t stream) {
  if (bf16) {
    return launch<__nv_bfloat16, true, false>(
        xw, w_h, out, nullptr, nullptr, batch, frames, hidden, reverse,
        stream);
  }
  return launch<float, false, false>(xw, w_h, out, nullptr, nullptr, batch,
                                     frames, hidden, reverse, stream);
}

// Kernel E: lstm_scan, and also the float32 residuals gates
// (batch, frames, 4 * hidden) and c_seq (batch, frames, hidden), contiguous
// on the device.
extern "C" int lstm_scan_residuals(const void* xw, const void* w_h, void* out,
                                   float* gates, float* c_seq, int batch,
                                   int frames, int hidden, int reverse,
                                   int bf16, cudaStream_t stream) {
  if (bf16) {
    return launch<__nv_bfloat16, true, true>(xw, w_h, out, gates, c_seq,
                                             batch, frames, hidden, reverse,
                                             stream);
  }
  return launch<float, false, true>(xw, w_h, out, gates, c_seq, batch, frames,
                                    hidden, reverse, stream);
}
