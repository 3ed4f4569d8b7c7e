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
// Design (the simple first version, the mirror of lstm_scan.cu): one block
// owns kRows batch rows for the whole sequence, so no block waits on
// another. The carries dh, dc and the step's da for its rows live in shared
// memory (24 KB at H = 256). Each step has two phases split by
// __syncthreads: thread u first forms the gate gradients of unit u for
// every row (reading c_prev straight from c, so no shifted copy is made),
// then thread u forms dh_carry[u] over the 4H products with W_h^T, which
// arrives as a contiguous (4H, H) array: at a fixed k the 32 lanes of a
// warp read 32 neighbouring words. W_h^T streams through L1/L2 every step.
// Exactly T steps run, so a ragged T needs no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
lstm_bptt_kernel(const float* __restrict__ gates,
                 const float* __restrict__ c_seq, const T* __restrict__ dout,
                 const T* __restrict__ w_ht, float* __restrict__ da,
                 int batch, int frames, int hidden, int reverse) {
  extern __shared__ float smem[];
  const int four_h = 4 * hidden;
  float* dh_buf = smem;                         // [kRows][hidden]
  float* dc_buf = smem + kRows * hidden;        // [kRows][hidden]
  float* da_buf = smem + 2 * kRows * hidden;    // [kRows][4 * hidden]

  const int row0 = blockIdx.x * kRows;

  for (int i = threadIdx.x; i < 6 * kRows * hidden; i += blockDim.x) {
    smem[i] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < frames; ++s) {
    // The forward walked t = 0..T-1 (reverse: T-1..0); this walks back
    const int t = reverse ? s : frames - 1 - s;
    const int t_prev = reverse ? t + 1 : t - 1;
    const bool has_prev = t_prev >= 0 && t_prev < frames;

    for (int u = threadIdx.x; u < hidden; u += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        if (b >= batch) continue;

        const size_t step = static_cast<size_t>(b) * frames + t;
        const float* g = gates + step * four_h + u;
        const float i_g = g[0];
        const float f_g = g[hidden];
        const float g_g = g[2 * hidden];
        const float o_g = g[3 * hidden];

        const float c_t = c_seq[step * hidden + u];
        const float c_prev =
            has_prev ? c_seq[(static_cast<size_t>(b) * frames + t_prev) *
                                 hidden + u]
                     : 0.f;
        const float tanh_c = tanhf(c_t);

        const float dh = to_float(dout[step * hidden + u]) +
                         dh_buf[r * hidden + u];
        const float da_o = dh * tanh_c * o_g * (1.f - o_g);
        const float dc = dc_buf[r * hidden + u] +
                         dh * o_g * (1.f - tanh_c * tanh_c);
        const float da_i = dc * g_g * i_g * (1.f - i_g);
        const float da_g = dc * i_g * (1.f - g_g * g_g);
        const float da_f = dc * c_prev * f_g * (1.f - f_g);
        dc_buf[r * hidden + u] = dc * f_g;

        float* d = da + step * four_h + u;
        d[0] = da_i;
        d[hidden] = da_f;
        d[2 * hidden] = da_g;
        d[3 * hidden] = da_o;

        float* ds = da_buf + r * four_h + u;
        ds[0] = kBf16 ? round_bf16(da_i) : da_i;
        ds[hidden] = kBf16 ? round_bf16(da_f) : da_f;
        ds[2 * hidden] = kBf16 ? round_bf16(da_g) : da_g;
        ds[3 * hidden] = kBf16 ? round_bf16(da_o) : da_o;
      }
    }
    __syncthreads();

    // dh_carry = round(da) @ W_h^T for the next (earlier) step
    for (int u = threadIdx.x; u < hidden; u += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

      const T* w = w_ht + u;
#pragma unroll 8
      for (int k = 0; k < four_h; ++k) {
        const float wk = to_float(w[static_cast<size_t>(k) * hidden]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = fmaf(da_buf[r * four_h + k], wk, acc[r]);
        }
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) dh_buf[r * hidden + u] = acc[r];
    }
    __syncthreads();
  }
}

template <typename T, bool kBf16>
int launch(const float* gates, const float* c_seq, const void* dout,
           const void* w_ht, float* da, int batch, int frames, int hidden,
           int reverse, cudaStream_t stream) {
  const int blocks = (batch + kRows - 1) / kRows;
  const size_t smem = 6 * kRows * static_cast<size_t>(hidden) * sizeof(float);
  const cudaError_t status = cudaFuncSetAttribute(
      lstm_bptt_kernel<T, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (status != cudaSuccess) return static_cast<int>(status);
  lstm_bptt_kernel<T, kBf16><<<blocks, kThreads, smem, stream>>>(
      gates, c_seq, static_cast<const T*>(dout), static_cast<const T*>(w_ht),
      da, batch, frames, hidden, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gates (batch, frames, 4 * hidden) and c_seq (batch, frames, hidden) as
// float32 from the forward with residuals, dout (batch, frames, hidden) and
// w_ht (4 * hidden, hidden) both float32 or both bf16 (`bf16` != 0), and
// da (batch, frames, 4 * hidden) float32, contiguous on the device.
// `reverse` names the forward's direction. hidden <= 1024 (96 KB of shared
// memory). Launches on `stream` and returns the CUDA error of the launch.
extern "C" int lstm_bptt(const float* gates, const float* c_seq,
                         const void* dout, const void* w_ht, float* da,
                         int batch, int frames, int hidden, int reverse,
                         int bf16, cudaStream_t stream) {
  if (bf16) {
    return launch<__nv_bfloat16, true>(gates, c_seq, dout, w_ht, da, batch,
                                       frames, hidden, reverse, stream);
  }
  return launch<float, false>(gates, c_seq, dout, w_ht, da, batch, frames,
                              hidden, reverse, stream);
}
