// Gradient of the depthwise convolution's taps and bias for NVIDIA Hopper (sm_90a):
//   dtaps[i k + j, c] = sum over (b, h, w) of x[b, h + i - k/2, w + j - k/2, c] dy[b, h, w, c]
//   dbias[c]          = sum over (b, h, w) of dy[b, h, w, c]
// over the zero-padded (SAME) input, NHWC, stride 1, odd k; x and dy in bf16 or fp32,
// every sum and both outputs in fp32.
//
// The TPU kernel that depthwise_conv.cu replaces (ics_tpu/ops/pallas_depthwise.py::
// depthwise_conv) has no backward: the JAX package trains through XLA's convolution.
// This is the parameter gradient of the port's forward kernel, for training through it.
//
// What bounds it on an H100: x and dy are read once (4 bytes a pixel-channel in bf16)
// against 2 k^2 fp32 operations a pixel-channel: 24.5 FLOP a byte at k 7, just past the
// fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so k 7 is bound by operations and k 3 and 5
// by bytes, as the forward is.
//
// Design (simple first, deterministic: no atomics):
//   1. dw_grad_partial_kernel: a block is 32 neighbouring channels (a lane each) by k tap
//      rows (a warp each) over rh rows of one image. Warp i slides along each image row h with the
//      k inputs x[h + i - k/2, w - k/2 .. w + k/2] of its lane's channel in registers: one
//      load of x and one of dy a pixel, k multiply-adds into k fp32 sums (taps (i, 0..k-1)).
//      A warp's loads are 32 channels of one pixel, side by side; the k warps of a block
//      read overlapping rows of x, which the L1 cache serves. The warp of the middle tap
//      row also sums dy for the bias. Each block writes its k^2 + 1 sums a channel to a
//      partial row of its own.
//   2. dw_grad_reduce_kernel: one thread an output sums the partial rows in their order.
// The tap and bias sums of one call are therefore the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "device_guard.cuh"

namespace {

constexpr int kLanes = 32;   // channels a block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int K>
__global__ void __launch_bounds__(kLanes * K)
dw_grad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       float* __restrict__ part, float* __restrict__ part_bias, int H, int W,
                       int C, int rh, int strips) {
  constexpr int P = K / 2;
  const int lane = threadIdx.x % kLanes;
  const int i = threadIdx.x / kLanes;           // tap row
  const int c = blockIdx.x * kLanes + lane;
  const int strip = blockIdx.y;                 // (image, strip of rows)
  const int b = strip / strips;
  const int h0 = (strip - b * strips) * rh;
  const int h1 = min(H, h0 + rh);
  float acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = 0.f;
  float bsum = 0.f;
  if (c < C) {
    const long long row = static_cast<long long>(W) * C;
    for (int h = h0; h < h1; ++h) {
      const int xr = h + i - P;
      if (xr < 0 || xr >= H) continue;
      const T* xrow = x + (static_cast<long long>(b) * H + xr) * row + c;
      const T* dyrow = dy + (static_cast<long long>(b) * H + h) * row + c;
      float win[K];   // win[j] = x[xr, w + j - P]
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int col = j - P;
        win[j] = (col >= 0 && col < W) ? to_f(xrow[static_cast<long long>(col) * C]) : 0.f;
      }
      for (int w = 0; w < W; ++w) {
        const float d = to_f(dyrow[static_cast<long long>(w) * C]);
#pragma unroll
        for (int j = 0; j < K; ++j) acc[j] = fmaf(win[j], d, acc[j]);
        if (i == P) bsum += d;
#pragma unroll
        for (int j = 0; j < K - 1; ++j) win[j] = win[j + 1];
        const int nxt = w + K - P;
        win[K - 1] = nxt < W ? to_f(xrow[static_cast<long long>(nxt) * C]) : 0.f;
      }
    }
    float* out = part + static_cast<long long>(strip) * K * K * C + c;
#pragma unroll
    for (int j = 0; j < K; ++j) out[static_cast<long long>(i * K + j) * C] = acc[j];
    if (i == P) part_bias[static_cast<long long>(strip) * C + c] = bsum;
  }
}

// dtaps[t] = sum over s of part[s, t] (t < k^2 C), dbias[c] = sum over s of part_bias[s, c]
__global__ void dw_grad_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ part_bias,
                                      float* __restrict__ dtaps, float* __restrict__ dbias,
                                      int n_taps, int C, int n_strips) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_taps) {
    float s = 0.f;
    for (int p = 0; p < n_strips; ++p) s += part[static_cast<long long>(p) * n_taps + t];
    dtaps[t] = s;
  } else if (t < n_taps + C && dbias != nullptr) {
    const int c = t - n_taps;
    float s = 0.f;
    for (int p = 0; p < n_strips; ++p) s += part_bias[static_cast<long long>(p) * C + c];
    dbias[c] = s;
  }
}

template <typename T, int K>
cudaError_t launch_partial(const void* x, const void* dy, float* part, float* part_bias, int B,
                           int H, int W, int C, int rh, cudaStream_t stream) {
  const int strips = (H + rh - 1) / rh;
  dim3 grid((C + kLanes - 1) / kLanes, B * strips);
  dw_grad_partial_kernel<T, K><<<grid, kLanes * K, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, part_bias, H, W, C, rh, strips);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* dy, float* part, float* part_bias, int B, int H,
                int W, int C, int k, int rh, cudaStream_t stream) {
  switch (k) {
    case 3: return launch_partial<T, 3>(x, dy, part, part_bias, B, H, W, C, rh, stream);
    case 5: return launch_partial<T, 5>(x, dy, part, part_bias, B, H, W, C, rh, stream);
    case 7: return launch_partial<T, 7>(x, dy, part, part_bias, B, H, W, C, rh, stream);
    case 9: return launch_partial<T, 9>(x, dy, part, part_bias, B, H, W, C, rh, stream);
    case 11: return launch_partial<T, 11>(x, dy, part, part_bias, B, H, W, C, rh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ics_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = bf16, 1 = fp32, of x and dy alike: contiguous [B, H, W, C]. k odd, 3 to 11.
// part: [B * ceil(H / rh), k * k, C] fp32 scratch, part_bias: [B * ceil(H / rh), C] fp32
// scratch. dtaps: [k * k, C] fp32, tap (i, j) of channel c at dtaps[(i k + j) C + c];
// dbias: [C] fp32 or null. Two launches on the stream. Returns a cudaError_t; 0 when both
// launches were accepted.
int ics_depthwise_conv_dw(int dtype, const void* x, const void* dy, void* part, void* part_bias,
                          void* dtaps, void* dbias, int B, int H, int W, int C, int k, int rh,
                          void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (k < 3 || k > 11 || k % 2 == 0 || rh <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long strips = static_cast<long long>(B) * ((H + rh - 1) / rh);
  if (strips > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* pb = static_cast<float*>(part_bias);
  err = dtype == 0 ? run<__nv_bfloat16>(x, dy, p, pb, B, H, W, C, k, rh, s)
                   : run<float>(x, dy, p, pb, B, H, W, C, k, rh, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_taps = k * k * C;
  const int threads = 256;
  const int blocks = (n_taps + C + threads - 1) / threads;
  dw_grad_reduce_kernel<<<blocks, threads, 0, s>>>(p, pb, static_cast<float*>(dtaps),
                                            static_cast<float*>(dbias), n_taps, C,
                                            static_cast<int>(strips));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
