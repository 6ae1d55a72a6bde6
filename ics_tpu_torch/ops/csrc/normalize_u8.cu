// uint8 -> normalized bf16 or fp32 in one pass, for NVIDIA Hopper (sm_90a):
//   y[b, h, w, c] = float(x[b, h, w, c]) * scale[c] + bias[c]
// with scale = 1 / (255 * std) and bias = -mean / std, computed in fp32 as a
// multiply and an add, then rounded once to the output type.
//
// Replaces the Pallas TPU kernel ics_tpu/ops/pallas_preproc.py::
// pallas_normalize (body _normalize_kernel). The TPU wrapper flattened the
// image to rows of 128 pixels and padded the last row; here the kernel reads
// [B, H, W, 3] as it lies, with a row stride and an image stride in bytes, so
// it can take the top-left H x W window of a larger staged canvas without a
// copy, and writes a contiguous [B, H, W, 3].
//
// What bounds it on an H100: device memory. It reads 1 byte and writes 2 (bf16)
// or 4 (fp32) per value and does two floating-point operations on it. A
// thread of the vector kernel takes 4 pixels: three 32-bit loads, then 24
// (bf16) or 48 (fp32) bytes stored as 8- or 16-byte words. That needs W to
// be a multiple of 4 and 4-byte aligned rows; any other shape or stride goes
// through the scalar kernel, one value per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

struct Affine {
  float scale[3];
  float bias[3];
};

__device__ __forceinline__ float norm1(uint32_t v, float s, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(v), s), b);
}

__device__ __forceinline__ void store4(float* out, const float (&y)[12]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    reinterpret_cast<float4*>(out)[i] =
        make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, const float (&y)[12]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(y[4 * i], y[4 * i + 1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(y[4 * i + 2], y[4 * i + 3]);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    reinterpret_cast<uint2*>(out)[i] = v;
  }
}

__device__ __forceinline__ void store1(float* out, float y) { *out = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float y) {
  *out = __float2bfloat16_rn(y);
}

// one thread per group of 4 pixels (12 bytes); W % 4 == 0, rows 4-byte aligned
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
normalize_vec_kernel(const uint8_t* __restrict__ x, OutT* __restrict__ out,
                     long long groups, int H, int W, long long image_stride,
                     long long row_stride, Affine p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= groups) return;
  const int per_row = W / 4;
  const long long row = i / per_row;  // b * H + h
  const int j = static_cast<int>(i - row * per_row);
  const long long b = row / H;
  const int h = static_cast<int>(row - b * H);
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(x + b * image_stride + h * row_stride) + 3 * j;
  float y[12];
#pragma unroll
  for (int word = 0; word < 3; ++word) {
    const uint32_t v = src[word];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = (word * 4 + k) % 3;
      y[word * 4 + k] = norm1((v >> (8 * k)) & 0xffu, p.scale[c], p.bias[c]);
    }
  }
  store4(out + (row * W + 4LL * j) * 3, y);
}

// one thread per value: any shape, any stride
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
normalize_scalar_kernel(const uint8_t* __restrict__ x, OutT* __restrict__ out,
                        long long total, int H, int W, long long image_stride,
                        long long row_stride, Affine p) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long pix = e / 3;
  const int c = static_cast<int>(e - pix * 3);
  const long long row = pix / W;
  const int w = static_cast<int>(pix - row * W);
  const long long b = row / H;
  const int h = static_cast<int>(row - b * H);
  const uint8_t v = x[b * image_stride + h * row_stride + 3LL * w + c];
  store1(out + e, norm1(v, p.scale[c], p.bias[c]));
}

template <typename OutT>
cudaError_t launch(const uint8_t* x, void* out, int B, int H, int W,
                   long long image_stride, long long row_stride, const Affine& p,
                   cudaStream_t stream) {
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                   image_stride % 4 == 0 && row_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long pixels = static_cast<long long>(B) * H * W;
  const long long work = vec ? pixels / 4 : pixels * 3;
  const long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  if (vec) {
    normalize_vec_kernel<OutT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, static_cast<OutT*>(out), work, H, W, image_stride, row_stride, p);
  } else {
    normalize_scalar_kernel<OutT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, static_cast<OutT*>(out), work, H, W, image_stride, row_stride, p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: uint8, value (b, h, w, c) at x + b * image_stride + h * row_stride + 3 * w + c.
// out: contiguous [B, H, W, 3]; dtype 0 = bf16, 1 = fp32.
// scale, bias: 3 floats each, on the host.
// Returns a cudaError_t; 0 when the launch was accepted.
int ics_normalize_u8(int dtype, const void* x, void* out, int B, int H, int W,
                     long long image_stride, long long row_stride, const float* scale,
                     const float* bias, void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  Affine p;
  for (int c = 0; c < 3; ++c) {
    p.scale[c] = scale[c];
    p.bias[c] = bias[c];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xs = static_cast<const uint8_t*>(x);
  if (dtype == 0) {
    return static_cast<int>(
        launch<__nv_bfloat16>(xs, out, B, H, W, image_stride, row_stride, p, s));
  }
  return static_cast<int>(launch<float>(xs, out, B, H, W, image_stride, row_stride, p, s));
}

const char* ics_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
