// Helpers shared by the port's kernels: bf16 packing, the m16n8k16 tensor-core
// step, and the error-string export every kernel library carries.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4):
//   A (16x16, row-major):  a[0] = (row g,     cols 2t, 2t+1)   a[1] = (row g + 8, same cols)
//                          a[2] = (row g,     cols 2t+8, 2t+9) a[3] = (row g + 8, same cols)
//   B (16x8, column-major): b0 = (rows 2t, 2t+1, col g)        b1 = (rows 2t+8, 2t+9, col g)
//   C/D (16x8, fp32):      d[0], d[1] = (row g, cols 2t, 2t+1) d[2], d[3] = (row g + 8, same cols)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ics {

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace ics

extern "C" const char* ics_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
