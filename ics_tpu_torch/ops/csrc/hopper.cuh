// Hopper building blocks shared by the port's kernels, in PTX: mbarriers, TMA
// loads, the wgmma descriptors and instructions, ldmatrix, cp.async, and on the
// host the way to cuTensorMapEncodeTiled and the occupancy of a kernel.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace ics {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// waits until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the [D, S, H, B] tensor map into shared memory; the bytes count
// on the mbarrier, rows outside the map arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory matrix descriptor of wgmma, 128-byte swizzle: the address
// (below 256 KB) and the leading offset share the low word, the stride offset
// and the swizzle mode make the high word
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  const uint32_t lo = (addr >> 4) | ((lbo_bytes >> 4) << 16);
  const uint32_t hi = (sbo_bytes >> 4) | (1u << 30);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to registers that an asynchronous
// wgmma reads or writes across the point where it is launched or awaited
template <int N>
__device__ __forceinline__ void reg_fence(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(x[i][c])::"memory");
  }
}

#define ICS_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define ICS_F16(a, i) ICS_F4(a, i), ICS_F4(a, i + 4), ICS_F4(a, i + 8), ICS_F4(a, i + 12)

// d (64 x 64, fp32) = a (64 x 16 bf16, registers) * b (16 x 64 bf16, shared) [+ d]
template <int kTransB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ICS_F16(d, 0), ICS_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate),
        "n"(kTransB));
}

// d (64 x 128, fp32) = a (64 x 16 bf16, registers) * b (16 x 128 bf16, shared) [+ d]
template <int kTransB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : ICS_F16(d, 0), ICS_F16(d, 16), ICS_F16(d, 32), ICS_F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate),
        "n"(kTransB));
}

// a place in the ring of stages: the stage and the parity of its mbarriers' phase
template <int kStages>
struct RingPos {
  int stage = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16 bytes from device memory to shared memory, or 16 zero bytes
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of the committed cp.async groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one box of a 2-d or 3-d tensor map into shared memory, as tma_load_4d
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Transposes the 4 x 4 words that the four lanes of a quad hold: a[k] of lane
// t becomes a[t] of lane k. The fragments of mma.sync and wgmma give lane t
// of a quad the word t (two bf16) of every 16-byte block of a row; after the
// transposition the lane holds whole blocks, which move as 16 bytes.
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int t) {
  {  // 2 x 2 blocks with the lane two on
    const bool hi = t & 2;
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? a[0] : a[2], 2);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? a[1] : a[3], 2);
    a[0] = hi ? r0 : a[0];
    a[1] = hi ? r1 : a[1];
    a[2] = hi ? a[2] : r0;
    a[3] = hi ? a[3] : r1;
  }
  {  // single words with the lane one on
    const bool odd = t & 1;
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[1], 1);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? a[2] : a[3], 1);
    a[0] = odd ? r0 : a[0];
    a[1] = odd ? a[1] : r0;
    a[2] = odd ? r1 : a[2];
    a[3] = odd ? a[3] : r1;
  }
}

// ---- host side ----------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link:
// the symbol comes from the libcuda that the process has loaded already
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return libcuda ? reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"))
                  : nullptr;
  }();
  return fn;
}

// Blocks of a kernel that fit the card at once at a block size and a shared-memory size:
// asked once, then kept; 0 if the runtime cannot say.
inline int resident_blocks(const void* kernel, int threads, int smem, int device) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> known;
  const auto key = std::make_tuple(kernel, threads, smem, device);
  std::lock_guard<std::mutex> lock(mu);
  const auto found = known.find(key);
  if (found != known.end()) return found->second;
  int per_sm = 0;
  int sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  known.emplace(key, per_sm * sms);
  return per_sm * sms;
}

}  // namespace ics
