// Window attention for NVIDIA Hopper (sm_90a), the attention of one Swin window:
// out = softmax(Q K^T + bias[head] + mask[window]) V over [Bn, H, ww, hd] tensors,
// ww <= 64 tokens a window (49 for Swin's 7x7 windows), hd in {16, 32}.
//
// Replaces the Pallas TPU kernel scripts/proto_window_attn.py::pallas_window_attention
// (body _kernel). Contract, as that kernel's: q arrives pre-scaled; scores,
// bias, mask, max, exp and sum are fp32; P is divided by its row sum and then
// rounded to the input's type; P.V accumulates in fp32; the output is rounded
// once. The mask's entries (0 or -1e4) are added as they are, never turned
// into -inf. Rows of Bn are image-major: window index = row mod nW.
//
// What bounds it on an H100: bytes. One (window, head) reads 3 x 49 x 32 bf16
// and writes 49 x 32 (12.5 KB) for 4 x 49^2 x 32 = 0.3 MFLOP, about 25 FLOP a
// byte, a tenth of the card's bf16 ridge. The point of the kernel is what it
// keeps out of device memory: the [Bn, H, ww, ww] score tensor (fp32, three
// times the size of q, k, v and the output together) lives in registers only.
//
// Design (bf16): one block per (window, head), four warps of 16 query rows
// each, so 49 rows pad to 64 in registers; K and V go through shared memory
// once, rows past ww as zeros, rows padded by 8 bf16 against bank conflicts.
// A warp computes its 16 x 64 scores with mma.sync m16n8k16, adds bias and
// mask from device memory (they come back from L2), puts keys past ww at
// -inf before the max and at p = 0 after, normalises, and feeds P to the P.V
// products straight from the score registers. Nothing is padded in device
// memory. The fp32 variant is SIMT, plain FMA in full fp32 (no TF32): one
// thread a query row, its score row kept in shared memory.

#include <cmath>

#include "mma_frag.cuh"

namespace {

using ics::mma_bf16;
using ics::pack_bf16;
using ics::pack_f32;

constexpr int kMaxTokens = 64;   // query rows and keys a block holds
constexpr int kWarps = 4;        // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // bf16 of padding per shared-memory row
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
window_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ mask, __nv_bfloat16* __restrict__ o,
                   int heads, int ww, int n_windows) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 ks[kMaxTokens][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kMaxTokens][D + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int head = blockIdx.x % heads;
  const int window = (blockIdx.x / heads) % n_windows;
  const size_t base = static_cast<size_t>(blockIdx.x) * ww * D;

  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kMaxTokens * kChunks; i += kThreads) {
    const int row = i / kChunks;
    const int ch = i % kChunks;
    uint4 kx = make_uint4(0, 0, 0, 0);
    uint4 vx = make_uint4(0, 0, 0, 0);
    if (row < ww) {
      const size_t off = base + static_cast<size_t>(row) * D + ch * 8;
      kx = *reinterpret_cast<const uint4*>(k + off);
      vx = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(&ks[row][ch * 8]) = kx;
    *reinterpret_cast<uint4*>(&vs[row][ch * 8]) = vx;
  }
  __syncthreads();
  if (warp * 16 >= ww) return;  // this warp's query rows are all padding

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    const __nv_bfloat16* q0 = q + base + static_cast<size_t>(r0) * D + c;
    const __nv_bfloat16* q1 = q + base + static_cast<size_t>(r1) * D + c;
    qf[kk][0] = r0 < ww ? *reinterpret_cast<const uint32_t*>(q0) : 0u;
    qf[kk][1] = r1 < ww ? *reinterpret_cast<const uint32_t*>(q1) : 0u;
    qf[kk][2] = r0 < ww ? *reinterpret_cast<const uint32_t*>(q0 + 8) : 0u;
    qf[kk][3] = r1 < ww ? *reinterpret_cast<const uint32_t*>(q1 + 8) : 0u;
  }

  // S = Q K^T for this warp's 16 rows x 64 keys, as 8 tiles of 16x8
  float s[kMaxTokens / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxTokens / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + t * 2];
      mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }

  // + bias + mask on real (row, key) pairs; keys past ww at -inf; row max
  const float* bias0 = bias + (static_cast<size_t>(head) * ww + r0) * ww;
  const float* bias1 = bias + (static_cast<size_t>(head) * ww + r1) * ww;
  const float* mask0 = mask == nullptr ? nullptr
                                       : mask + (static_cast<size_t>(window) * ww + r0) * ww;
  const float* mask1 = mask == nullptr ? nullptr
                                       : mask + (static_cast<size_t>(window) * ww + r1) * ww;
  float m[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < kMaxTokens / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = nt * 8 + t * 2 + j;
      const bool ok = key < ww;
      float s0 = kNegInf;
      float s1 = kNegInf;
      if (ok && r0 < ww) {
        s0 = s[nt][j] + bias0[key];
        if (mask0 != nullptr) s0 += mask0[key];
      }
      if (ok && r1 < ww) {
        s1 = s[nt][2 + j] + bias1[key];
        if (mask1 != nullptr) s1 += mask1[key];
      }
      s[nt][j] = s0;
      s[nt][2 + j] = s1;
      m[0] = fmaxf(m[0], s0);
      m[1] = fmaxf(m[1], s1);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }

  // exp and row sum; p = 0 on keys past ww
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kMaxTokens / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = nt * 8 + t * 2 + j < ww;
      s[nt][j] = ok ? __expf(s[nt][j] - m[0]) : 0.f;
      s[nt][2 + j] = ok ? __expf(s[nt][2 + j] - m[1]) : 0.f;
      l[0] += s[nt][j];
      l[1] += s[nt][2 + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);  // only a padding row sums to 0
  }

  // P = exp / sum, rounded to bf16: the S accumulators of two neighbouring
  // key tiles are exactly the A fragment of one k16 step
  uint32_t pf[kMaxTokens / 16][4];
#pragma unroll
  for (int nt = 0; nt < kMaxTokens / 8; ++nt) {
    pf[nt / 2][(nt & 1) * 2] = pack_f32(s[nt][0] / l[0], s[nt][1] / l[0]);
    pf[nt / 2][(nt & 1) * 2 + 1] = pack_f32(s[nt][2] / l[1], s[nt][3] / l[1]);
  }

  // O = P V: B fragments are pairs of V rows in one column
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int col = dt * 8 + g;
#pragma unroll
    for (int kc = 0; kc < kMaxTokens / 16; ++kc) {
      const int kr = kc * 16 + t * 2;
      mma_bf16(acc, pf[kc], pack_bf16(vs[kr][col], vs[kr + 1][col]),
               pack_bf16(vs[kr + 8][col], vs[kr + 9][col]));
    }
    const int c = dt * 8 + t * 2;
    if (r0 < ww) {
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r0) * D + c) =
          pack_f32(acc[0], acc[1]);
    }
    if (r1 < ww) {
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r1) * D + c) =
          pack_f32(acc[2], acc[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMaxTokens)
window_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ mask, float* __restrict__ o, int heads,
                  int ww, int n_windows) {
  __shared__ float ks[kMaxTokens][D];
  __shared__ float vs[kMaxTokens][D];
  __shared__ float ps[kMaxTokens][kMaxTokens + 1];  // a score row per thread

  const int head = blockIdx.x % heads;
  const int window = (blockIdx.x / heads) % n_windows;
  const size_t base = static_cast<size_t>(blockIdx.x) * ww * D;
  for (int i = threadIdx.x; i < ww * D; i += kMaxTokens) {
    ks[i / D][i % D] = k[base + i];
    vs[i / D][i % D] = v[base + i];
  }
  __syncthreads();
  const int row = threadIdx.x;
  if (row >= ww) return;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = q[base + static_cast<size_t>(row) * D + d];
  const float* bias_row = bias + (static_cast<size_t>(head) * ww + row) * ww;
  const float* mask_row =
      mask == nullptr ? nullptr : mask + (static_cast<size_t>(window) * ww + row) * ww;
  float* p = ps[row];
  float m = kNegInf;
  for (int j = 0; j < ww; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
    s += bias_row[j];
    if (mask_row != nullptr) s += mask_row[j];
    p[j] = s;
    m = fmaxf(m, s);
  }
  float l = 0.f;
  for (int j = 0; j < ww; ++j) {
    p[j] = expf(p[j] - m);
    l += p[j];
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j = 0; j < ww; ++j) {
    const float pj = p[j] / l;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vs[j][d], acc[d]);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) o[base + static_cast<size_t>(row) * D + d] = acc[d];
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
                   const float* mask, void* o, int bn, int heads, int ww, int n_windows,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(bn) * heads;
  if (dtype == 0) {
    window_bf16_kernel<D><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias, mask, static_cast<__nv_bfloat16*>(o),
        heads, ww, n_windows);
  } else {
    window_f32_kernel<D><<<blocks, kMaxTokens, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, mask, static_cast<float*>(o), heads, ww,
        n_windows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32, of q, k, v and o: contiguous [bn, heads, ww, head_dim],
// 16-byte aligned. bias: fp32 [heads, ww, ww]. mask: fp32 [n_windows, ww, ww] or
// null; window (b mod n_windows) of it goes to row b of bn.
// Returns a cudaError_t; 0 when the launch was accepted.
int ics_window_attention(int dtype, const void* q, const void* k, const void* v,
                         const void* bias, const void* mask, void* o, int bn, int heads,
                         int ww, int head_dim, int n_windows, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bn <= 0 || heads <= 0 || ww <= 0) return 0;
  if (ww > kMaxTokens || n_windows <= 0 ||
      static_cast<long long>(bn) * heads > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  switch (head_dim) {
    case 16: return static_cast<int>(launch<16>(dtype, q, k, v, b, m, o, bn, heads, ww, n_windows, s));
    case 32: return static_cast<int>(launch<32>(dtype, q, k, v, b, m, o, bn, heads, ww, n_windows, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
