// Flash attention for NVIDIA Hopper (sm_90a): out = softmax(Q K^T / sqrt(d)) V
// over [B, H, S, D] tensors, non-causal, with keys at or past `kv_len` masked.
//
// Replaces the Pallas TPU kernel ics_tpu/ops/attention.py::flash_attention
// (bodies _flash_kernel and _flash_kernel_single_pass). One online-softmax
// kernel covers both bodies, for any S and for D in {16, 32, 64, 128}. It reads
// [B, H, S, D] as it is and masks the ragged edges itself, where the TPU
// wrapper padded S and D to 128.
//
// Contract, as the TPU kernel's: matmuls take bf16 inputs with fp32
// accumulation; the running max and sum are fp32; q is pre-scaled by
// 1/sqrt(d) in its own dtype; P is rounded to bf16 before P.V; masked keys
// get p = 0 explicitly, so a fully masked row (kv_len = 0) comes back as
// exact zeros; the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: at ViT-B/16 @384 one (batch, head) reads
// 3 x 577 x 64 bf16 = 222 KB and does 4 x 577^2 x 64 = 85 MFLOP, about 290
// FLOP per byte of device memory, right at the card's ridge (~295 for bf16).
// The [S, S] score matrix never leaves registers, and the K/V tiles that
// the ten query tiles of a head share come back from L2, so the tensor
// cores bound it. This first version issues mma.sync (m16n8k16), which
// reaches well under the wgmma rate; a wgmma/TMA pipeline is later work.
//
// Design: one block per (batch*head, 64-query tile), four warps of 16 query
// rows each. Q fragments stay in registers for the whole pass. K and V
// tiles of 64 keys go through shared memory, rows padded by 8 bf16 so that
// the fragment reads are free of bank conflicts. The fp32 variant (the
// TPU_PRECISION=fp32 path) is plain FMA, one query row per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kBlockQ = 64;        // query rows per block
constexpr int kWarps = 4;          // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;        // keys per shared-memory tile (bf16)
constexpr int kBlockKF32 = 32;     // keys per tile (fp32): 2 x 32 KB at D=128
constexpr int kPad = 8;            // bf16 of padding per shared-memory row
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel

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

// two neighbouring q values of one row, times the bf16 scale, rounded to bf16
__device__ __forceinline__ uint32_t load_q_pair(const __nv_bfloat16* row_ptr,
                                                bool in_range, float scale) {
  if (!in_range) return 0u;
  float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row_ptr));
  return pack_f32(x.x * scale, x.y * scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int seq, int kv_len,
                  float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK][D + kPad];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const size_t base = static_cast<size_t>(blockIdx.x) * seq * D;
  const int r0 = blockIdx.y * kBlockQ + warp * 16 + g;  // this thread's rows
  const int r1 = r0 + 8;                                // r0 and r0 + 8

  // Q as A fragments, pre-scaled in bf16 as the reference does
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = load_q_pair(q + base + static_cast<size_t>(r0) * D + c, r0 < seq, scale);
    qf[kk][1] = load_q_pair(q + base + static_cast<size_t>(r1) * D + c, r1 < seq, scale);
    qf[kk][2] = load_q_pair(q + base + static_cast<size_t>(r0) * D + c + 8, r0 < seq, scale);
    qf[kk][3] = load_q_pair(q + base + static_cast<size_t>(r1) * D + c + 8, r1 < seq, scale);
  }

  float m[2] = {kNegInf, kNegInf};  // running max of rows r0, r1
  float l[2] = {0.f, 0.f};          // this thread's share of the running sum
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // tiles past kv_len hold only masked keys: p = 0 there, so they are skipped
  const int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
      const int row = i / kChunks;
      const int ch = i % kChunks;
      const int key = k0 + row;
      uint4 kx = make_uint4(0, 0, 0, 0);
      uint4 vx = make_uint4(0, 0, 0, 0);
      if (key < kv_len) {
        const size_t off = base + static_cast<size_t>(key) * D + ch * 8;
        kx = *reinterpret_cast<const uint4*>(k + off);
        vx = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[row][ch * 8]) = kx;
      *reinterpret_cast<uint4*>(&vs[row][ch * 8]) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, as 8 tiles of 16x8
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + t * 2];
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask, then the new running max over the quad that shares each row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + t * 2 + j < kv_len;
        s[nt][j] = ok ? s[nt][j] : kNegInf;
        s[nt][2 + j] = ok ? s[nt][2 + j] : kNegInf;
        mx[0] = fmaxf(mx[0], s[nt][j]);
        mx[1] = fmaxf(mx[1], s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float corr = __expf(m[i] - mx[i]);
      l[i] *= corr;
      m[i] = mx[i];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * i] *= corr;
        acc[dt][2 * i + 1] *= corr;
      }
    }

    // P = exp(S - m) with p = 0 on masked keys; the S accumulators of two
    // neighbouring key tiles are exactly the A fragment of one k16 step
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + t * 2 + j < kv_len;
        p[j] = ok ? __expf(s[nt][j] - m[0]) : 0.f;
        p[2 + j] = ok ? __expf(s[nt][2 + j] - m[1]) : 0.f;
      }
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pf[nt / 2][(nt & 1) * 2] = pack_f32(p[0], p[1]);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_f32(p[2], p[3]);
    }

    // acc += P V: B fragments are pairs of V rows in one column
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + g;
#pragma unroll
      for (int kc = 0; kc < kBlockK / 16; ++kc) {
        const int kr = kc * 16 + t * 2;
        mma_bf16(acc[dt], pf[kc], pack_bf16(vs[kr][col], vs[kr + 1][col]),
                 pack_bf16(vs[kr + 8][col], vs[kr + 9][col]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (r0 < seq) {
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r0) * D + c) =
          pack_f32(acc[dt][0] / l[0], acc[dt][1] / l[0]);
    }
    if (r1 < seq) {
      *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r1) * D + c) =
          pack_f32(acc[dt][2] / l[1], acc[dt][3] / l[1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int seq,
                 int kv_len, float scale) {
  __shared__ float ks[kBlockKF32][D];
  __shared__ float vs[kBlockKF32][D];

  const size_t base = static_cast<size_t>(blockIdx.x) * seq * D;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
  const bool in_range = row < seq;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = in_range ? q[base + static_cast<size_t>(row) * D + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kBlockKF32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockKF32 * D; i += kBlockQ) {
      const int key = k0 + i / D;
      const size_t off = base + static_cast<size_t>(key) * D + i % D;
      ks[i / D][i % D] = key < kv_len ? k[off] : 0.f;
      vs[i / D][i % D] = key < kv_len ? v[off] : 0.f;
    }
    __syncthreads();
    const int n_valid = min(kBlockKF32, kv_len - k0);
    for (int j = 0; j < n_valid; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      if (s > m) {  // rescale only when the running max moves
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= corr;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
  }
  if (in_range) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) o[base + static_cast<size_t>(row) * D + d] = acc[d] / denom;
  }
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   int bh, int seq, int kv_len, cudaStream_t stream) {
  const dim3 grid(bh, (seq + kBlockQ - 1) / kBlockQ);
  // the reference scales q by 1/sqrt(d) rounded to q's dtype
  const float scale_f32 = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  if (dtype == 0) {
    const float scale = __bfloat162float(__float2bfloat16(scale_f32));
    flash_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), seq,
        kv_len, scale);
  } else {
    flash_f32_kernel<D><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), seq, kv_len, scale_f32);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32. q, k, v, o: contiguous [bh, seq, head_dim].
// kv_len: keys at or past it are masked (0 <= kv_len <= seq).
// Returns a cudaError_t; 0 when the launch was accepted.
int ics_flash_attention(int dtype, const void* q, const void* k, const void* v,
                        void* o, int bh, int seq, int head_dim, int kv_len,
                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || seq <= 0) return 0;
  if (kv_len < 0 || kv_len > seq) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch<16>(dtype, q, k, v, o, bh, seq, kv_len, s));
    case 32: return static_cast<int>(launch<32>(dtype, q, k, v, o, bh, seq, kv_len, s));
    case 64: return static_cast<int>(launch<64>(dtype, q, k, v, o, bh, seq, kv_len, s));
    case 128: return static_cast<int>(launch<128>(dtype, q, k, v, o, bh, seq, kv_len, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ics_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
