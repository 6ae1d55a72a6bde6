// Flash attention for NVIDIA Hopper (sm_90a): out = softmax(Q K^T / sqrt(d)) V,
// non-causal, with keys at or past `kv_len` masked. q, k, v and the output are
// [B, H, S, D] views given by their batch, head and row strides (last dimension
// contiguous, rows 16-byte aligned), so the slices of a fused qkv product and
// a [B, S, H, D] output are taken as they lie, without a copy.
//
// Replaces the Pallas TPU kernels ics_tpu/ops/attention.py::flash_attention
// (bodies _flash_kernel and _flash_kernel_single_pass) and, with the template
// parameter kBf16Exp, the bf16-exp variant of
// scripts/bench_vit_attn.py::make_variant.
//
// Contract, as the TPU kernel's: matmuls take bf16 inputs with fp32
// accumulation; the running max and sum are fp32; q is pre-scaled by
// 1/sqrt(d) rounded in its own dtype; P is rounded to bf16 before P.V; masked
// keys get p = 0 explicitly, so a fully masked row (kv_len = 0) comes back as
// exact zeros; the output is acc / max(l, 1e-30). K and V rows at or past
// kv_len are never read: they enter shared memory as zeros, so a NaN behind
// kv_len cannot meet p = 0 in the product.
//
// kBf16Exp: (s - m) * log2(e) is rounded to bf16, 2^x is taken on two bf16
// values at once (ex2.approx.ftz.bf16x2), and the fp32 row sum adds the bf16
// results, the very values that enter P.V (no second rounding).
//
// What bounds it on an H100 at ViT-B/16 @384, [32, 12, 577, 64] bf16: the
// bytes (four tensors of 28.4 MB) need 0.0339 ms, the two products (32.7
// GFLOP) 0.0331 ms at the wgmma rate, and the exponentials about 0.04 ms: one
// ex2 a score on the special-function units (16 a clock an SM) against 256
// FLOP a score on the tensor cores. The three are of one size, so the design
// has to keep them busy at once; what is reached, and what holds it, is in
// PERF.md.
//
// Design, head_dim 64 and 128 in bf16 (flash_wgmma_kernel): one persistent
// block per SM walks over items of 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows and a producer warpgroup that gives its
// registers to them (setmaxnreg). One producer lane brings K and V tiles of
// 128 keys by TMA (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 3
// stages of dynamic shared memory and runs ahead across items; each stage has
// a "full" mbarrier for K, one for V, and an "empty" mbarrier that the
// consumers' warps arrive on when their P.V has read the stage. The main loop
// has no __syncthreads(). The tensor maps are [D, S, H, B] with the tensor's
// own strides and S cut at kv_len, so the ragged last tile and everything past
// kv_len is zero-filled by the hardware. S = Q K^T is wgmma m64n128k16 with A
// (Q, scaled and rounded when loaded, the next item's prefetched) in registers
// and B the K tile as it lies (K-major); P is rounded into the A fragments of
// the second product in registers (the accumulator and A layouts match);
// acc += P V is wgmma with B the V tile as it lies, [keys, D], which is
// MN-major: the descriptor's transpose bit, no gathers. A tile's S and the
// product of the tile before are launched together, and the two warpgroups
// launch in turns (named barriers), so one's max and exponentials run under the
// other's products; the last product of an item is launched beside the first S
// of the next item. The softmax folds log2(e) into one FFMA before ex2 and
// keeps its chains of dependent maxima and sums short. Q comes in and the
// output goes out as 16-byte blocks, turned into and out of the fragment
// layout by shuffles within a quad of lanes.
//
// head_dim 16 and 32 in bf16 (flash_mma_kernel; also D 64 and 128 on request,
// as the yardstick between the two designs): mma.sync m16n8k16 with ldmatrix
// fragments (.trans for V) and a cp.async double buffer of 64-key tiles. fp32
// inputs (the TPU_PRECISION=fp32 path): plain FMA, one query row per thread.

#include <cmath>
#include <type_traits>

#include "hopper.cuh"
#include "mma_frag.cuh"
#include "device_guard.cuh"

namespace {

using namespace ics;

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // batch, head, row; in elements
};

// With -DICS_FLASH_TRACE (tools/trace_flash.py builds it so; the serving
// library never) the first lane of each consumer warpgroup of block 0 stamps
// the clock at seven points of every tile of the main loop: the card's
// profilers are not always at hand, and the stamps show where a tile's time goes.
#ifdef ICS_FLASH_TRACE
constexpr int kTraceTiles = 512;
__device__ long long g_trace[2][kTraceTiles][8];
#define ICS_TRACE(slot)                                                      \
  do {                                                                       \
    if (blockIdx.x == 0 && (threadIdx.x & 127) == 0 && trace_n < kTraceTiles) \
      g_trace[wg][trace_n][slot] = clock64();                                \
  } while (0)
#define ICS_TRACE_NEXT() ++trace_n
#else
#define ICS_TRACE(slot)
#define ICS_TRACE_NEXT()
#endif

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// Q rows r0 and r0 + 8 of one (batch, head), as they lie: lane t of a quad
// loads the 16-byte blocks t, t + 4, ... of both rows (D 16: lanes 0 and 1
// only); rows at or past seq are zeros. q_frags turns them into A fragments.
template <int D>
__device__ __forceinline__ void load_q_raw(uint4 (&raw)[2][(D + 31) / 32],
                                           const __nv_bfloat16* q_head, long long row_stride,
                                           int r0, int seq, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const __nv_bfloat16* row = q_head + static_cast<long long>(r) * row_stride;
#pragma unroll
    for (int q = 0; q < (D + 31) / 32; ++q) {
      const int block = 4 * q + t;
      raw[i][q] = r < seq && block < D / 8 ? *reinterpret_cast<const uint4*>(row + block * 8)
                                           : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The A fragments of D / 16 k16 steps (the layout of mma.sync m16n8k16 and of
// a warp's 16 rows of wgmma m64k16) from load_q_raw's blocks: q times the bf16
// scale, rounded to bf16, as the reference does
template <int D>
__device__ __forceinline__ void q_frags(uint32_t (&qf)[D / 16][4],
                                        const uint4 (&raw)[2][(D + 31) / 32], int t,
                                        float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int q = 0; q < (D + 31) / 32; ++q) {
      uint32_t w[4] = {raw[i][q].x, raw[i][q].y, raw[i][q].z, raw[i][q].w};
      quad_transpose(w, t);  // w[k]: this lane's word of block 4q + k
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int block = 4 * q + k;  // block 2kk is the low half of k16 step kk
        if (block < D / 8) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
          qf[block / 2][(block & 1) * 2 + i] = pack_f32(x.x * scale, x.y * scale);
        }
      }
    }
  }
}

// One tile of the online softmax on score fragments, in steps. s holds NB
// blocks of 8 keys: s[4j], s[4j+1] are row g, keys k0 + 8j + 2t, +1; s[4j+2],
// s[4j+3] the same keys of row g + 8 (the accumulator layout of mma.sync and
// of wgmma). kRagged: the tile reaches past kv_len (the same for the whole
// block, so the full tiles carry none of the masking).

// Masks keys >= kv_len, moves the running max m and rescales the row-sum share
// l; returns the new max times log2(e) in mb and the factor that the
// accumulator is still owed in corr.
template <int NB, bool kRagged>
__device__ __forceinline__ void softmax_max(float (&s)[NB * 4], float (&m)[2], float (&l)[2],
                                            float (&mb)[2], float (&corr)[2], int k0,
                                            int kv_len, int t) {
  if (kRagged) {
    const int left = kv_len - k0 - t * 2;  // valid keys from this thread's first on
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j * 8 + (c & 1) >= left) s[4 * j + c] = kNegInf;
      }
    }
  }
  // four running maxima a row, so that the chain of dependent maxima is short
  float part[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    part[0][j] = fmaxf(s[4 * j], s[4 * j + 1]);
    part[1][j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int j = 4; j < NB; ++j) {
    part[0][j & 3] = fmaxf(part[0][j & 3], fmaxf(s[4 * j], s[4 * j + 1]));
    part[1][j & 3] = fmaxf(part[1][j & 3], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(fmaxf(part[i][0], part[i][1]), fmaxf(part[i][2], part[i][3]));
    // the quad of lanes that shares a row
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, m[i]);
    corr[i] = ex2((m[i] - mx) * kLog2e);
    m[i] = mx;
    mb[i] = mx * kLog2e;
    l[i] *= corr[i];
  }
}

template <int DT>
__device__ __forceinline__ void rescale(float (&acc)[DT * 4], const float (&corr)[2]) {
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc[4 * dt] *= corr[0];
    acc[4 * dt + 1] *= corr[0];
    acc[4 * dt + 2] *= corr[1];
    acc[4 * dt + 3] *= corr[1];
  }
}

// P = 2^(s * log2(e) - mb) (log2(e) folded into one FFMA), rounded to bf16,
// as the A fragments of the tile's NB / 2 k16 steps in pf, and its sum into l.
// A masked key's score is -1e30 and mb is finite (every tile that is walked
// has a valid key), so its p is 2^(-1.4e30) = +0, in fp32 and in bf16 alike.
template <int NB, bool kBf16Exp>
__device__ __forceinline__ void softmax_exp(const float (&s)[NB * 4], uint32_t (&pf)[NB / 2][4],
                                            float (&l)[2], const float (&mb)[2]) {
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two running sums a row
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    uint32_t p01, p23;
    if (kBf16Exp) {
      p01 = ex2_bf16x2(pack_f32(fmaf(s[4 * j], kLog2e, -mb[0]),
                                fmaf(s[4 * j + 1], kLog2e, -mb[0])));
      p23 = ex2_bf16x2(pack_f32(fmaf(s[4 * j + 2], kLog2e, -mb[1]),
                                fmaf(s[4 * j + 3], kLog2e, -mb[1])));
      // the fp32 row sum adds the bf16 values that go into P.V
      sum[0][j & 1] += __uint_as_float(p01 << 16) + __uint_as_float(p01 & 0xffff0000u);
      sum[1][j & 1] += __uint_as_float(p23 << 16) + __uint_as_float(p23 & 0xffff0000u);
    } else {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ex2(fmaf(s[4 * j + c], kLog2e, -mb[c >> 1]));
      }
      sum[0][j & 1] += p[0] + p[1];
      sum[1][j & 1] += p[2] + p[3];
      p01 = pack_f32(p[0], p[1]);
      p23 = pack_f32(p[2], p[3]);
    }
    pf[j / 2][(j & 1) * 2] = p01;
    pf[j / 2][(j & 1) * 2 + 1] = p23;
  }
  l[0] += sum[0][0] + sum[0][1];
  l[1] += sum[1][0] + sum[1][1];
}

// the running max of the tile at k0 on s: see softmax_max
template <int NB>
__device__ __forceinline__ void tile_max(float (&s)[NB * 4], float (&m)[2], float (&l)[2],
                                         float (&mb)[2], float (&corr)[2], int k0, int kv_len,
                                         int t) {
  if (k0 + NB * 8 > kv_len) {
    softmax_max<NB, true>(s, m, l, mb, corr, k0, kv_len, t);
  } else {
    softmax_max<NB, false>(s, m, l, mb, corr, k0, kv_len, t);
  }
}

// acc / max(l, 1e-30) of rows r0 and r0 + 8, rounded to bf16 and stored as
// 16-byte blocks (lane t of a quad stores the blocks t, t + 4, ...)
template <int DT>
__device__ __forceinline__ void store_rows(const float (&acc)[DT * 4], float (&l)[2],
                                           __nv_bfloat16* o_head, long long row_stride,
                                           int r0, int seq, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    __nv_bfloat16* row = o_head + static_cast<long long>(r) * row_stride;
#pragma unroll
    for (int q = 0; q < (DT + 3) / 4; ++q) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dt = 4 * q + k;
        w[k] = dt < DT ? pack_f32(acc[4 * dt + 2 * i] * l[i], acc[4 * dt + 2 * i + 1] * l[i])
                       : 0u;
      }
      quad_transpose(w, t);  // now the four words of block 4q + t
      const int block = 4 * q + t;
      if (r < seq && block < DT) {
        *reinterpret_cast<uint4*>(row + block * 8) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// ---- wgmma, TMA and mbarrier in PTX -------------------------------------------------

constexpr int kKeys = 128;             // keys per tile of the ring
constexpr int kConsumerThreads = 256;  // two warpgroups of 64 query rows
constexpr int kWgmmaThreads = kConsumerThreads + 128;  // and the producer's warpgroup
constexpr int kBlockQW = 128;          // query rows per block

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2], const uint32_t (&a)[4],
                                         uint64_t v_desc) {
  if constexpr (D == 64) {
    wgmma_n64<1>(acc, a, v_desc, 1);
  } else {
    wgmma_n128<1>(acc, a, v_desc, 1);
  }
}

template <int D>
struct WgmmaSmem {
  static constexpr int kStages = 3;
  static constexpr int kHalfBytes = kKeys * 128;         // [128 keys][64 values], swizzled
  static constexpr int kTileBytes = kHalfBytes * (D / 64);  // one K or V tile
  static constexpr int kBarOffset = kStages * 2 * kTileBytes;
  // tiles, three mbarriers a stage, and room to align the base to 1024 bytes
  static constexpr int kBytes = kBarOffset + kStages * 3 * 8 + 1024;
};

template <int D, bool kBf16Exp>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
                   Strides qs, Strides os, int heads, int seq, int kv_len, int n_qtiles,
                   int n_items, float scale) {
  static_assert(D == 64 || D == 128, "the wgmma kernel takes head_dim 64 and 128");
  using Smem = WgmmaSmem<D>;
  constexpr int kStages = Smem::kStages;
  // the next item's Q is loaded under this item's tiles where registers allow
  constexpr bool kPrefetchQ = D == 64;
  extern __shared__ uint8_t ring_smem[];
  // the 128-byte swizzle of TMA and wgmma works on address bits: tiles start
  // on 1024 bytes
  const uint32_t tiles = (smem_u32(ring_smem) + 1023u) & ~1023u;
  const uint32_t bars = tiles + Smem::kBarOffset;
  const auto k_tile = [&](int stage) { return tiles + stage * 2 * Smem::kTileBytes; };
  const auto v_tile = [&](int stage) { return k_tile(stage) + Smem::kTileBytes; };
  const auto full_k = [&](int stage) { return bars + 8 * stage; };
  const auto full_v = [&](int stage) { return bars + 8 * (kStages + stage); };
  const auto empty = [&](int stage) { return bars + 8 * (2 * kStages + stage); };

  // tiles past kv_len hold only masked keys: p = 0 there, so they are skipped
  const int n_tiles = (kv_len + kKeys - 1) / kKeys;
  // the shuffle tells the compiler that the warp index, and what is branched
  // on it around wgmma, is the same in every lane
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // The block is persistent: it takes the items blockIdx.x, blockIdx.x +
  // gridDim.x, ... (an item is 128 query rows of one batch and head; the
  // query tiles of a head run side by side on neighbouring SMs and find K
  // and V in L2). The producer and both consumers walk the same items and
  // count the ring's tiles across them, so the loads of the next item run
  // under the last tiles and the stores of this one.
  if (warp >= kConsumerThreads / 32) {
    // ---- producer warpgroup: one lane keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerThreads / 32 && lane == 0) {
      RingPos<kStages> pos;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int bh = item / n_qtiles;
        const int b = bh / heads;
        const int h = bh % heads;
        for (int tile = 0; tile < n_tiles; ++tile, pos.advance()) {
          const int stage = pos.stage;
          mbar_wait(empty(stage), pos.parity ^ 1);  // the first round passes
          mbar_arrive_expect_tx(full_k(stage), Smem::kTileBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(k_tile(stage) + c * Smem::kHalfBytes, &k_map, full_k(stage), c * 64,
                        tile * kKeys, h, b);
          }
          mbar_arrive_expect_tx(full_v(stage), Smem::kTileBytes);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(v_tile(stage) + c * Smem::kHalfBytes, &v_map, full_v(stage), c * 64,
                        tile * kKeys, h, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup, 16 a warp ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int row_in_item = wg * 64 + (warp & 3) * 16 + g;
    const auto q_head_of = [&](int item) {
      const int bh = item / n_qtiles;
      return q + (bh / heads) * qs.b + (bh % heads) * qs.h;
    };
    const auto r0_of = [&](int item) { return (item % n_qtiles) * kBlockQW + row_in_item; };

    // The two warpgroups launch their products in turns: named barrier 1 + wg
    // is a warpgroup's leave to launch, which the other gives once its own
    // products are on their way. That keeps the two half a tile apart, one in its
    // exponentials while the other's products run. Warpgroup 0 starts.
    const auto wait_turn = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); };
    const auto pass_turn = [&] { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); };
    if (wg == 1) pass_turn();
    uint4 q_raw[2][D / 32];
    if (kPrefetchQ && blockIdx.x < n_items) {
      load_q_raw<D>(q_raw, q_head_of(blockIdx.x), qs.s, r0_of(blockIdx.x), seq, t);
    }
    RingPos<kStages> qk_pos, pv_pos;  // the tiles of the next S and of the next product
#ifdef ICS_FLASH_TRACE
    int trace_n = 0;
#endif
    uint32_t qf[D / 16][4];           // Q of the item, as A fragments
    float m[2], l[2];                 // running max and this thread's share of the running sum
    float acc[D / 2];                 // D / 8 blocks of the output fragment
    float s[kKeys / 2];               // 64 rows x 128 keys over the warpgroup
    uint32_t pf[kKeys / 16][4];       // P as A fragments
    float mb[2], corr[2];

    // S = Q K^T of the next tile, one wgmma group
    const auto start_qk = [&] {
      mbar_wait(full_k(qk_pos.stage), qk_pos.parity);
      reg_fence(qf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // K-major B: rows of 128 bytes, 8-row groups 1024 bytes apart; a k16
        // step is 32 bytes along the row, the second half of D 128 a tile half on
        const uint32_t addr = k_tile(qk_pos.stage) + (kk / 4) * Smem::kHalfBytes + (kk % 4) * 32;
        wgmma_n128<0>(s, qf[kk], wgmma_desc(addr, 16, 1024), kk > 0);
      }
      wgmma_commit();
      qk_pos.advance();
    };
    // acc += P V of the tile after the last product, one wgmma group
    const auto start_pv = [&] {
      mbar_wait(full_v(pv_pos.stage), pv_pos.parity);
      reg_fence(acc);
      reg_fence(pf);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kKeys / 16; ++kc) {
        // MN-major B (the transpose bit): 16 keys are 2048 bytes on; the two
        // 64-wide halves of D 128 are a tile half apart (the leading offset)
        wgmma_pv<D>(acc, pf[kc],
                    wgmma_desc(v_tile(pv_pos.stage) + kc * 2048, Smem::kHalfBytes, 1024));
      }
      wgmma_commit();
    };
    // the product has landed: lane 0 of the warp gives its stage back
    const auto pv_done = [&] {
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pf);
      if (lane == 0) mbar_arrive(empty(pv_pos.stage));
      pv_pos.advance();
    };
    // acc / l of an item to its rows of the output
    const auto store_item = [&](int item, float (&l_item)[2]) {
      const int bh = item / n_qtiles;
      store_rows<D / 8>(acc, l_item, o + (bh / heads) * os.b + (bh % heads) * os.h, os.s,
                        r0_of(item), seq, t);
    };
    // An item's first tile. With kOwed the product of the item before's last
    // tile is still owed: it is launched beside this item's first S and that
    // item is stored once it has landed, so the end of an item costs no more
    // than a tile of its middle.
    const auto first_tile = [&](auto owed, int item_before) {
      constexpr bool kOwed = decltype(owed)::value;
      wait_turn();
      start_qk();
      if (kOwed) start_pv();
      pass_turn();
      wgmma_wait<kOwed ? 1 : 0>();  // S of tile 0
      reg_fence(s);
      float l_before[2] = {l[0], l[1]};
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      tile_max<kKeys / 8>(s, m, l, mb, corr, 0, kv_len, t);  // acc starts at zero: no rescale
      if (kOwed) {
        pv_done();
        store_item(item_before, l_before);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      softmax_exp<kKeys / 8, kBf16Exp>(s, pf, l, mb);
    };
    // the owed product of the last item that this warpgroup took, and its store
    const auto settle = [&](int item_before) {
      start_pv();
      pv_done();
      store_item(item_before, l);
    };

    int owed_item = -1;  // the item whose last product is still owed, or none
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      if (n_tiles == 0) {  // every key is masked: exact zeros
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        l[0] = l[1] = 0.f;
        if ((item % n_qtiles) * kBlockQW + wg * 64 < seq) store_item(item, l);
        continue;
      }
      // a warpgroup whose 64 rows lie past the sequence only keeps the ring's pace
      if ((item % n_qtiles) * kBlockQW + wg * 64 >= seq) {
        if (owed_item >= 0) settle(owed_item);
        owed_item = -1;
        for (int u = 0; u < n_tiles; ++u, qk_pos.advance(), pv_pos.advance()) {
          mbar_wait(full_k(qk_pos.stage), qk_pos.parity);
          wait_turn();
          pass_turn();
          mbar_wait(full_v(qk_pos.stage), qk_pos.parity);
          if (lane == 0) mbar_arrive(empty(qk_pos.stage));
        }
        continue;
      }

      // the S of the item before's last tile was awaited: its Q can go
      if (!kPrefetchQ) load_q_raw<D>(q_raw, q_head_of(item), qs.s, r0_of(item), seq, t);
      q_frags<D>(qf, q_raw, t, scale);
      if (kPrefetchQ && item + gridDim.x < n_items) {
        const int next = item + gridDim.x;
        load_q_raw<D>(q_raw, q_head_of(next), qs.s, r0_of(next), seq, t);
      }

      // A tile's S and the product of the tile before are launched together, in
      // this warpgroup's turn. With A in registers the launch holds the warps
      // until the tensor cores have taken the fragments, so it is the other
      // warpgroup's max and exponentials that run under these products.
      if (owed_item >= 0) {
        first_tile(std::true_type{}, owed_item);
      } else {
        first_tile(std::false_type{}, owed_item);
      }
      for (int u = 1; u < n_tiles; ++u) {
        ICS_TRACE(0);
        wait_turn();
        ICS_TRACE(1);
        start_qk();
        start_pv();
        pass_turn();
        ICS_TRACE(2);
        wgmma_wait<1>();  // S of tile u
        reg_fence(s);
        ICS_TRACE(3);
        tile_max<kKeys / 8>(s, m, l, mb, corr, u * kKeys, kv_len, t);
        ICS_TRACE(4);
        pv_done();
        rescale<D / 8>(acc, corr);
        ICS_TRACE(5);
        softmax_exp<kKeys / 8, kBf16Exp>(s, pf, l, mb);
        ICS_TRACE(6);
        ICS_TRACE_NEXT();
      }
      owed_item = item;
    }
    if (owed_item >= 0) settle(owed_item);
  }
}

// ---- mma.sync with ldmatrix and a cp.async double buffer ----------------------------

constexpr int kBlockQ = 64;     // query rows per block
constexpr int kThreads = 128;   // four warps of 16 query rows
constexpr int kBlockK = 64;     // keys per shared-memory tile
constexpr int kPad = 8;         // bf16 of padding per row: ldmatrix without bank conflicts
constexpr int kBlockKF32 = 32;  // keys per tile (fp32): 2 x 32 KB at D = 128

// d += a (16x16, row-major) * b (16x8, column-major) on four accumulators of a flat array
__device__ __forceinline__ void mma_16816(float* d, const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
constexpr int mma_smem_bytes() {
  return 2 * 2 * kBlockK * (D + kPad) * 2;  // two stages of a K and a V tile
}

template <int D, bool kBf16Exp>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os, int heads, int seq,
                 int kv_len, int n_qtiles, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kRow = D + kPad;                    // bf16 per shared-memory row
  constexpr int kTileBytes = kBlockK * kRow * 2;
  extern __shared__ __align__(16) uint8_t tile_smem[];
  const uint32_t smem = smem_u32(tile_smem);        // [stage][K tile, V tile]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qt = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int r0 = qt * kBlockQ + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const __nv_bfloat16* k_head = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_head = v + b * vs.b + h * vs.h;

  // a tile's rows at or past kv_len become zeros (a zero-byte copy still
  // needs an address that may be read: the last valid row)
  const auto load_tile = [&](int tile, int stage) {
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    const uint32_t k_dst = smem + stage * 2 * kTileBytes;
    for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
      const int row = i / kChunks;
      const int ch = i % kChunks;
      const int key = tile * kBlockK + row;
      const bool valid = key < kv_len;
      const long long src_row = valid ? key : kv_len - 1;
      const uint32_t dst = k_dst + (row * kRow + ch * 8) * 2;
      cp_async_16(dst, k_head + src_row * ks.s + ch * 8, valid);
      cp_async_16(dst + kTileBytes, v_head + src_row * vs.s + ch * 8, valid);
    }
  };

  uint32_t qf[D / 16][4];
  {
    uint4 q_raw[2][(D + 31) / 32];
    load_q_raw<D>(q_raw, q + b * qs.b + h * qs.h, qs.s, r0, seq, t);
    q_frags<D>(qf, q_raw, t, scale);
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  if (n_tiles > 0) load_tile(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);  // under this tile's products
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // this tile has landed for every thread
    const uint32_t k_smem = smem + stage * 2 * kTileBytes;
    const uint32_t v_smem = k_smem + kTileBytes;

    // S = Q K^T for this warp's 16 rows x 64 keys; one ldmatrix.x4 brings the
    // B fragments of two 8-key blocks for one k16 step
    float s[kBlockK / 2];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; nt += 2) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        const int row = (nt + (lane >> 4)) * 8 + (lane & 7);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kb, k_smem + (row * kRow + col) * 2);
        mma_16816(&s[4 * nt], qf[kk], kb[0], kb[1]);
        mma_16816(&s[4 * nt + 4], qf[kk], kb[2], kb[3]);
      }
    }

    uint32_t pf[kBlockK / 16][4];
    float mb[2], corr[2];
    tile_max<kBlockK / 8>(s, m, l, mb, corr, tile * kBlockK, kv_len, t);
    rescale<D / 8>(acc, corr);
    softmax_exp<kBlockK / 8, kBf16Exp>(s, pf, l, mb);

    // acc += P V; one ldmatrix.x4.trans brings the B fragments of two 8-wide
    // blocks of D for one k16 step of keys
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
#pragma unroll
      for (int kc = 0; kc < kBlockK / 16; ++kc) {
        uint32_t vb[4];
        const int row = kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = (dt + (lane >> 4)) * 8;
        ldmatrix_x4_trans(vb, v_smem + (row * kRow + col) * 2);
        mma_16816(&acc[4 * dt], pf[kc], vb[0], vb[1]);
        mma_16816(&acc[4 * dt + 4], pf[kc], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  store_rows<D / 8>(acc, l, o + b * os.b + h * os.h, os.s, r0, seq, t);
}

// ---- fp32: plain FMA, one query row per thread --------------------------------------

template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
                 Strides vs, Strides os, int heads, int seq, int kv_len, int n_qtiles,
                 float scale) {
  __shared__ float k_tile[kBlockKF32][D];
  __shared__ float v_tile[kBlockKF32][D];

  const int qt = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int b = bh / heads;
  const int h = bh % heads;
  const int row = qt * kBlockQ + threadIdx.x;
  const bool in_range = row < seq;
  const float* q_row = q + b * qs.b + h * qs.h + static_cast<long long>(row) * qs.s;
  const float* k_head = k + b * ks.b + h * ks.h;
  const float* v_head = v + b * vs.b + h * vs.h;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = in_range ? q_row[d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kBlockKF32) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockKF32 * D; i += kBlockQ) {
      const long long key = k0 + i / D;
      k_tile[i / D][i % D] = key < kv_len ? k_head[key * ks.s + i % D] : 0.f;
      v_tile[i / D][i % D] = key < kv_len ? v_head[key * vs.s + i % D] : 0.f;
    }
    __syncthreads();
    const int n_valid = min(kBlockKF32, kv_len - k0);
    for (int j = 0; j < n_valid; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], k_tile[j][d], s);
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
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_tile[j][d], acc[d]);
    }
  }
  if (in_range) {
    const float denom = fmaxf(l, 1e-30f);
    float* o_row = o + b * os.b + h * os.h + static_cast<long long>(row) * os.s;
#pragma unroll
    for (int d = 0; d < D; ++d) o_row[d] = acc[d] / denom;
  }
}

// ---- host side ----------------------------------------------------------------------

// [D, rows, H, B] bf16 with the tensor's strides; a box is 64 values of 128
// keys of one head, 128-byte swizzled; reads outside the map give zeros
cudaError_t make_map(CUtensorMap* map, const void* base, int head_dim, int rows, int heads,
                     int batch, Strides st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(head_dim) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  // a dimension of one element may carry any stride: give it a valid one
  const cuuint64_t strides[3] = {
      rows > 1 ? static_cast<cuuint64_t>(st.s) * 2 : row_bytes,
      heads > 1 ? static_cast<cuuint64_t>(st.h) * 2 : row_bytes,
      batch > 1 ? static_cast<cuuint64_t>(st.b) * 2 : row_bytes};
  const cuuint32_t box[4] = {64, kKeys, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  Strides qs, ks, vs, os;
  int batch, heads, seq, kv_len;
  cudaStream_t stream;
  int device;
};

constexpr int kMaxDevices = 64;

template <int D, bool kBf16Exp>
cudaError_t launch_wgmma(const Args& a, float scale) {
  using Smem = WgmmaSmem<D>;
  CUtensorMap k_map, v_map;
  // the maps end at kv_len: what lies behind is never read (at least one row,
  // so that the map is valid; with kv_len = 0 no tile is loaded)
  const int rows = a.kv_len > 0 ? a.kv_len : 1;
  cudaError_t err = make_map(&k_map, a.k, D, rows, a.heads, a.batch, a.ks);
  if (err != cudaSuccess) return err;
  err = make_map(&v_map, a.v, D, rows, a.heads, a.batch, a.vs);
  if (err != cudaSuccess) return err;
  const auto kernel = flash_wgmma_kernel<D, kBf16Exp>;
  // once per device: the ring needs more than the default 48 KB of shared
  // memory, and the grid is one block per SM
  static int sm_counts[kMaxDevices] = {};
  if (a.device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_counts[a.device] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem::kBytes);
    if (err != cudaSuccess) return err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, a.device);
    if (err != cudaSuccess) return err;
    sm_counts[a.device] = count;
  }
  const int sm_count = sm_counts[a.device];
  const int n_qtiles = (a.seq + kBlockQW - 1) / kBlockQW;
  const int n_items = a.batch * a.heads * n_qtiles;
  kernel<<<n_items < sm_count ? n_items : sm_count, kWgmmaThreads, Smem::kBytes, a.stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(a.q), static_cast<__nv_bfloat16*>(a.o),
      a.qs, a.os, a.heads, a.seq, a.kv_len, n_qtiles, n_items, scale);
  return cudaGetLastError();
}

template <int D, bool kBf16Exp>
cudaError_t launch_mma(const Args& a, float scale) {
  const auto kernel = flash_mma_kernel<D, kBf16Exp>;
  static bool configured[kMaxDevices] = {};  // once per device, as above
  if (a.device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[a.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mma_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured[a.device] = true;
  }
  const int n_qtiles = (a.seq + kBlockQ - 1) / kBlockQ;
  kernel<<<a.batch * a.heads * n_qtiles, kThreads, mma_smem_bytes<D>(), a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.qs, a.ks,
      a.vs, a.os, a.heads, a.seq, a.kv_len, n_qtiles, scale);
  return cudaGetLastError();
}

template <int D, bool kBf16Exp>
cudaError_t launch_bf16(const Args& a, bool mma_sync) {
  // the reference scales q by 1/sqrt(d) rounded to q's dtype
  const float scale = __bfloat162float(
      __float2bfloat16(static_cast<float>(1.0 / sqrt(static_cast<double>(D)))));
  if constexpr (D == 64 || D == 128) {
    if (!mma_sync) return launch_wgmma<D, kBf16Exp>(a, scale);
  }
  return launch_mma<D, kBf16Exp>(a, scale);
}

template <int D>
cudaError_t launch(int dtype, const Args& a, bool bf16_exp, bool mma_sync) {
  if (dtype == 0) {
    return bf16_exp ? launch_bf16<D, true>(a, mma_sync) : launch_bf16<D, false>(a, mma_sync);
  }
  const int n_qtiles = (a.seq + kBlockQ - 1) / kBlockQ;
  flash_f32_kernel<D><<<a.batch * a.heads * n_qtiles, kBlockQ, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.qs, a.ks, a.vs, a.os,
      a.heads, a.seq, a.kv_len, n_qtiles,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef ICS_FLASH_TRACE
// copies the clock stamps of the last launch to the host: [2][512][8] int64
int ics_flash_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace)));
}
#endif

// dtype: 0 = bf16, 1 = fp32. q, k, v, o: [batch, heads, seq, head_dim] views;
// strides: their batch, head and row strides in elements, q's three first,
// then k's, v's and o's; the last dimension is contiguous and, for bf16,
// every stride a multiple of 8 elements and every pointer 16-byte aligned.
// kv_len: keys at or past it are masked (0 <= kv_len <= seq).
// bf16_exp: non-zero takes the bf16-exp variant (dtype 0 only).
// mma_sync: non-zero sends bf16 head_dim 64 and 128 to the mma.sync kernel
// (head_dim 16 and 32 always take it), for a side-by-side measurement.
// Returns a cudaError_t; 0 when the launch was accepted.
int ics_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int seq, int head_dim, int kv_len,
                        const long long* strides, int bf16_exp, int mma_sync, void* stream,
                        int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16_exp != 0 && dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  if (kv_len < 0 || kv_len > seq) return static_cast<int>(cudaErrorInvalidValue);
  const auto at = [&](int i) {
    return Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  const Args a{q, k, v, o, at(0), at(1), at(2), at(3), batch, heads, seq, kv_len,
               static_cast<cudaStream_t>(stream), device};
  const bool bx = bf16_exp != 0;
  const bool ms = mma_sync != 0;
  switch (head_dim) {
    case 16: return static_cast<int>(launch<16>(dtype, a, bx, ms));
    case 32: return static_cast<int>(launch<32>(dtype, a, bx, ms));
    case 64: return static_cast<int>(launch<64>(dtype, a, bx, ms));
    case 128: return static_cast<int>(launch<128>(dtype, a, bx, ms));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
