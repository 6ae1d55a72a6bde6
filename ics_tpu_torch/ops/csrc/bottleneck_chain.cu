// Fused ResNet bottleneck block for NVIDIA Hopper (sm_90a), launched once per
// block of a chain of stride-1 identity bottlenecks:
//   a    = relu(bn1(x . w1))            1x1, C -> Cm
//   cmid = relu(bn2(conv3x3 SAME(a)))   3x3, Cm -> Cm
//   out  = relu(bn3(cmid . w3) + x)     1x1, Cm -> C, plus the shortcut
// on NHWC bf16 activations, with folded BatchNorm as fp32 (scale, bias).
//
// Replaces the Pallas TPU kernel ics_tpu/ops/pallas_bottleneck.py::
// fused_bottleneck_chain (body _chain_kernel). It computes the same function
// with the same rounding points: bf16 operands, fp32 accumulation, scale and
// bias applied in fp32 to the accumulator (a multiply, then an add), ReLU,
// one rounding to bf16 for a, cmid and the block's output, the shortcut added
// in fp32. Outside the image the 3x3 sees zeros: a is forced to 0 there
// (relu(bias) is not 0), rows past the top and bottom edge as well as the
// columns left and right of the image.
//
// The decomposition is not the TPU kernel's. That one keeps every block's
// weights and a C-wide activation tile with a 2N-row halo in on-chip memory
// and runs the whole chain in one pass. Here a thread block has at most 227 KB
// of shared memory, so there is one launch per bottleneck, the C-wide
// activation between two bottlenecks goes through device memory (L2 holds
// most of it), and inside a launch only the Cm-wide intermediates live in
// shared memory: a for the tile's TH rows plus one halo row each side
// (recomputed per tile, the only redundant work), and cmid.
//
// What bounds it on an H100: per pixel 34 Cm^2 FLOP against 16 Cm bytes (x
// read once, out written once), i.e. 136 FLOP/B at Cm = 64 and 272 at
// Cm = 128, both under the card's ridge (~295), so device memory bounds the
// ideal kernel and the tensor cores are close behind: all three products have
// to run near the wgmma rate, and the weights (139 KB a bottleneck at Cm 64,
// 557 KB at Cm 128) have to be reused from shared memory by many pixels.
//
// Design (bottleneck_wgmma_kernel): a block of three warpgroups owns TH image
// rows of one image at full width.
//   - A producer warpgroup gives its registers away (setmaxnreg) and one lane
//     of it streams 64-deep K chunks by TMA (128-byte swizzle) into a ring of
//     2 to 4 stages behind full/empty mbarriers: a [Cm, 64] weight tile a
//     stage, and for the first 1x1 also a [128 pixels, 64 channels] tile of x
//     from a [C, H*W, B] tensor map, whose rows above and below the image the
//     hardware fills with zeros. No K loop holds a __syncthreads().
//   - Two consumer warpgroups run every product as wgmma m64nNk16 (N = 64 or
//     128; Cm 256 takes two side by side) with the weight tile as B from
//     shared memory by descriptor and A from registers through ldmatrix, where
//     every lane names its own row: for the 3x3 a tap is an address offset
//     into a (kept with a zero column each side), and a break between image
//     rows costs nothing. Each warpgroup keeps 128 fp32 sums a thread: 4
//     M tiles of 64 pixels at Cm 64, 2 at Cm 128, 1 at Cm 256, so a staged
//     weight tile is used by 512, 256 or 128 pixels before the next one is
//     needed (the first 1x1 runs 128 pixels a pass, the x tile's size). The
//     A fragments sit in two register buffers that take turns, one wgmma
//     group a k16 step, at most one group in flight behind the one being
//     loaded; the two warpgroups run apart from each other, so one's
//     fragment loads and epilogues run under the other's products.
//   - The tensor maps of the weights and of the activation buffers are kept
//     by pointer and shape (the allocator hands the same buffers back step
//     after step), so a launch encodes none in the steady state.

#include <algorithm>
#include <mutex>
#include <unordered_map>

#include "hopper.cuh"
#include "mma_frag.cuh"
#include "device_guard.cuh"

namespace {

using namespace ics;
using bf16 = __nv_bfloat16;

constexpr int kKC = 64;                      // depth of a staged K chunk
constexpr int kPad = 8;                      // bf16 of padding per shared-memory row
constexpr int kMaxSmem = 232448;             // what a block may ask for on sm_90

// scale and bias on the fp32 accumulator as a multiply and an add (no fused
// multiply-add: the plain version rounds between the two), then ReLU
__device__ __forceinline__ float bn_relu(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.f);
}

// ---- the wgmma kernel -------------------------------------------------------------------

// With -DICS_CHAIN_TRACE (tools/trace_chain.py builds it so; the serving
// library never) the first lane of each consumer warpgroup of every block
// stamps the multiprocessor's clock where a product or its epilogue ends, and
// the card's nanosecond timer at its start and end: profilers are not always
// at hand, and the stamps show where a block's time goes.
#ifdef ICS_CHAIN_TRACE
constexpr int kTraceBlocks = 1024;
constexpr int kTraceSlots = 12;
__device__ long long g_trace[kTraceBlocks][2][kTraceSlots];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
#define ICS_TRACE_ON(code)                                                          \
  do {                                                                              \
    if ((threadIdx.x & 127) == 0 && trace_block < kTraceBlocks) { code; }           \
  } while (0)
#define ICS_TRACE(slot) ICS_TRACE_ON(g_trace[trace_block][wg][slot] = clock64())
#define ICS_TRACE_NS(slot) ICS_TRACE_ON(g_trace[trace_block][wg][slot] = global_ns())
#define ICS_TRACE_ADD(slot, since) \
  ICS_TRACE_ON(g_trace[trace_block][wg][slot] += clock64() - (since))
#define ICS_TRACE_CLOCK() clock64()
#else
#define ICS_TRACE(slot)
#define ICS_TRACE_NS(slot)
#define ICS_TRACE_ADD(slot, since)
#define ICS_TRACE_CLOCK() 0
#endif

constexpr int kConsumerThreads = 256;        // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kXRows = 128;                  // pixels of one pass of the first 1x1
constexpr int kXTileBytes = kXRows * 128;    // [128 pixels][64 channels], swizzled
constexpr int kMaxStages = 4;

template <int CM>
struct Geo {
  static constexpr int NW = CM < 128 ? CM : 128;  // columns of one wgmma
  static constexpr int NS = CM / NW;              // wgmmas side by side for Cm columns
  static constexpr int MT = 256 / CM;             // M tiles a warpgroup holds: 128 sums a thread
  static constexpr int AROW = CM + kPad;          // row stride of a and cmid
  static constexpr int kWTileBytes = CM * 128;    // [Cm][64], swizzled
  static constexpr int kStageBytes = kXTileBytes + kWTileBytes;
};

struct Ring {
  int n;
  int stage = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ explicit Ring(int stages) : n(stages) {}
  __device__ __forceinline__ void advance() {
    if (++stage == n) {
      stage = 0;
      parity ^= 1;
    }
  }
};

template <int NW>
__device__ __forceinline__ void wgmma_rs(float (&d)[NW / 2], const uint32_t (&a)[4],
                                         uint64_t b_desc, int accumulate) {
  if constexpr (NW == 64) {
    wgmma_n64<0>(d, a, b_desc, accumulate);
  } else {
    wgmma_n128<0>(d, a, b_desc, accumulate);
  }
}

// One pass of a product on the consumers' side: acc[m] (+)= A_m . B over
// n_chunks K chunks from the ring, A_m being this warp's 16 rows of the
// warpgroup's M tile m, fetched by ldmatrix from a_addr(m, kc, kk, stage) (kk:
// the k16 step in the chunk). Leaves no wgmma in flight and every stage
// released.
template <int CM, int MT, typename AddrFn>
__device__ __forceinline__ void gemm_pass(
    float (&acc)[MT][Geo<CM>::NS][Geo<CM>::NW / 2], int n_chunks, Ring& ring, uint32_t ring_base,
    uint32_t full_bar, uint32_t empty_bar, int lane, AddrFn a_addr) {
  using G = Geo<CM>;
  uint32_t af[2][MT][4];
  int prev_stage = 0;
  for (int kc = 0; kc < n_chunks; ++kc) {
    mbar_wait(full_bar + 8 * ring.stage, ring.parity);
    const uint32_t w_tile = ring_base + ring.stage * G::kStageBytes + kXTileBytes;
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      // the group that read this fragment buffer two steps ago has completed
      wgmma_wait<1>();
      if (kk == 1 && kc > 0 && lane == 0) mbar_arrive(empty_bar + 8 * prev_stage);
#pragma unroll
      for (int m = 0; m < MT; ++m) ldmatrix_x4(af[kk & 1][m], a_addr(m, kc, kk, ring.stage));
      reg_fence(af[kk & 1]);
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int ns = 0; ns < G::NS; ++ns) {
          // K-major B: rows of 128 bytes, 8-row groups 1024 bytes apart; a k16
          // step is 32 bytes along the row, 128 columns are 16 KB on
          wgmma_rs<G::NW>(acc[m][ns], af[kk & 1][m],
                          wgmma_desc(w_tile + ns * 128 * 128 + kk * 32, 16, 1024),
                          (kc | kk) != 0);
        }
      }
      wgmma_commit();
    }
    prev_stage = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int ns = 0; ns < G::NS; ++ns) reg_fence(acc[m][ns]);
  }
  if (lane == 0) mbar_arrive(empty_bar + 8 * prev_stage);
}

template <int CM>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __grid_constant__ CUtensorMap w3_map,
                        const bf16* __restrict__ x, bf16* __restrict__ out,
                        const float* __restrict__ s1, const float* __restrict__ b1,
                        const float* __restrict__ s2, const float* __restrict__ b2,
                        const float* __restrict__ s3, const float* __restrict__ b3, int H, int W,
                        int C, int TH, int n_stages) {
  using G = Geo<CM>;
  constexpr int NW = G::NW, NS = G::NS, MT = G::MT, AROW = G::AROW;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle of TMA and wgmma works on address bits: 1024-byte tiles
  const uint32_t ring_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring_base - smem_u32(smem_raw));

  const int r0 = blockIdx.x * TH;          // first image row of the tile
  const int rows = min(TH, H - r0);        // rows of this tile (the last may be short)
  const int WP = W + 2;                    // a has a zero column each side
  const int M1 = (rows + 2) * W;           // pixels of a: the tile and a halo row each side
  const int M2 = rows * W;                 // pixels of cmid and out
  const int n_pass1 = (M1 + kXRows - 1) / kXRows;
  const int n_pass2 = (M2 + 2 * MT * 64 - 1) / (2 * MT * 64);
  const int a_bytes = (TH + 2) * WP * AROW * 2;
  const int u_bytes = TH * W * AROW * 2;

  bf16* const a_s = reinterpret_cast<bf16*>(ring_ptr + n_stages * G::kStageBytes);
  bf16* const u_s = reinterpret_cast<bf16*>(reinterpret_cast<uint8_t*>(a_s) + a_bytes);
  const uint32_t a_addr0 = ring_base + n_stages * G::kStageBytes;
  const uint32_t u_addr0 = a_addr0 + a_bytes;
  const uint32_t full_bar = u_addr0 + ((u_bytes + 15) & ~15);
  const uint32_t empty_bar = full_bar + 8 * kMaxStages;

  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumerThreads / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerThreads / 32) {
    // ---- producer warpgroup: one lane keeps the ring full, in the consumers' order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerThreads / 32 && lane == 0) {
      Ring ring(n_stages);
      const auto stage_addr = [&](int s) { return ring_base + s * G::kStageBytes; };
      const auto acquire = [&](uint32_t bytes) {
        mbar_wait(empty_bar + 8 * ring.stage, ring.parity ^ 1);  // the first round passes
        mbar_arrive_expect_tx(full_bar + 8 * ring.stage, bytes);
      };
      for (int pass = 0; pass < n_pass1; ++pass) {
        for (int kc = 0; kc < C / kKC; ++kc, ring.advance()) {
          acquire(G::kStageBytes);
          tma_load_3d(stage_addr(ring.stage), &x_map, full_bar + 8 * ring.stage, kc * kKC,
                      (r0 - 1) * W + pass * kXRows, blockIdx.y);
          tma_load_2d(stage_addr(ring.stage) + kXTileBytes, &w1_map, full_bar + 8 * ring.stage,
                      kc * kKC, 0);
        }
      }
      for (int pass = 0; pass < n_pass2; ++pass) {
        for (int kc = 0; kc < 9 * CM / kKC; ++kc, ring.advance()) {
          acquire(G::kWTileBytes);
          tma_load_2d(stage_addr(ring.stage) + kXTileBytes, &w2_map, full_bar + 8 * ring.stage,
                      kc * kKC, 0);
        }
      }
      for (int nb = 0; nb < C / CM; ++nb) {
        for (int pass = 0; pass < n_pass2; ++pass) {
          for (int kc = 0; kc < CM / kKC; ++kc, ring.advance()) {
            acquire(G::kWTileBytes);
            tma_load_2d(stage_addr(ring.stage) + kXTileBytes, &w3_map,
                        full_bar + 8 * ring.stage, kc * kKC, nb * CM);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, its warp wq owns rows 16 wq .. 16 wq + 15 of an M tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = wq * 16 + (lane & 15);  // the row this lane names to ldmatrix
  const int lcol = (lane >> 4) * 8;        // and its half of the k16 step
  const auto consumer_sync = [] { asm volatile("bar.sync 1, 256;\n" ::: "memory"); };

  const size_t img = static_cast<size_t>(blockIdx.y) * H * W;
  const bf16* xi = x + img * C;
  bf16* oi = out + img * C;
#ifdef ICS_CHAIN_TRACE
  const int trace_block = blockIdx.y * gridDim.x + blockIdx.x;
  ICS_TRACE_ON(g_trace[trace_block][wg][8] = 0; g_trace[trace_block][wg][9] = 0);
#endif
  ICS_TRACE_NS(10);
  ICS_TRACE(0);

  // the zero column each side of a; its interior is written by the first epilogue
  for (int i = threadIdx.x; i < (rows + 2) * 2 * (CM / 8); i += kConsumerThreads) {
    const int pix = i / (CM / 8);
    const int col = (pix & 1) ? WP - 1 : 0;
    *reinterpret_cast<uint4*>(a_s + ((pix >> 1) * WP + col) * AROW + (i % (CM / 8)) * 8) =
        make_uint4(0, 0, 0, 0);
  }

  Ring ring(n_stages);

  // ---- 1x1 reduce: a[q] for q in [0, M1), image row r0 - 1 + q / W ---------------------
  {
    float acc[1][NS][NW / 2];
    const int xrow = wg * 64 + lrow;       // this lane's row of the x tile
    for (int pass = 0; pass < n_pass1; ++pass) {
      [[maybe_unused]] const long long t_pass = ICS_TRACE_CLOCK();
      gemm_pass<CM, 1>(acc, C / kKC, ring, ring_base, full_bar, empty_bar, lane,
                       [&](int, int, int kk, int stage) {
                         // the tile as TMA swizzles it: 16-byte piece j of row r at j ^ (r & 7)
                         return ring_base + stage * G::kStageBytes + xrow * 128 +
                                (((kk * 2 + (lane >> 4)) ^ (xrow & 7)) << 4);
                       });
      ICS_TRACE_ADD(8, t_pass);
      bf16* dst[2];
      bool inside[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = min(pass * kXRows + wg * 64 + wq * 16 + g + half * 8, M1 - 1);
        const int rr = q / W;
        const int grow = r0 - 1 + rr;
        inside[half] = grow >= 0 && grow < H;
        dst[half] = a_s + (rr * WP + (q - rr * W) + 1) * AROW;
      }
      const bool live[2] = {pass * kXRows + wg * 64 + wq * 16 + g < M1,
                            pass * kXRows + wg * 64 + wq * 16 + g + 8 < M1};
#pragma unroll
      for (int ns = 0; ns < NS; ++ns) {
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int col = ns * NW + j * 8 + t * 2;
          const float2 sc = *reinterpret_cast<const float2*>(s1 + col);
          const float2 bi = *reinterpret_cast<const float2*>(b1 + col);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (!live[half]) continue;
            const float v0 = inside[half] ? bn_relu(acc[0][ns][4 * j + half * 2], sc.x, bi.x) : 0.f;
            const float v1 =
                inside[half] ? bn_relu(acc[0][ns][4 * j + half * 2 + 1], sc.y, bi.y) : 0.f;
            *reinterpret_cast<uint32_t*>(dst[half] + col) = pack_f32(v0, v1);
          }
        }
      }
    }
  }
  ICS_TRACE(1);
  consumer_sync();  // a is complete, borders included
  ICS_TRACE(2);

  float acc[MT][NS][NW / 2];

  // ---- 3x3: cmid[p] for p in [0, M2), as 9 taps of depth Cm over a ---------------------
  for (int pass = 0; pass < n_pass2; ++pass) {
    const int mt0 = (pass * 2 + wg) * MT;  // this warpgroup's first M tile of the pass
    uint32_t arow[MT];                     // top-left of this lane's pixel's 3x3 window in a
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int p = min((mt0 + m) * 64 + lrow, M2 - 1);
      const int r = p / W;
      arow[m] = a_addr0 + ((r * WP + (p - r * W)) * AROW + lcol) * 2;
    }
    gemm_pass<CM, MT>(acc, 9 * CM / kKC, ring, ring_base, full_bar, empty_bar, lane,
                      [&](int m, int kc, int kk, int) {
                        const int tap = kc * kKC / CM;
                        const int dy = tap / 3;
                        return arow[m] + ((dy * WP + (tap - dy * 3)) * AROW +
                                          (kc * kKC - tap * CM) + kk * 16) * 2;
                      });
    ICS_TRACE(3);  // of the last pass
#pragma unroll
    for (int ns = 0; ns < NS; ++ns) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        const int col = ns * NW + j * 8 + t * 2;
        const float2 sc = *reinterpret_cast<const float2*>(s2 + col);
        const float2 bi = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = (mt0 + m) * 64 + wq * 16 + g + half * 8;
            if (p >= M2) continue;
            *reinterpret_cast<uint32_t*>(u_s + p * AROW + col) =
                pack_f32(bn_relu(acc[m][ns][4 * j + half * 2], sc.x, bi.x),
                         bn_relu(acc[m][ns][4 * j + half * 2 + 1], sc.y, bi.y));
          }
        }
      }
    }
  }
  ICS_TRACE(4);
  consumer_sync();  // cmid is complete
  ICS_TRACE(5);

  // ---- 1x1 expand + shortcut: out[p], Cm columns at a time ------------------------------
  // w3t comes with its rows (the output channels) reordered within every 32:
  // column 32 G + 8 jj + 2 t + e of the product is channel 32 G + 8 t + 2 jj + e,
  // so the eight sums that this lane (t of its quad) holds of the four 8-column
  // blocks jj of a 32-column group G are eight neighbouring channels: the
  // shortcut comes in and the output goes out as the 16 bytes they are, with no
  // exchange among the lanes. The eight loads of a group of blocks go together,
  // ahead of the arithmetic on them. Both sides are streaming accesses
  // (ld.global.cs, st.global.cs: first in line for eviction from L2): this is
  // the last read of x in the launch, and the output is 25 MB at stage 0 that
  // the next launch reads from its start, so lines that stay would only push
  // out the x rows that other blocks are about to read a second time. On an
  // H100 the five launches of ResNet-50's chains took 0.381 ms with plain
  // accesses, 0.311 ms with streaming stores and 0.299 ms with both.
  constexpr int JB = 4 / MT;             // 32-column groups that eight loads cover
  constexpr int NB = NS * (NW / 32) / JB;  // batches of eight loads a pass
  for (int nb = 0; nb < C / CM; ++nb) {
    for (int pass = 0; pass < n_pass2; ++pass) {
      const int mt0 = (pass * 2 + wg) * MT;
      uint32_t urow[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int p = min((mt0 + m) * 64 + lrow, M2 - 1);
        urow[m] = u_addr0 + (p * AROW + lcol) * 2;
      }
      size_t at[MT][2];            // this lane's 8 channels of its rows, at column nb * CM
      bool live[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (mt0 + m) * 64 + wq * 16 + g + half * 8;
          live[m][half] = p < M2;
          at[m][half] = (static_cast<size_t>(r0) * W + min(p, M2 - 1)) * C + nb * CM + t * 8;
        }
      }
      uint4 raw[JB][MT][2];
      const auto load_batch = [&](int b) {
#pragma unroll
        for (int jb = 0; jb < JB; ++jb) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const uint4* src =
                  reinterpret_cast<const uint4*>(xi + at[m][half] + (b * JB + jb) * 32);
              raw[jb][m][half] = __ldcs(src);
            }
          }
        }
      };
      [[maybe_unused]] const long long t_pass = ICS_TRACE_CLOCK();
      gemm_pass<CM, MT>(acc, CM / kKC, ring, ring_base, full_bar, empty_bar, lane,
                        [&](int m, int kc, int kk, int) {
                          return urow[m] + (kc * kKC + kk * 16) * 2;
                        });
      ICS_TRACE_ADD(9, t_pass);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        load_batch(b);
#pragma unroll
        for (int jb = 0; jb < JB; ++jb) {
          const int q = b * JB + jb;           // the 32-column group of the Cm columns
          const int ns = q / (NW / 32);
          const int jq = q % (NW / 32);
          const int col = nb * CM + q * 32 + t * 8;  // this lane's 8 channels
          const float4 sc[2] = {*reinterpret_cast<const float4*>(s3 + col),
                                *reinterpret_cast<const float4*>(s3 + col + 4)};
          const float4 bi[2] = {*reinterpret_cast<const float4*>(b3 + col),
                                *reinterpret_cast<const float4*>(b3 + col + 4)};
          const float scale[8] = {sc[0].x, sc[0].y, sc[0].z, sc[0].w,
                                  sc[1].x, sc[1].y, sc[1].z, sc[1].w};
          const float bias[8] = {bi[0].x, bi[0].y, bi[0].z, bi[0].w,
                                 bi[1].x, bi[1].y, bi[1].z, bi[1].w};
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const uint4 in = raw[jb][m][half];
              uint32_t w[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int j = jq * 4 + jj;  // the 8-column block whose sums are channels 2 jj, + 1
                const float2 sh =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[jj]));
                const float y0 = __fadd_rn(
                    __fmul_rn(acc[m][ns][4 * j + half * 2], scale[2 * jj]), bias[2 * jj]);
                const float y1 = __fadd_rn(
                    __fmul_rn(acc[m][ns][4 * j + half * 2 + 1], scale[2 * jj + 1]),
                    bias[2 * jj + 1]);
                w[jj] = pack_f32(fmaxf(__fadd_rn(y0, sh.x), 0.f), fmaxf(__fadd_rn(y1, sh.y), 0.f));
              }
              if (live[m][half]) {
                uint4* dst = reinterpret_cast<uint4*>(oi + at[m][half] + q * 32);
                __stcs(dst, make_uint4(w[0], w[1], w[2], w[3]));
              }
            }
          }
        }
      }
    }
  }
  ICS_TRACE(6);
  ICS_TRACE_NS(11);
}

// ---- host side ------------------------------------------------------------------------------

inline int round_up16(int v) { return (v + 15) & ~15; }

struct Args {
  const void* x;
  void* out;
  const void *w1t, *w2t, *w3t;
  const float *s1, *b1, *s2, *b2, *s3, *b3;
  int batch, H, W, C, TH, stages;
  cudaStream_t stream;
  int device;
};

constexpr int kMaxDevices = 64;

// Tensor maps by what they are encoded from. A map holds no data, so one
// that was made for a pointer and a shape stays right for as long as they
// come back, which the allocator's reuse of buffers makes the rule.
struct MapKey {
  const void* base;
  unsigned long long d0, d1, d2;
  unsigned b0, b1;
  bool operator==(const MapKey& o) const {
    return base == o.base && d0 == o.d0 && d1 == o.d1 && d2 == o.d2 && b0 == o.b0 && b1 == o.b1;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = reinterpret_cast<size_t>(k.base);
    for (unsigned long long v : {k.d0, k.d1, k.d2, static_cast<unsigned long long>(k.b0),
                                 static_cast<unsigned long long>(k.b1)}) {
      h = h * 1000003u ^ static_cast<size_t>(v);
    }
    return h;
  }
};

// bf16 [d2][d1][d0], dense, as a 2-d (d2 = 0) or 3-d map with boxes of 64 x b1
// (x 1), 128-byte swizzled; reads outside the map give zeros
cudaError_t tensor_map(CUtensorMap* map, const void* base, unsigned long long d0,
                       unsigned long long d1, unsigned long long d2, unsigned b1) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{base, d0, d1, d2, 64, b1};
  std::lock_guard<std::mutex> lock(mu);
  const auto found = maps.find(key);
  if (found != maps.end()) {
    *map = found->second;
    return cudaSuccess;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint32_t rank = d2 ? 3 : 2;
  const cuuint64_t dims[3] = {d0, d1, d2 ? d2 : 1};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, b1, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (maps.size() >= 4096) maps.clear();  // buffers that never came back
  maps.emplace(key, *map);
  return cudaSuccess;
}

template <int CM>
cudaError_t launch_wgmma(const Args& a) {
  using G = Geo<CM>;
  if (a.stages < 2 || a.stages > kMaxStages || a.C % kKC != 0) return cudaErrorInvalidValue;
  const long long bytes =
      1024 + static_cast<long long>(a.stages) * G::kStageBytes +
      2LL * (a.TH + 2) * (a.W + 2) * G::AROW + round_up16(2 * a.TH * a.W * G::AROW) +
      2 * 8 * kMaxStages;
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap x_map, w1_map, w2_map, w3_map;
  cudaError_t err = tensor_map(&x_map, a.x, a.C, static_cast<unsigned long long>(a.H) * a.W,
                               a.batch, kXRows);
  if (err == cudaSuccess) err = tensor_map(&w1_map, a.w1t, a.C, CM, 0, CM);
  if (err == cudaSuccess) err = tensor_map(&w2_map, a.w2t, 9 * CM, CM, 0, CM);
  if (err == cudaSuccess) err = tensor_map(&w3_map, a.w3t, CM, a.C, 0, CM);
  if (err != cudaSuccess) return err;
  auto kernel = bottleneck_wgmma_kernel<CM>;
  static bool configured[kMaxDevices] = {};
  if (a.device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[a.device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured[a.device] = true;
  }
  const dim3 grid((a.H + a.TH - 1) / a.TH, a.batch);
  kernel<<<grid, kThreads, static_cast<size_t>(bytes), a.stream>>>(
      x_map, w1_map, w2_map, w3_map, static_cast<const bf16*>(a.x), static_cast<bf16*>(a.out),
      a.s1, a.b1, a.s2, a.b2, a.s3, a.b3, a.H, a.W, a.C, a.TH, a.stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One bottleneck: x, out contiguous NHWC bf16 [batch, H, W, C], out != x,
// 16-byte aligned. w1t [Cm, C], w2t [Cm, 9 * Cm] (tap-major, then input
// channel), w3t [C, Cm]: bf16, the output channel outermost; the rows of w3t
// in the order that the last 1x1's epilogue wants (row 32 G + 8 jj + 2 t + e
// holds channel 32 G + 8 t + 2 jj + e). s*, b*: fp32 folded BatchNorm.
// stages: 2 to 4 ring stages. tile_rows: image rows per thread block; the
// shared memory it needs must fit. Returns a cudaError_t; 0 when the launch
// was accepted.
int ics_bottleneck_block(const void* x, void* out, const void* w1t, const float* s1,
                         const float* b1, const void* w2t, const float* s2,
                         const float* b2, const void* w3t, const float* s3,
                         const float* b3, int batch, int H, int W, int C, int Cm,
                         int tile_rows, int stages, void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || H <= 0 || W <= 0) return 0;
  if (x == out || batch > 65535 || tile_rows < 1 || tile_rows > H || C % Cm != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, out, w1t, w2t, w3t, s1, b1, s2, b2, s3, b3, batch, H, W, C, tile_rows, stages,
               static_cast<cudaStream_t>(stream), device};
  switch (Cm) {
    case 64: return static_cast<int>(launch_wgmma<64>(a));
    case 128: return static_cast<int>(launch_wgmma<128>(a));
    case 256: return static_cast<int>(launch_wgmma<256>(a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef ICS_CHAIN_TRACE
// copies the stamps of the last launch to the host: [1024][2][12] int64
int ics_chain_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace)));
}
#endif

}  // extern "C"
