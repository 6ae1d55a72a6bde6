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
// The design is not the TPU kernel's. That one keeps every block's weights
// and a C-wide activation tile with a 2N-row halo in on-chip memory and runs
// the whole chain in one pass. Here a thread block has at most 227 KB of
// shared memory: the weights of one bottleneck (139 KB at Cm = 64, 557 KB at
// Cm = 128) and a C-wide tile (28,672 B a row at both ResNet-50 stages) do
// not fit. So:
//   - one launch per bottleneck of the chain; the C-wide activation between
//     two bottlenecks goes through device memory (L2 holds most of it), and
//     no halo is recomputed across bottlenecks;
//   - inside a launch only the Cm-wide intermediates live in shared memory:
//     a for the tile's rows plus one halo row each side (recomputed per tile,
//     the only redundant work: (TH + 2) / TH on the first 1x1), and cmid;
//   - weights stream from L2 in 64-deep K chunks through one staging buffer;
//     the x tile of the first 1x1 streams through a second one, which shares
//     its memory with cmid.
//
// Work decomposition: a block of 8 warps owns TH image rows of one image at
// full width. Each of the three products is cut into items of 16 pixels x 64
// output columns; a warp holds two items (64 fp32 accumulators) that share
// their B fragments, and 16 items make one pass over the K loop. All three
// products run on the tensor cores through mma.sync m16n8k16.
//
// What bounds it on an H100: per pixel 34 Cm^2 FLOP against 16 Cm bytes (x
// read once, out written once), i.e. 136 FLOP/B at Cm = 64 and 272 at
// Cm = 128, both under the card's ridge (~295), so device memory bounds the
// ideal kernel and the tensor cores are close behind. This version is bound
// by neither: mma.sync fed by 32-bit shared-memory loads, with a block-wide
// barrier around every 64-deep chunk. wgmma, TMA and a pipelined ring are
// later work.

#include <algorithm>

#include "mma_frag.cuh"

namespace {

using ics::mma_bf16;
using ics::pack_f32;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 64;                      // depth of a staged K chunk
constexpr int kPad = 8;                      // bf16 of padding per shared-memory row
constexpr int kWRow = kKC + kPad;            // row stride of a staged chunk
constexpr int kItems = 2;                    // items (16 pixels x 64 columns) a warp holds
constexpr int kPassItems = kWarps * kItems;  // items per pass over the K loop
constexpr int kMaxSmem = 232448;             // what a block may ask for on sm_90

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[it] += A_it (16 x 64, rows a[it][0] + row g, a[it][1] + row g + 8) * B (64 x 64),
// B staged as wb[n][k]; both items use the same B fragments
template <bool kTwo>
__device__ __forceinline__ void mma_chunk(float (&acc)[kItems][8][4],
                                          const bf16* const (&a)[kItems][2],
                                          const bf16* wb, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kKC / 16; ++kk) {
    const int k = kk * 16 + t * 2;
    uint32_t af[kItems][4];
#pragma unroll
    for (int it = 0; it < (kTwo ? 2 : 1); ++it) {
      af[it][0] = lds32(a[it][0] + k);
      af[it][1] = lds32(a[it][1] + k);
      af[it][2] = lds32(a[it][0] + k + 8);
      af[it][3] = lds32(a[it][1] + k + 8);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* br = wb + (nt * 8 + g) * kWRow + k;
      const uint32_t b0 = lds32(br);
      const uint32_t b1 = lds32(br + 8);
      mma_bf16(acc[0][nt], af[0], b0, b1);
      if (kTwo) mma_bf16(acc[1][nt], af[1], b0, b1);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kItems][8][4]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[it][nt][0] = acc[it][nt][1] = acc[it][nt][2] = acc[it][nt][3] = 0.f;
}

// rows [0, rows) x one 64-deep chunk of a row-major [*, ld] matrix -> dst[rows][kWRow]
__device__ __forceinline__ void stage_weights(bf16* dst, const bf16* src, int rows, int ld) {
  for (int i = threadIdx.x; i < rows * (kKC / 8); i += kThreads) {
    const int r = i >> 3;
    const int ch = i & 7;
    *reinterpret_cast<uint4*>(dst + r * kWRow + ch * 8) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * ld + ch * 8);
  }
}

// scale and bias on the fp32 accumulator as a multiply and an add (no fused
// multiply-add: the plain version rounds between the two), then ReLU
__device__ __forceinline__ float bn_relu(float v, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(v, s), b), 0.f);
}

template <int CM>
__global__ void __launch_bounds__(kThreads, 2)
bottleneck_block_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                        const bf16* __restrict__ w1t, const float* __restrict__ s1,
                        const float* __restrict__ b1, const bf16* __restrict__ w2t,
                        const float* __restrict__ s2, const float* __restrict__ b2,
                        const bf16* __restrict__ w3t, const float* __restrict__ s3,
                        const float* __restrict__ b3, int H, int W, int C, int TH,
                        int u_elems) {
  constexpr int NCH = CM / 64;      // 64-column chunks of a Cm-wide output
  constexpr int AROW = CM + kPad;   // row stride of a and cmid in shared memory
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int r0 = blockIdx.x * TH;          // first image row of the tile
  const int rows = min(TH, H - r0);        // rows of this tile (the last may be short)
  const int WP = W + 2;                    // a has a zero column each side
  const int M1 = (rows + 2) * W;           // pixels of a: the tile and a halo row each side
  const int M2 = rows * W;                 // pixels of cmid and out

  bf16* a_s = reinterpret_cast<bf16*>(smem);              // [(TH + 2) * WP][AROW]
  bf16* u_s = a_s + static_cast<size_t>(TH + 2) * WP * AROW;  // x chunk [<=256][kWRow], then cmid [M2][AROW]
  bf16* wbuf = u_s + u_elems;                             // [CM][kWRow]

  const size_t img = static_cast<size_t>(blockIdx.y) * H * W;
  const bf16* xi = x + img * C;
  bf16* oi = out + img * C;

  // a starts as zeros: the border columns and the halo rows outside the image
  // stay so. The barriers of the first K chunk below order this before the
  // first epilogue's stores.
  {
    const int n16 = (TH + 2) * WP * AROW / 8;
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < n16; i += kThreads) reinterpret_cast<uint4*>(a_s)[i] = z;
  }

  float acc[kItems][8][4];

  // ---- 1x1 reduce: a[q] for q in [0, M1), image row r0 - 1 + q / W -------------
  const int items1 = ((M1 + 15) >> 4) * NCH;
  for (int pass0 = 0; pass0 < items1; pass0 += kPassItems) {
    const int mt_lo = pass0 / NCH;
    const int mt_hi = min((M1 + 15) >> 4, (pass0 + kPassItems) / NCH);
    const int xrows = (mt_hi - mt_lo) * 16;
    const int item0 = pass0 + warp;
    const bool one = item0 < items1;
    const bool two = item0 + kWarps < items1;
    const int nc = item0 % NCH;            // both items of a warp share the column chunk
    const bf16* ap[kItems][2];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int lr = ((item0 + it * kWarps) / NCH - mt_lo) * 16 + g;
      ap[it][0] = u_s + lr * kWRow;
      ap[it][1] = u_s + (lr + 8) * kWRow;
    }
    zero_acc(acc);
    for (int kc = 0; kc < C / kKC; ++kc) {
      __syncthreads();  // every warp is done with the previous chunk
      stage_weights(wbuf, w1t + kc * kKC, CM, C);
      for (int i = threadIdx.x; i < xrows * (kKC / 8); i += kThreads) {
        const int r = i >> 3;
        const int ch = i & 7;
        const int q = mt_lo * 16 + r;
        const int rr = q / W;
        const int grow = r0 - 1 + rr;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (q < M1 && grow >= 0 && grow < H) {
          v = *reinterpret_cast<const uint4*>(
              xi + (static_cast<size_t>(grow) * W + (q - rr * W)) * C + kc * kKC + ch * 8);
        }
        *reinterpret_cast<uint4*>(u_s + r * kWRow + ch * 8) = v;
      }
      __syncthreads();
      if (two) {
        mma_chunk<true>(acc, ap, wbuf + nc * 64 * kWRow, g, t);
      } else if (one) {
        mma_chunk<false>(acc, ap, wbuf + nc * 64 * kWRow, g, t);
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = item0 + it * kWarps;
      if (item >= items1) continue;
      const int mt = item / NCH;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = mt * 16 + g + half * 8;
        if (q >= M1) continue;
        const int rr = q / W;
        const int grow = r0 - 1 + rr;
        const bool inside = grow >= 0 && grow < H;
        bf16* dst = a_s + (static_cast<size_t>(rr) * WP + (q - rr * W) + 1) * AROW + nc * 64;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nc * 64 + nt * 8 + t * 2;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = bn_relu(acc[it][nt][half * 2], s1[col], b1[col]);
            v1 = bn_relu(acc[it][nt][half * 2 + 1], s1[col + 1], b1[col + 1]);
          }
          *reinterpret_cast<uint32_t*>(dst + nt * 8 + t * 2) = pack_f32(v0, v1);
        }
      }
    }
  }

  // ---- 3x3: cmid[p] for p in [0, M2), as 9 taps of depth Cm over a --------------
  const int m2_tiles = (M2 + 15) >> 4;
  const int items2 = m2_tiles * NCH;
  for (int pass0 = 0; pass0 < items2; pass0 += kPassItems) {
    const int item0 = pass0 + warp;
    const bool one = item0 < items2;
    const bool two = item0 + kWarps < items2;
    const int nc = item0 % NCH;
    int aoff[kItems][2];  // top-left of the pixel's 3x3 window in a_s
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = min(((item0 + it * kWarps) / NCH) * 16 + g + half * 8, M2 - 1);
        const int r = p / W;
        aoff[it][half] = (r * WP + (p - r * W)) * AROW;
      }
    }
    zero_acc(acc);
    for (int kc = 0; kc < 9 * CM / kKC; ++kc) {
      const int tap = kc * kKC / CM;
      const int dy = tap / 3;
      const int toff = (dy * WP + (tap - dy * 3)) * AROW + (kc * kKC - tap * CM);
      __syncthreads();
      stage_weights(wbuf, w2t + kc * kKC, CM, 9 * CM);
      __syncthreads();
      const bf16* ap[kItems][2] = {
          {a_s + aoff[0][0] + toff, a_s + aoff[0][1] + toff},
          {a_s + aoff[1][0] + toff, a_s + aoff[1][1] + toff}};
      if (two) {
        mma_chunk<true>(acc, ap, wbuf + nc * 64 * kWRow, g, t);
      } else if (one) {
        mma_chunk<false>(acc, ap, wbuf + nc * 64 * kWRow, g, t);
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = item0 + it * kWarps;
      if (item >= items2) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (item / NCH) * 16 + g + half * 8;
        if (p >= M2) continue;
        bf16* dst = u_s + static_cast<size_t>(p) * AROW + nc * 64;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nc * 64 + nt * 8 + t * 2;
          *reinterpret_cast<uint32_t*>(dst + nt * 8 + t * 2) =
              pack_f32(bn_relu(acc[it][nt][half * 2], s2[col], b2[col]),
                       bn_relu(acc[it][nt][half * 2 + 1], s2[col + 1], b2[col + 1]));
        }
      }
    }
  }

  // ---- 1x1 expand + shortcut: out[p], Cm columns at a time -----------------------
  for (int nb = 0; nb < C / CM; ++nb) {
    for (int pass0 = 0; pass0 < items2; pass0 += kPassItems) {
      const int item0 = pass0 + warp;
      const bool one = item0 < items2;
      const bool two = item0 + kWarps < items2;
      const int nc = item0 % NCH;
      const bf16* arow[kItems][2];
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = min(((item0 + it * kWarps) / NCH) * 16 + g + half * 8, M2 - 1);
          arow[it][half] = u_s + static_cast<size_t>(p) * AROW;
        }
      }
      zero_acc(acc);
      for (int kc = 0; kc < CM / kKC; ++kc) {
        __syncthreads();
        stage_weights(wbuf, w3t + static_cast<size_t>(nb) * CM * CM + kc * kKC, CM, CM);
        __syncthreads();
        const bf16* ap[kItems][2] = {
            {arow[0][0] + kc * kKC, arow[0][1] + kc * kKC},
            {arow[1][0] + kc * kKC, arow[1][1] + kc * kKC}};
        if (two) {
          mma_chunk<true>(acc, ap, wbuf + nc * 64 * kWRow, g, t);
        } else if (one) {
          mma_chunk<false>(acc, ap, wbuf + nc * 64 * kWRow, g, t);
        }
      }
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int item = item0 + it * kWarps;
        if (item >= items2) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (item / NCH) * 16 + g + half * 8;
          if (p >= M2) continue;
          const size_t pix = (static_cast<size_t>(r0) * W + p) * C;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = nb * CM + nc * 64 + nt * 8 + t * 2;
            const float2 sc = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xi + pix + col));
            const float y0 = __fadd_rn(__fmul_rn(acc[it][nt][half * 2], s3[col]), b3[col]);
            const float y1 =
                __fadd_rn(__fmul_rn(acc[it][nt][half * 2 + 1], s3[col + 1]), b3[col + 1]);
            *reinterpret_cast<uint32_t*>(oi + pix + col) =
                pack_f32(fmaxf(__fadd_rn(y0, sc.x), 0.f), fmaxf(__fadd_rn(y1, sc.y), 0.f));
          }
        }
      }
    }
  }
}

inline int round_up16(int v) { return (v + 15) & ~15; }

template <int CM>
cudaError_t launch(const void* x, void* out, const void* w1t, const float* s1,
                   const float* b1, const void* w2t, const float* s2, const float* b2,
                   const void* w3t, const float* s3, const float* b3, int batch, int H,
                   int W, int C, int TH, cudaStream_t stream) {
  constexpr int NCH = CM / 64;
  constexpr int AROW = CM + kPad;
  const int x_rows = std::min(16 * kPassItems / NCH, round_up16((TH + 2) * W));
  const long long u_elems =
      std::max(static_cast<long long>(x_rows) * kWRow,
          static_cast<long long>(round_up16(TH * W)) * AROW);
  const long long bytes =
      2 * (static_cast<long long>(TH + 2) * (W + 2) * AROW + u_elems +
           static_cast<long long>(CM) * kWRow);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = bottleneck_block_kernel<CM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((H + TH - 1) / TH, batch);
  kernel<<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const bf16*>(w1t),
      s1, b1, static_cast<const bf16*>(w2t), s2, b2, static_cast<const bf16*>(w3t), s3, b3,
      H, W, C, TH, static_cast<int>(u_elems));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One bottleneck: x, out contiguous NHWC bf16 [batch, H, W, C], out != x.
// w1t [Cm, C], w2t [Cm, 9 * Cm] (tap-major, then input channel), w3t [C, Cm]:
// bf16, the output channel outermost. s*, b*: fp32 folded BatchNorm.
// tile_rows: image rows per thread block; the shared memory it needs must fit.
// Returns a cudaError_t; 0 when the launch was accepted.
int ics_bottleneck_block(const void* x, void* out, const void* w1t, const float* s1,
                         const float* b1, const void* w2t, const float* s2,
                         const float* b2, const void* w3t, const float* s3,
                         const float* b3, int batch, int H, int W, int C, int Cm,
                         int tile_rows, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || H <= 0 || W <= 0) return 0;
  if (x == out || batch > 65535 || tile_rows < 1 || tile_rows > H || C % Cm != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Cm) {
    case 64:
      return static_cast<int>(launch<64>(x, out, w1t, s1, b1, w2t, s2, b2, w3t, s3, b3,
                                         batch, H, W, C, tile_rows, s));
    case 128:
      return static_cast<int>(launch<128>(x, out, w1t, s1, b1, w2t, s2, b2, w3t, s3, b3,
                                          batch, H, W, C, tile_rows, s));
    case 256:
      return static_cast<int>(launch<256>(x, out, w1t, s1, b1, w2t, s2, b2, w3t, s3, b3,
                                          batch, H, W, C, tile_rows, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
