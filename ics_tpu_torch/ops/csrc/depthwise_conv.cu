// Depthwise convolution for NVIDIA Hopper (sm_90a): y[b,h,w,c] =
// bias[c] + sum over (dy, dx) of x[b, h+dy-k/2, w+dx-k/2, c] * w[dy,dx,c],
// NHWC, stride 1, zero padding k/2, any odd k.
//
// Replaces the Pallas TPU kernel ics_tpu/ops/pallas_depthwise.py::depthwise_conv
// (body _dw_kernel). Contract, as the TPU kernel's: the k*k products of an
// output and its bias are summed in fp32 and rounded once to the input's
// type. The TPU wrapper pads W to a multiple of 8 and C to a multiple of 128
// in device memory, rolls along the sublane axis and crops afterwards; none
// of that is here. The kernels read and write the unpadded tensor and mask
// their own borders. The taps come as a dense [k*k, C] tensor of x's type.
//
// What bounds it on an H100: there is no matrix product in it, so it is CUDA
// core work. Each input is read once and each output written once (2 x 2
// bytes in bf16) against 2*k*k fp32 operations an output: at k = 7 that is
// 24.5 FLOP a byte, just past the card's fp32 ridge (67 TFLOP/s over 3.35
// TB/s = 20), so by the numbers the 7x7 is bound by arithmetic and the 3x3 and
// 5x5 by bytes. In practice every k is bound by the instructions a
// multiprocessor can issue: the fp32 peak needs every issue slot to be a
// multiply-add, and loads from shared memory, bf16 to fp32 conversions,
// copies, address arithmetic and stores take slots too. The design is about
// multiply-adds per issued instruction.
//
// Design (dw_strip_kernel, k 3, 5 and 7 where a pixel's channels are a
// multiple of 16 bytes: C % 8 == 0 in bf16, C % 4 == 0 in fp32):
//   - A thread owns CH neighbouring channels of Q neighbouring output columns
//     and slides down the image: it keeps k rows of fp32 sums in registers,
//     adds an input row to all k of them and stores the row that is complete.
//     A row costs it Q + k - 1 loads from shared memory and Q * k * k * CH
//     multiply-adds, and no block restages a halo of rows but at its first k-1.
//   - Its k*k*CH taps live in registers as fp32 for the whole strip, loaded
//     once from the [k*k, C] tensor (behind an empty asm, or the compiler keeps
//     the bf16 pairs and converts them again on every row: as many conversions
//     as multiply-adds). The inner loop is multiply-adds with three register
//     operands.
//   - (CH, Q) is picked by the host from what is built (strip_by_shape). Wide:
//     (4, 4) at k 3, (2, 4) at k 5, (1, 7) at k 7: 144, 200 and 343 multiply-adds
//     a row beside some 100 to 200 other instructions, in 165 to 210 registers.
//     Narrow, for calls too small to fill the card with wide threads: one
//     column, 16 bytes of it at k 3, 8 at k 5, 4 at k 7.
//   - Input rows come by cp.async in 16-byte pieces, whatever CH is, into a
//     ring of kStages row buffers, kAhead rows ahead of the row being
//     computed: the next rows load while this one is computed, and one
//     barrier a row keeps the ring (one barrier a pair of rows with a ring
//     of 8 measured 5 to 15 % slower on an H100; a ring of its own for every
//     warp, with no block-wide barrier, measured 3 to 6 % slower). A thread's
//     copy plan is the same for every row, so a row costs it one predicated
//     copy and a 64-bit add a piece. A piece outside the image (the columns
//     left and right of it, the channels past C in the last channel block) is
//     outside it on every row: it is zeroed once in every buffer of the ring
//     and never copied, which gives the zeros of the SAME padding, and
//     nothing outside x is read. Rows above and below the image are neither
//     loaded nor computed.
//   - A block is tw threads along W (tw*Q columns) by cb along C (a run of
//     cb*CH*sizeof(T) bytes a pixel, whole pixels where C is small, so that
//     C = 24 or 48 fills its lanes) and walks rh rows of one image; the host
//     picks (CH, Q, cb, tw, rh) per shape so that lanes are full, runs are at
//     least 64 bytes or all of C, and the grid fills the card.
// What this does not take (another k, another C, unaligned pointers) goes to
// the direct kernel: one thread an output, reading device memory through the
// caches. The tile kernel (a (rows+k-1) x (8+k-1) tile staged in one pass, one
// output row of 8 columns and 2 or 4 channels a thread, taps in shared memory)
// has many short threads: it serves the calls that are too small for the
// strip kernel to fill the card (one image), and is timed beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "device_guard.cuh"

namespace {

// ---- the strip kernel -----------------------------------------------------------------

constexpr int kStages = 6;   // row buffers in the ring
constexpr int kAhead = 5;    // rows in flight ahead of the one computed
constexpr int kMaxPieces = 4;  // 16-byte pieces a thread copies for one row, at most
constexpr int kMaxStripSmem = 48 * 1024;

// 16 bytes from device memory to shared memory where off >= 0, as one predicated
// instruction
__device__ __forceinline__ void cp_async_16_if(int off, uint32_t dst, const void* src) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ge.s32 p, %0, 0;\n"
      "@p cp.async.cg.shared.global [%1], [%2], 16;\n}\n" ::"r"(off),
      "r"(dst), "l"(src)
      : "memory");
}

// CH values of T as one load, one slot of shared memory, one store
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

__device__ __forceinline__ void bf16x2_to_f32(uint32_t v, float* out) {
  out[0] = __uint_as_float(v << 16);
  out[1] = __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t f32_to_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T, int CH> struct Pack;
template <> struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void unpack(uint4 v, float* o) {
    bf16x2_to_f32(v.x, o), bf16x2_to_f32(v.y, o + 2), bf16x2_to_f32(v.z, o + 4),
        bf16x2_to_f32(v.w, o + 6);
  }
  static __device__ __forceinline__ uint4 pack(const float* i) {
    return make_uint4(f32_to_bf16x2(i[0], i[1]), f32_to_bf16x2(i[2], i[3]),
                      f32_to_bf16x2(i[4], i[5]), f32_to_bf16x2(i[6], i[7]));
  }
};
template <> struct Pack<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void unpack(uint2 v, float* o) {
    bf16x2_to_f32(v.x, o), bf16x2_to_f32(v.y, o + 2);
  }
  static __device__ __forceinline__ uint2 pack(const float* i) {
    return make_uint2(f32_to_bf16x2(i[0], i[1]), f32_to_bf16x2(i[2], i[3]));
  }
};
template <> struct Pack<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void unpack(uint32_t v, float* o) { bf16x2_to_f32(v, o); }
  static __device__ __forceinline__ uint32_t pack(const float* i) {
    return f32_to_bf16x2(i[0], i[1]);
  }
};
template <> struct Pack<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void unpack(uint16_t v, float* o) {
    o[0] = __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ uint16_t pack(const float* i) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(i[0]));
  }
};
template <> struct Pack<float, 1> {
  static __device__ __forceinline__ void unpack(uint32_t v, float* o) { o[0] = __uint_as_float(v); }
  static __device__ __forceinline__ uint32_t pack(const float* i) { return __float_as_uint(i[0]); }
};
template <> struct Pack<float, 4> {
  static __device__ __forceinline__ void unpack(uint4 v, float* o) {
    o[0] = __uint_as_float(v.x), o[1] = __uint_as_float(v.y), o[2] = __uint_as_float(v.z),
    o[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* i) {
    return make_uint4(__float_as_uint(i[0]), __float_as_uint(i[1]), __float_as_uint(i[2]),
                      __float_as_uint(i[3]));
  }
};
template <> struct Pack<float, 2> {
  static __device__ __forceinline__ void unpack(uint2 v, float* o) {
    o[0] = __uint_as_float(v.x), o[1] = __uint_as_float(v.y);
  }
  static __device__ __forceinline__ uint2 pack(const float* i) {
    return make_uint2(__float_as_uint(i[0]), __float_as_uint(i[1]));
  }
};

// grid: x = w tiles * channel blocks, y = strips of rh rows, z = images;
// block: tw * cb threads, thread = (column group p of Q columns, unit cu of CH channels)
template <typename T, int K, int CH, int Q>
__global__ void __launch_bounds__(256)
dw_strip_kernel(const T* __restrict__ x, const T* __restrict__ taps,
                const T* __restrict__ bias, T* __restrict__ y, int H, int W, int C, int cb,
                int tw, int rh, int n_cblk) {
  constexpr int kUnit = CH * static_cast<int>(sizeof(T));  // bytes a thread owns of a pixel
  using R = typename Raw<kUnit>::type;
  extern __shared__ __align__(16) unsigned char ring[];

  const int cblk = blockIdx.x % n_cblk;
  const int w0 = (blockIdx.x / n_cblk) * tw * Q;  // first output column of the block
  const int h0 = blockIdx.y * rh;              // first output row
  const int rows = min(rh, H - h0);
  const int p = threadIdx.x / cb;
  const int cu = threadIdx.x - p * cb;
  const int c0 = cblk * cb * CH;               // first channel of the block
  const int c = c0 + cu * CH;
  const int n_live = c < C ? min(Q, W - w0 - p * Q) : 0;  // this thread's columns inside the image

  // The copy plan of this thread, the same for every row: piece i of a row
  // buffer is 16 bytes of pixel w0 - K/2 + i / ppr, channels from c0 on. A
  // piece outside the image (left or right of it, past C) is outside it on
  // every row: it is zeroed once in every slot of the ring and never copied.
  const int run_bytes = cb * kUnit;            // a pixel's bytes in the block: a multiple of 16
  const int ppr = run_bytes >> 4;              // pieces a pixel
  const int in_cols = tw * Q + K - 1;          // pixels of a row buffer
  const int row_bytes = in_cols * run_bytes;
  const int n_pieces = in_cols * ppr;
  const int n_rounds = (n_pieces + blockDim.x - 1) / blockDim.x;  // <= kMaxPieces, same for all
  const long long pixel_bytes = static_cast<long long>(C) * sizeof(T);
  const long long row_stride = W * pixel_bytes;  // under 2 GB
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  uint32_t dst_off[kMaxPieces];                // in the row buffer, from the ring's start
  int src_off[kMaxPieces];                     // from the image row's start; -1: not copied
#pragma unroll
  for (int q = 0; q < kMaxPieces; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    const int pp = i / ppr;
    const int wi = w0 - K / 2 + pp;
    const long long cbyte = static_cast<long long>(c0) * sizeof(T) + ((i - pp * ppr) << 4);
    const bool inside = wi >= 0 && wi < W && cbyte < pixel_bytes;
    dst_off[q] = ring_addr + (i << 4);
    src_off[q] = i < n_pieces && inside ? static_cast<int>(wi * pixel_bytes + cbyte) : -1;
    if (i < n_pieces && !inside) {
      for (int st = 0; st < kStages; ++st) {
        *reinterpret_cast<uint4*>(ring + st * row_bytes + (i << 4)) = make_uint4(0, 0, 0, 0);
      }
    }
  }
  const int img = blockIdx.z;
  const long long image_bytes = H * row_stride;
  const int n_in = rows + K - 1;               // input rows of the strip

  // The rows are loaded in the order they are walked: input row r of the
  // strip is image row h0 - K/2 + r. Always one commit, so that the groups
  // count rows. load_src runs along with the rows; it is used only where the
  // row lies inside the image.
  const unsigned char* load_src = reinterpret_cast<const unsigned char*>(x) +
                                  img * image_bytes + (h0 - K / 2) * row_stride;
  int load_r = 0, load_slot = 0;
  const auto load_next = [&] {
    const int hi = h0 - K / 2 + load_r;
    if (load_r < n_in && hi >= 0 && hi < H) {
      const uint32_t slot_off = load_slot * row_bytes;
#pragma unroll
      for (int q = 0; q < kMaxPieces; ++q) {
        if (q < n_rounds) {
          cp_async_16_if(src_off[q], dst_off[q] + slot_off, load_src + src_off[q]);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    load_src += row_stride;
    ++load_r;
    if (++load_slot == kStages) load_slot = 0;
  };

#pragma unroll
  for (int r = 0; r < kAhead; ++r) load_next();

  // this thread's taps and bias, fp32, in registers for the whole strip
  float tap[K * K][CH];
  float bv[CH];
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    R raw{};
    if (c < C) raw = *reinterpret_cast<const R*>(taps + static_cast<long long>(i) * C + c);
    Pack<T, CH>::unpack(raw, tap[i]);
    // as fp32 from here on: the compiler would rather keep the loaded pairs
    // and convert them again on every row
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) asm volatile("" : "+f"(tap[i][ch]));
  }
  {
    R raw{};
    if (bias != nullptr && c < C) raw = *reinterpret_cast<const R*>(bias + c);
    Pack<T, CH>::unpack(raw, bv);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) asm volatile("" : "+f"(bv[ch]));
  }

  const long long y_row = static_cast<long long>(W) * C;
  const unsigned char* row = ring + (p * Q * cb + cu) * kUnit;  // in the slot being computed
  const int px_bytes = cb * kUnit;             // from a pixel of the row buffer to the next
  int slot = 0;
  // acc[s]: the sums of the output row o of the strip with o % K == s
  float acc[K][Q][CH];
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) acc[s][q][ch] = 0.f;
    }
  }
  // where output row r - (K - 1) of the strip goes, running along with r
  T* y_out = y + ((static_cast<long long>(img) * H + h0 - (K - 1)) * W + w0 + p * Q) * C + c;
  int hi = h0 - K / 2;                       // image row of input row r
  for (int r0 = 0; r0 < n_in; r0 += K) {
#pragma unroll
    for (int ph = 0; ph < K; ++ph) {
      const int r = r0 + ph;
      if (r >= n_in) break;
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
      __syncthreads();  // this row has landed for every thread; the one before has been read
      load_next();
      if (hi >= 0 && hi < H) {
        float v[Q + K - 1][CH];  // the thread's Q columns and their K - 1 neighbours
#pragma unroll
        for (int j = 0; j < Q + K - 1; ++j) {
          Pack<T, CH>::unpack(*reinterpret_cast<const R*>(row + j * px_bytes), v[j]);
        }
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
#pragma unroll
          for (int dy = 0; dy < K; ++dy) {
            const int s = (ph - dy + K) % K;  // output row r - dy of the strip
#pragma unroll
            for (int q = 0; q < Q; ++q) {
#pragma unroll
              for (int ch = 0; ch < CH; ++ch) {
                acc[s][q][ch] = fmaf(v[q + dx][ch], tap[dy * K + dx][ch], acc[s][q][ch]);
              }
            }
          }
        }
      }
      // output row r - (K - 1) has seen its last input row
      {
        const int s = (ph + 1) % K;
        if (r >= K - 1) {
          if (n_live == Q) {
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              float out[CH];
#pragma unroll
              for (int ch = 0; ch < CH; ++ch) out[ch] = acc[s][q][ch] + bv[ch];
              *reinterpret_cast<R*>(y_out + q * C) = Pack<T, CH>::pack(out);
            }
          } else {
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              if (q < n_live) {
                float out[CH];
#pragma unroll
                for (int ch = 0; ch < CH; ++ch) out[ch] = acc[s][q][ch] + bv[ch];
                *reinterpret_cast<R*>(y_out + q * C) = Pack<T, CH>::pack(out);
              }
            }
          }
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) acc[s][q][ch] = 0.f;
        }
      }
      y_out += y_row;
      ++hi;
      row += row_bytes;
      if (++slot == kStages) slot = 0, row -= kStages * row_bytes;
    }
  }
}

template <typename T, int K, int CH, int Q>
cudaError_t launch_strip(const T* x, const T* taps, const T* bias, T* y, int B, int H, int W,
                         int C, int cb, int tw, int rh, cudaStream_t stream) {
  constexpr int kUnit = CH * static_cast<int>(sizeof(T));
  const int threads = cb * tw;
  const long long run_bytes = static_cast<long long>(cb) * kUnit;
  const long long row_bytes = (static_cast<long long>(tw) * Q + K - 1) * run_bytes;
  const long long smem = kStages * row_bytes;
  if (C % CH != 0 || (static_cast<long long>(C) * sizeof(T)) % 16 != 0 || run_bytes % 16 != 0 ||
      threads < 1 || threads > 256 || rh < 1 || smem > kMaxStripSmem ||
      static_cast<long long>(W) * C * sizeof(T) > 2147483647LL ||
      row_bytes / 16 > static_cast<long long>(kMaxPieces) * threads) {
    return cudaErrorInvalidValue;
  }
  const int n_cblk = (C + cb * CH - 1) / (cb * CH);
  const long long gx = static_cast<long long>((W + tw * Q - 1) / (tw * Q)) * n_cblk;
  const int gy = (H + rh - 1) / rh;
  if (gx > 2147483647LL || gy > 65535 || B > 65535) return cudaErrorInvalidValue;
  dw_strip_kernel<T, K, CH, Q><<<dim3(static_cast<unsigned>(gx), gy, B), threads,
                                 static_cast<size_t>(smem), stream>>>(
      x, taps, bias, y, H, W, C, cb, tw, rh, n_cblk);
  return cudaGetLastError();
}

// ---- the tile kernel and the direct kernel -----------------------------------------------
constexpr int kMaxRows = 16;   // output rows per block, at most
constexpr int kCols = 8;       // output columns per block: one thread's strip
constexpr int kLanes = 16;     // threads side by side along C: 16 x CH channels a block
constexpr int kThreads = 256;  // of the direct kernel; the tile kernel: 16 x rows

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// CH neighbouring values of T as raw words, for one load, one slot of shared
// memory and one store. Value-initialised, it is CH zeros.
template <typename T, int CH> struct Vec;
template <> struct Vec<__nv_bfloat16, 2> { using type = uint32_t; };
template <> struct Vec<__nv_bfloat16, 4> { using type = uint2; };
template <> struct Vec<float, 2> { using type = uint2; };

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void unpack2(uint32_t v, float* out) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  out[0] = f.x;
  out[1] = f.y;
}

template <typename T, int CH> struct Words;
template <> struct Words<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void unpack(uint32_t v, float* out) { unpack2(v, out); }
  static __device__ __forceinline__ uint32_t pack(const float* in) { return pack2(in[0], in[1]); }
};
template <> struct Words<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void unpack(uint2 v, float* out) {
    unpack2(v.x, out);
    unpack2(v.y, out + 2);
  }
  static __device__ __forceinline__ uint2 pack(const float* in) {
    return make_uint2(pack2(in[0], in[1]), pack2(in[2], in[3]));
  }
};
template <> struct Words<float, 2> {
  static __device__ __forceinline__ void unpack(uint2 v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
  }
  static __device__ __forceinline__ uint2 pack(const float* in) {
    return make_uint2(__float_as_uint(in[0]), __float_as_uint(in[1]));
  }
};

template <typename T, int K, int CH>
__global__ void __launch_bounds__(kLanes * kMaxRows)
dw_tile_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ y, int H, int W, int C,
               int rows, int tiles_h, int tiles_w, int chunks, long long tap_stride,
               long long ch_stride) {
  using P = typename Vec<T, CH>::type;
  constexpr int kChunk = kLanes * CH;    // channels per block
  constexpr int kInW = kCols + K - 1;    // input columns of the tile
  constexpr int kRow = kInW + 1;         // padded row, in pixels (odd)
  constexpr int kTapRow = kChunk + CH;   // padded row of the taps, in floats
  __shared__ P tile[kMaxRows + K - 1][kRow][kLanes];
  __shared__ __align__(16) float taps[K * K][kTapRow];

  int idx = blockIdx.x;
  const int chunk = idx % chunks;
  idx /= chunks;
  const int tw = idx % tiles_w;
  idx /= tiles_w;
  const int th = idx % tiles_h;
  const int b = idx / tiles_h;

  const int lane = threadIdx.x % kLanes;
  const int row = threadIdx.x / kLanes;            // this thread's tile row, < rows
  const int c0 = chunk * kChunk;
  const int c = c0 + CH * lane;                    // this thread's first channel
  const bool c_ok = c < C;                         // C is a multiple of CH
  const int h0 = th * rows - K / 2;                // image row of tile row 0
  const int w0 = tw * kCols - K / 2;
  const size_t image = static_cast<size_t>(b) * H * W;

  // stage the input tile: zeros outside the image and past the last channel
  const int in_rows = rows + K - 1;
  for (int i = row; i < in_rows * kInW; i += rows) {
    const int r = i / kInW;
    const int col = i % kInW;
    const int hh = h0 + r;
    const int ww = w0 + col;
    P v{};
    if (c_ok && hh >= 0 && hh < H && ww >= 0 && ww < W) {
      v = *reinterpret_cast<const P*>(x + (image + static_cast<size_t>(hh) * W + ww) * C + c);
    }
    tile[r][col][lane] = v;
  }
  // stage the taps of the block's channels as fp32, walking the weight in
  // the order it lies in memory
  for (int i = threadIdx.x; i < K * K * kChunk; i += blockDim.x) {
    const int tap = ch_stride == 1 ? i / kChunk : i % (K * K);
    const int j = ch_stride == 1 ? i % kChunk : i / (K * K);
    taps[tap][j] = c0 + j < C ? to_float(w[tap * tap_stride + (c0 + j) * ch_stride]) : 0.f;
  }
  __syncthreads();

  float acc[kCols][CH];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) acc[j][ch] = 0.f;
  }
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    float in[kInW][CH];
#pragma unroll
    for (int i = 0; i < kInW; ++i) Words<T, CH>::unpack(tile[row + dy][i][lane], in[i]);
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      float t[CH];
      if (CH == 4) {
        const float4 v = *reinterpret_cast<const float4*>(&taps[dy * K + dx][CH * lane]);
        t[0] = v.x, t[1] = v.y, t[CH - 2] = v.z, t[CH - 1] = v.w;
      } else {
        const float2 v = *reinterpret_cast<const float2*>(&taps[dy * K + dx][CH * lane]);
        t[0] = v.x, t[1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) acc[j][ch] = fmaf(in[j + dx][ch], t[ch], acc[j][ch]);
      }
    }
  }

  const int hh = th * rows + row;
  if (!c_ok || hh >= H) return;
  float bv[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) bv[ch] = bias != nullptr ? to_float(bias[c + ch]) : 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int ww = tw * kCols + j;
    if (ww < W) {
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) acc[j][ch] += bv[ch];
      *reinterpret_cast<P*>(y + (image + static_cast<size_t>(hh) * W + ww) * C + c) =
          Words<T, CH>::pack(acc[j]);
    }
  }
}

// One thread an output: any odd k, any C, any alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y, long long total,
                 int H, int W, int C, int K, long long tap_stride, long long ch_stride) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int c = static_cast<int>(e % C);
  long long pix = e / C;
  const int ww = static_cast<int>(pix % W);
  pix /= W;
  const int hh = static_cast<int>(pix % H);
  const long long image = (pix / H) * H * W;
  float acc = 0.f;
  for (int dy = 0; dy < K; ++dy) {
    const int ih = hh + dy - K / 2;
    if (ih < 0 || ih >= H) continue;
    for (int dx = 0; dx < K; ++dx) {
      const int iw = ww + dx - K / 2;
      if (iw < 0 || iw >= W) continue;
      acc = fmaf(to_float(x[(image + static_cast<long long>(ih) * W + iw) * C + c]),
                 to_float(w[(dy * K + dx) * tap_stride + c * ch_stride]), acc);
    }
  }
  if (bias != nullptr) acc += to_float(bias[c]);
  store1(y + e, acc);
}

// H is cut into the fewest tiles of at most kMaxRows rows, all equally high
inline int tile_rows(int H) {
  const int tiles = (H + kMaxRows - 1) / kMaxRows;
  return (H + tiles - 1) / tiles;
}

template <typename T, int K, int CH>
cudaError_t launch_tile(const T* x, const T* w, const T* bias, T* y, int B, int H, int W, int C,
                        cudaStream_t stream) {
  const int rows = tile_rows(H);
  const int tiles_h = (H + rows - 1) / rows;
  const int tiles_w = (W + kCols - 1) / kCols;
  const int chunks = (C + kLanes * CH - 1) / (kLanes * CH);
  const long long blocks = static_cast<long long>(B) * tiles_h * tiles_w * chunks;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  dw_tile_kernel<T, K, CH><<<static_cast<unsigned>(blocks), kLanes * rows, 0, stream>>>(
      x, w, bias, y, H, W, C, rows, tiles_h, tiles_w, chunks, C, 1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_direct(const T* x, const T* w, const T* bias, T* y, int B, int H, int W,
                          int C, int K, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * H * W * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  dw_direct_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, w, bias, y, total, H, W, C, K, C, 1);
  return cudaGetLastError();
}

// The strip kernel's thread shapes that are built, by k: (CH channels, Q columns)
template <typename T, int K>
cudaError_t strip_by_shape(int ch, int cols, const T* x, const T* w, const T* bias, T* y, int B,
                           int H, int W, int C, int cb, int tw, int rh, cudaStream_t stream) {
#define ICS_STRIP_SHAPE(KV, CHV, QV)                                                          \
  if constexpr (K == KV && CHV * sizeof(T) <= 16) {                                           \
    if (ch == CHV && cols == QV) {                                                            \
      return launch_strip<T, K, CHV, QV>(x, w, bias, y, B, H, W, C, cb, tw, rh, stream);      \
    }                                                                                         \
  }
  ICS_STRIP_SHAPE(3, 4, 4)
  ICS_STRIP_SHAPE(3, 2, 4)
  ICS_STRIP_SHAPE(3, 8, 1)
  ICS_STRIP_SHAPE(3, 4, 1)
  ICS_STRIP_SHAPE(5, 2, 4)
  ICS_STRIP_SHAPE(5, 4, 1)
  ICS_STRIP_SHAPE(7, 1, 7)
  ICS_STRIP_SHAPE(7, 2, 1)
#undef ICS_STRIP_SHAPE
  return cudaErrorInvalidValue;
}

// channels a thread of the tile kernel owns: 4 in bf16 at k 3 and 5 unless
// blocks of 64 channels would leave over a tenth more of their lanes idle than
// blocks of 32 do, else 2
template <typename T, int K>
bool tile_takes_four(int C) {
  if (!(sizeof(T) == 2 && K <= 5) || C % 4 != 0) return false;
  const int chunks2 = (C + 2 * kLanes - 1) / (2 * kLanes);
  const int chunks4 = (C + 4 * kLanes - 1) / (4 * kLanes);
  return 11 * chunks2 >= 20 * chunks4;
}

enum Variant { kDirect = 0, kStrip = 1, kTile = 2 };

template <typename T, int K>
cudaError_t run_k(int variant, const T* x, const T* w, const T* bias, T* y, int B, int H, int W,
                  int C, int ch, int cols, int cb, int tw, int rh, cudaStream_t stream) {
  if (variant == kStrip) {
    return strip_by_shape<T, K>(ch, cols, x, w, bias, y, B, H, W, C, cb, tw, rh, stream);
  }
  if constexpr (sizeof(T) == 2 && K <= 5) {
    if (tile_takes_four<T, K>(C)) return launch_tile<T, K, 4>(x, w, bias, y, B, H, W, C, stream);
  }
  if (C % 2 != 0) return cudaErrorInvalidValue;
  return launch_tile<T, K, 2>(x, w, bias, y, B, H, W, C, stream);
}

template <typename T>
cudaError_t run(int variant, const void* xv, const void* wv, const void* bv, void* yv, int B,
                int H, int W, int C, int K, int ch, int cols, int cb, int tw, int rh,
                cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* bias = static_cast<const T*>(bv);
  T* y = static_cast<T*>(yv);
  if (variant == kDirect) return launch_direct<T>(x, w, bias, y, B, H, W, C, K, stream);
  if (variant != kStrip && variant != kTile) return cudaErrorInvalidValue;
  switch (K) {
    case 3: return run_k<T, 3>(variant, x, w, bias, y, B, H, W, C, ch, cols, cb, tw, rh,
                               stream);
    case 5: return run_k<T, 5>(variant, x, w, bias, y, B, H, W, C, ch, cols, cb, tw, rh,
                               stream);
    case 7: return run_k<T, 7>(variant, x, w, bias, y, B, H, W, C, ch, cols, cb, tw, rh,
                               stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32, of x, taps, bias and y alike. x, y: contiguous
// [B, H, W, C]. taps: dense [k * k, C], tap (dy, dx) of channel c at
// taps[(dy * k + dx) * C + c]. bias: C values or null. k odd.
// variant: 0 the direct kernel (any odd k, any C, any alignment); 1 the strip
// kernel with threads of ch channels by cols columns (one of the shapes that
// strip_by_shape builds) and the geometry (cb threads along C and tw along W,
// rh rows of one image a block; k 3, 5, 7, C * sizeof(T) a multiple of 16, every
// pointer 16-byte aligned); 2 the tile kernel (k 3, 5, 7, an even C, 8-byte
// aligned pointers).
// Returns a cudaError_t; 0 when the launch was accepted.
int ics_depthwise_conv(int dtype, int variant, const void* x, const void* taps,
                       const void* bias, void* y, int B, int H, int W, int C, int k, int ch,
                       int cols, int cb, int tw, int rh, void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 0 || k % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(run<__nv_bfloat16>(variant, x, taps, bias, y, B, H, W, C, k, ch, cols,
                                               cb, tw, rh, s));
  }
  return static_cast<int>(run<float>(variant, x, taps, bias, y, B, H, W, C, k, ch, cols, cb, tw,
                                     rh, s));
}

const char* ics_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
