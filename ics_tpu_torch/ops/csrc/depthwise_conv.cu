// Depthwise convolution for NVIDIA Hopper (sm_90a): y[b,h,w,c] =
// bias[c] + sum over (dy, dx) of x[b, h+dy-k/2, w+dx-k/2, c] * w[dy,dx,c],
// NHWC, stride 1, zero padding k/2, any odd k.
//
// Replaces the Pallas TPU kernel ics_tpu/ops/pallas_depthwise.py::depthwise_conv
// (body _dw_kernel). Contract, as the TPU kernel's: the k*k products of an
// output and its bias are summed in fp32 and rounded once to the input's
// type. The TPU wrapper pads W to a multiple of 8 and C to a multiple of 128
// in device memory, rolls along the sublane axis and crops afterwards; none
// of that is here. The kernel reads and writes the unpadded tensor and masks
// its own borders.
//
// What bounds it on an H100: there is no matrix product in it, so it is CUDA
// core work. Each input is read once and each output written once (2 x 2
// bytes in bf16) against 2*k*k fp32 operations an output: at k = 7 that is
// 24.5 FLOP a byte, just past the card's fp32 ridge (67 TFLOP/s over 3.35
// TB/s = 20), so the 7x7 is bound by arithmetic and the 3x3 and 5x5 by bytes.
//
// Design: C is innermost, so a thread owns two neighbouring channels (one
// 32-bit load in bf16, one 64-bit load in fp32; four channels, one 64-bit load,
// in bf16 at k 3 and 5 on wide tensors, where bytes are the bound and fewer,
// wider loads pay) and sixteen threads side by side read 64 or 128 contiguous
// bytes of a pixel. A block computes a tile of up to 16 rows by 8 columns of
// output pixels for its 32 or 64 channels (the host cuts
// H into equal tiles: 14 rows at H = 56, 28 and 14, 7 at H = 7). It stages
// the (rows+k-1) x (8+k-1) input tile in shared memory once, zeros where the
// image ends, and its channels' k*k taps beside it as fp32, read from either
// weight layout with neighbouring threads on neighbouring addresses. Each
// thread then computes the 8 outputs of one tile row: per input row it reads
// k+7 inputs and the k taps of that row from shared memory and does 8*k
// multiply-adds per channel, so no tap lives in a register for longer than
// one input row and three blocks fit a multiprocessor. Rows of the shared
// tile are padded by one pixel, which puts the two half-warps (two rows of
// the tile) on different banks. What the tile kernel does not take (k other
// than 3, 5, 7, an odd C, unaligned pointers) goes to a direct kernel: one
// thread an output, reading device memory through the caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__host__ __device__ inline int tile_rows(int H) {
  const int tiles = (H + kMaxRows - 1) / kMaxRows;
  return (H + tiles - 1) / tiles;
}

template <typename T, int K, int CH>
void launch_tile(const T* x, const T* w, const T* bias, T* y, int B, int H, int W, int C,
                 long long tap_stride, long long ch_stride, cudaStream_t stream) {
  const int rows = tile_rows(H);
  const int tiles_h = (H + rows - 1) / rows;
  const int tiles_w = (W + kCols - 1) / kCols;
  const int chunks = (C + kLanes * CH - 1) / (kLanes * CH);
  const unsigned blocks = static_cast<unsigned>(B) * tiles_h * tiles_w * chunks;
  dw_tile_kernel<T, K, CH><<<blocks, kLanes * rows, 0, stream>>>(
      x, w, bias, y, H, W, C, rows, tiles_h, tiles_w, chunks, tap_stride, ch_stride);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// bf16: four channels a thread (64-bit loads) at k 3 and 5, where bytes bound
// the kernel, unless blocks of 64 channels would leave over a tenth more of
// their lanes idle than blocks of 32 do; two channels a thread otherwise (k 7
// would not keep its inputs in registers).
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
                   __nv_bfloat16* y, int B, int H, int W, int C, int K, long long tap_stride,
                   long long ch_stride, cudaStream_t stream, bool* launched) {
  using T = __nv_bfloat16;
  const int chunks2 = (C + 2 * kLanes - 1) / (2 * kLanes);
  const int chunks4 = (C + 4 * kLanes - 1) / (4 * kLanes);
  const bool wide = K <= 5 && C % 4 == 0 && 11 * chunks2 >= 20 * chunks4 && aligned(x, 8) &&
                    aligned(y, 8);
  *launched = true;
  if (K == 3 && wide) launch_tile<T, 3, 4>(x, w, bias, y, B, H, W, C, tap_stride, ch_stride, stream);
  else if (K == 5 && wide) launch_tile<T, 5, 4>(x, w, bias, y, B, H, W, C, tap_stride, ch_stride, stream);
  else if (C % 2 != 0 || !aligned(x, 4) || !aligned(y, 4)) *launched = false;
  else if (K == 3) launch_tile<T, 3, 2>(x, w, bias, y, B, H, W, C, tap_stride, ch_stride, stream);
  else if (K == 5) launch_tile<T, 5, 2>(x, w, bias, y, B, H, W, C, tap_stride, ch_stride, stream);
  else if (K == 7) launch_tile<T, 7, 2>(x, w, bias, y, B, H, W, C, tap_stride, ch_stride, stream);
  else *launched = false;
  return cudaGetLastError();
}

cudaError_t launch(const float* x, const float* w, const float* bias, float* y, int B, int H,
                   int W, int C, int K, long long tap_stride, long long ch_stride,
                   cudaStream_t stream, bool* launched) {
  *launched = C % 2 == 0 && aligned(x, 8) && aligned(y, 8) && (K == 3 || K == 5 || K == 7);
  if (!*launched) return cudaSuccess;
  if (K == 3) launch_tile<float, 3, 2>(x, w, bias, y, B, H, W, C, tap_stride, ch_stride, stream);
  if (K == 5) launch_tile<float, 5, 2>(x, w, bias, y, B, H, W, C, tap_stride, ch_stride, stream);
  if (K == 7) launch_tile<float, 7, 2>(x, w, bias, y, B, H, W, C, tap_stride, ch_stride, stream);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* xv, const void* wv, const void* bv, void* yv, int B, int H, int W,
                int C, int K, long long tap_stride, long long ch_stride, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* bias = static_cast<const T*>(bv);
  T* y = static_cast<T*>(yv);
  const int rows = tile_rows(H);
  // the tile kernels' grids, at their fewest channels a block, must fit
  const long long tile_blocks = static_cast<long long>(B) * ((H + rows - 1) / rows) *
                                ((W + kCols - 1) / kCols) * ((C + 2 * kLanes - 1) / (2 * kLanes));
  bool launched = false;
  if (tile_blocks <= 2147483647LL) {
    const cudaError_t err =
        launch(x, w, bias, y, B, H, W, C, K, tap_stride, ch_stride, stream, &launched);
    if (launched) return err;
  }
  const long long total = static_cast<long long>(B) * H * W * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  dw_direct_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, w, bias, y, total, H, W, C, K, tap_stride, ch_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32, of x, w, bias and y alike. x, y: contiguous
// [B, H, W, C]. Tap (dy, dx) of channel c is w[(dy * k + dx) * tap_stride +
// c * ch_stride]. bias: C values or null. k odd.
// Returns a cudaError_t; 0 when the launch was accepted.
int ics_depthwise_conv(int dtype, const void* x, const void* w, const void* bias, void* y,
                       int B, int H, int W, int C, int k, long long tap_stride,
                       long long ch_stride, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 0 || k % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(run<__nv_bfloat16>(x, w, bias, y, B, H, W, C, k, tap_stride,
                                               ch_stride, s));
  }
  return static_cast<int>(run<float>(x, w, bias, y, B, H, W, C, k, tap_stride, ch_stride, s));
}

const char* ics_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
