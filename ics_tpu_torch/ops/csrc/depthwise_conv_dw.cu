// Gradient of the depthwise convolution's taps and bias for NVIDIA Hopper (sm_90a):
//   dtaps[i k + j, c] = sum over (b, h, w) of x[b, h + i - k/2, w + j - k/2, c] dy[b, h, w, c]
//   dbias[c]          = sum over (b, h, w) of dy[b, h, w, c]
// over the zero-padded (SAME) input, NHWC, stride 1, odd k from 3 to 11; x and dy in bf16
// or fp32, every sum and both outputs in fp32.
//
// The TPU kernel that depthwise_conv.cu replaces (ics_tpu/ops/pallas_depthwise.py::
// depthwise_conv) has no backward: the JAX package trains through XLA's convolution.
// This is the parameter gradient of the port's forward kernel, for training through it.
//
// What bounds it on an H100: x and dy are read once (4 bytes a pixel-channel in bf16)
// against 2 k^2 operations a pixel-channel: 24.5 FLOP a byte at k 7. The sums are fp32 and
// per channel (no tensor-core product has the shape), so the fp32 SIMT rate (67 TFLOP/s,
// 20 FLOP a byte at 3.35 TB/s) is the roof that counts: k 7 is bound by operations, k 3
// and 5 by bytes. ConvNeXt-T's 18 calls at batch 32 do 6.7 GFLOP, 0.100 ms at that peak.
// The first design (a warp a tap row, every x and dy value loaded from L1 once a tap row,
// 2-byte loads, a window shifted by moves, 320 strips of partials summed by 4,896
// threads in series) ran at 7 % of it.
//
// Design (deterministic: no atomics):
//   1. dw_grad_kernel. A block is 32 channels by k tap rows: thread (pair, i) owns two
//      neighbouring channels (one bf16x2 word) and tap row i, 2k fp32 sums of taps
//      (i, 0..k-1) and two of the bias. The block walks a run of rows (b, h) of the batch
//      over one tile of at most 64 columns, and stages in shared memory, by 16-byte
//      cp.async, the x rows of the window (the tile and a halo of k/2 columns; rows and
//      columns outside the image arrive, or stay, zero) in a ring of k + 1 rows, and the
//      dy row in a ring of two: the copies of row h + 1 fly while row h is summed, one
//      barrier a row. Each x and dy row is staged once a run (k - 1 rows of halo at the
//      run's start and at each new image).
//      A thread slides along its x row with k words in registers and reads one word of
//      dy and one of x a column: the column loop is unrolled by k, so the window moves by
//      renaming registers, and a row's tail is zeros in shared memory, not a branch. The
//      bias sum takes dy as it passes, in every thread (no branch; the middle tap row
//      writes it). Rows of the x ring are an odd number of 64-byte pixels apart, so the two
//      tap rows of a warp read distinct banks; both read one dy word (a broadcast).
//      The planner in ops/depthwise.py cuts the rows into as many runs as fit the card at
//      once, at most 512 partial rows a channel slice: each block writes its k^2 + 1 sums
//      a channel once, to a partial row of its own.
//   2. dw_grad_reduce_kernel: a block per 32 outputs of the (k^2 + 1) C; row y of its
//      threads adds partial rows y, y + 8, ... in order, then a fixed tree over the rows.
// The tap and bias sums of one call are therefore the same on every run. A C whose pixel
// is no multiple of 16 bytes, or a base that is not 16-byte aligned, is staged by plain
// loads instead of cp.async (the shape decides, never a failure).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_frag.cuh"
#include "device_guard.cuh"

namespace {

using namespace ics;
using bf16 = __nv_bfloat16;

constexpr int kPairs = 16;               // channel pairs a block
constexpr int kChannels = 2 * kPairs;    // channels a block: a slice
constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;         // what a block may ask for on sm_90
constexpr int kSumLanes = 32;            // outputs a block of dw_grad_reduce_kernel
constexpr int kSumRows = 8;              // partial rows it adds side by side

struct Params {
  const void* x;
  const void* dy;
  float* part;         // [slots, (k^2 + 1) C]: a block's tap sums, then its bias sums
  int B, H, W, C;
  int tile_w;          // output columns a tile (the last may be shorter)
  int rows;            // rows (b, h) a run, of the B H rows in order
  int runs;            // runs a tile; block x takes tile x / runs, run x mod runs
  int xc, dyc;         // pixels a staged row of x and of dy
  int aligned;         // 16-byte pieces: C a multiple of 16 bytes' channels, bases aligned
  int n_out;           // (k^2 + 1) C
};

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__device__ __forceinline__ T zero_value() {
  if constexpr (std::is_same<T, float>::value) {
    return 0.f;
  } else {
    return __float2bfloat16_rn(0.f);
  }
}

// Copies `pix` pixels of the block's 32 channels (from c0) from src (pixel 0 at src,
// pixels C apart) to dst (pixels kChannels apart); channels past C, or every channel where
// `zero`, arrive as zeros. Nothing waits for the cp.async pieces here.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_row(const Params& p, T* dst, const T* src, int pix,
                                          int c0, bool zero, int tid) {
  constexpr int PIECE = 16 / sizeof(T);             // channels a 16-byte piece
  constexpr int PIECES = kChannels / PIECE;         // pieces a pixel
  if (p.aligned) {
    const uint32_t base = smem_u32(dst);
    for (int e = tid; e < pix * PIECES; e += kThreads) {
      const int px = e / PIECES;
      const int pc = e - px * PIECES;
      const int c = c0 + pc * PIECE;
      const bool ok = !zero && c < p.C;
      cp_async_16(base + (px * kChannels + pc * PIECE) * static_cast<int>(sizeof(T)),
                  ok ? src + static_cast<long long>(px) * p.C + pc * PIECE : src, ok);
    }
  } else {
    for (int e = tid; e < pix * kChannels; e += kThreads) {
      const int px = e / kChannels;
      const int cc = e - px * kChannels;
      dst[px * kChannels + cc] = !zero && c0 + cc < p.C
                                     ? src[static_cast<long long>(px) * p.C + cc]
                                     : zero_value<T>();
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kPairs * K)
dw_grad_kernel(const Params p) {
  constexpr int P = K / 2;
  constexpr int S = K + 1;                  // x rows in the ring: a row's k and the next
  constexpr int kThreads = kPairs * K;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);                  // [S][xc][kChannels]
  T* dys = xs + S * p.xc * kChannels;                      // [2][dyc][kChannels]
  const int tid = threadIdx.x;
  const int pair = tid % kPairs;
  const int i = tid / kPairs;               // tap row
  const int tile = blockIdx.x / p.runs;
  const int run = blockIdx.x - tile * p.runs;
  const int c0 = blockIdx.y * kChannels;
  const int w0 = tile * p.tile_w;
  const int tw = min(p.tile_w, p.W - w0);
  const int xa = max(0, w0 - P);            // the first image column of x staged
  const int x_pix = min(p.W, w0 + tw + P) - xa;
  const int x_at = xa - (w0 - P);           // its column in a staged row
  const int chunks = (tw + K - 1) / K;
  const long long row_elems = static_cast<long long>(p.W) * p.C;
  const T* x = static_cast<const T*>(p.x) + c0;
  const T* dy = static_cast<const T*>(p.dy) + c0;

  // everything zeroed once: columns outside the image and past the tile stay zero
  const int total = (S * p.xc + 2 * p.dyc) * kChannels * static_cast<int>(sizeof(T));
  for (int e = tid * 16; e < total; e += kThreads * 16) {
    *reinterpret_cast<uint4*>(smem_raw + e) = make_uint4(0, 0, 0, 0);
  }

  float2 acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = make_float2(0.f, 0.f);
  float2 bsum = make_float2(0.f, 0.f);

  // x row r of image b into ring row (r + P) mod S; a row outside the image as zeros
  auto stage_x = [&](int b, int r) {
    const bool outside = r < 0 || r >= p.H;
    const T* src = x + (static_cast<long long>(b) * p.H + (outside ? 0 : r)) * row_elems +
                   static_cast<long long>(xa) * p.C;
    stage_row<T, kThreads>(p, xs + (((r + P) % S) * p.xc + x_at) * kChannels, src, x_pix, c0,
                           outside, tid);
  };
  auto stage_dy = [&](int b, int h) {
    const T* src = dy + (static_cast<long long>(b) * p.H + h) * row_elems +
                   static_cast<long long>(w0) * p.C;
    stage_row<T, kThreads>(p, dys + (h & 1) * p.dyc * kChannels, src, tw, c0, false, tid);
  };

  const int r_end = static_cast<int>(
      min(static_cast<long long>(p.B) * p.H, static_cast<long long>(run + 1) * p.rows));
  for (int r = run * p.rows; r < r_end;) {
    const int b = r / p.H;
    const int h_s = r - b * p.H;
    const int h_e = min(p.H, h_s + (r_end - r));
    __syncthreads();  // the last segment's rows are done with (and the zeros are in)
    for (int xr = h_s - P; xr <= h_s + P; ++xr) stage_x(b, xr);
    stage_dy(b, h_s);
    cp_async_commit();
    for (int h = h_s; h < h_e; ++h) {
      cp_async_wait<0>();
      __syncthreads();  // row h has landed for every thread; row h - 1 is summed
      if (h + 1 < h_e) {
        stage_x(b, h + 1 + P);
        stage_dy(b, h + 1);
      }
      cp_async_commit();
      const T* xrow = xs + ((h + i) % S) * p.xc * kChannels + 2 * pair;   // x row h + i - P
      const T* dyrow = dys + (h & 1) * p.dyc * kChannels + 2 * pair;
      float2 win[K];
#pragma unroll
      for (int j = 0; j < K; ++j) win[j] = load_pair(xrow + j * kChannels);
      for (int ch = 0; ch < chunks; ++ch) {
#pragma unroll
        for (int u = 0; u < K; ++u) {
          const int w = ch * K + u;
          const float2 d = load_pair(dyrow + w * kChannels);
#pragma unroll
          for (int j = 0; j < K; ++j) {
            acc[j].x = fmaf(win[(u + j) % K].x, d.x, acc[j].x);
            acc[j].y = fmaf(win[(u + j) % K].y, d.y, acc[j].y);
          }
          bsum.x += d.x;
          bsum.y += d.y;
          win[u] = load_pair(xrow + (w + K) * kChannels);
        }
      }
    }
    r += h_e - h_s;
  }
  cp_async_wait<0>();

  float* out = p.part + static_cast<long long>(blockIdx.x) * p.n_out;
  const int c = c0 + 2 * pair;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (c < p.C) out[(i * K + j) * p.C + c] = acc[j].x;
    if (c + 1 < p.C) out[(i * K + j) * p.C + c + 1] = acc[j].y;
  }
  if (i == P) {
    if (c < p.C) out[K * K * p.C + c] = bsum.x;
    if (c + 1 < p.C) out[K * K * p.C + c + 1] = bsum.y;
  }
}

// out[t] = sum over s of part[s, t], t < (k^2 + 1) C, to dtaps (t < k^2 C) or dbias
__global__ void __launch_bounds__(kSumLanes * kSumRows)
dw_grad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dtaps,
                      float* __restrict__ dbias, int n_taps, int n_out, int slots) {
  __shared__ float rows[kSumRows][kSumLanes];
  const int xl = threadIdx.x % kSumLanes;
  const int y = threadIdx.x / kSumLanes;
  const int t = blockIdx.x * kSumLanes + xl;
  float s = 0.f;
  if (t < n_out) {
    for (int g = y; g < slots; g += kSumRows) s += part[static_cast<long long>(g) * n_out + t];
  }
  rows[y][xl] = s;
  __syncthreads();
#pragma unroll
  for (int half = kSumRows / 2; half > 0; half /= 2) {
    if (y < half) rows[y][xl] += rows[y + half][xl];
    __syncthreads();
  }
  if (y == 0 && t < n_out) {
    if (t < n_taps) {
      dtaps[t] = rows[0][xl];
    } else if (dbias != nullptr) {
      dbias[t - n_taps] = rows[0][xl];
    }
  }
}

// ---- host side ------------------------------------------------------------------------------

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// pixels of a staged x row and a staged dy row of a tile of tile_w columns: the column
// loop runs whole k-wide chunks and reads one column ahead of each; an x row is an odd
// number of 64-byte pixels long in bf16, so that the two tap rows of a warp read distinct
// banks
void row_pixels(int k, int tile_w, int itemsize, int* xc, int* dyc) {
  *dyc = round_up(tile_w, k);
  *xc = *dyc + k;
  if (itemsize == 2 && *xc % 2 == 0) *xc += 1;
}

int smem_bytes(int k, int tile_w, int itemsize) {
  int xc = 0, dyc = 0;
  row_pixels(k, tile_w, itemsize, &xc, &dyc);
  return ((k + 1) * xc + 2 * dyc) * kChannels * itemsize;
}

// The launch of the partial pass, or with `resident` how many of its blocks fit the card.
template <typename T, int K>
cudaError_t run_partial(const Params& p, int slices, cudaStream_t stream, int device,
                        int* resident) {
  auto kernel = dw_grad_kernel<T, K>;
  static bool configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const int smem = smem_bytes(K, p.tile_w, sizeof(T));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (resident != nullptr) {
    *resident = resident_blocks(reinterpret_cast<const void*>(kernel), kPairs * K, smem, device);
    return *resident > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
  }
  const int tiles = (p.W + p.tile_w - 1) / p.tile_w;
  dim3 grid(tiles * p.runs, slices);
  kernel<<<grid, kPairs * K, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int k, const Params& p, int slices, cudaStream_t s, int device, int* resident) {
  switch (k) {
    case 3: return run_partial<T, 3>(p, slices, s, device, resident);
    case 5: return run_partial<T, 5>(p, slices, s, device, resident);
    case 7: return run_partial<T, 7>(p, slices, s, device, resident);
    case 9: return run_partial<T, 9>(p, slices, s, device, resident);
    case 11: return run_partial<T, 11>(p, slices, s, device, resident);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Blocks of the partial pass (dtype 0 = bf16, 1 = fp32; odd k 3 to 11; tiles of tile_w
// columns) that fit the card at once, or a negative cudaError_t. The planner in
// ops/depthwise.py cuts the rows into runs from it.
int ics_depthwise_conv_dw_resident(int dtype, int k, int tile_w, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return -static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || tile_w <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.tile_w = tile_w;
  int resident = 0;
  err = dtype == 0 ? run<bf16>(k, p, 1, nullptr, device, &resident)
                   : run<float>(k, p, 1, nullptr, device, &resident);
  return err == cudaSuccess ? resident : -static_cast<int>(err);
}

// dtype: 0 = bf16, 1 = fp32, of x and dy alike: contiguous [B, H, W, C]. k odd, 3 to 11.
// W is cut into tiles of tile_w columns (the last may be shorter), the B H rows into runs
// of `rows` rows in order, `runs` of them (the last may be shorter). part: [tiles runs,
// (k^2 + 1) C] fp32 scratch. dtaps: [k * k, C] fp32, tap (i, j) of channel c at dtaps[(i k
// + j) C + c]; dbias: [C] fp32 or null. Two launches on the stream. Returns a
// cudaError_t; 0 when both launches were accepted.
int ics_depthwise_conv_dw(int dtype, const void* x, const void* dy, void* part, void* dtaps,
                          void* dbias, int B, int H, int W, int C, int k, int tile_w, int rows,
                          int runs, void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (k < 3 || k > 11 || k % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || tile_w <= 0 || rows <= 0 || runs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long all_rows = static_cast<long long>(B) * H;
  const long long tiles = (W + tile_w - 1) / tile_w;
  const long long slices = (C + kChannels - 1) / kChannels;
  const long long n_out = static_cast<long long>(k * k + 1) * C;
  if (all_rows > 2147483647LL || static_cast<long long>(rows) * runs < all_rows ||
      static_cast<long long>(rows) * (runs - 1) >= all_rows || tiles * runs > 2147483647LL ||
      slices > 65535 || n_out > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int itemsize = dtype == 0 ? 2 : 4;
  Params p{};
  p.x = x;
  p.dy = dy;
  p.part = static_cast<float*>(part);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.tile_w = tile_w;
  p.rows = rows;
  p.runs = runs;
  row_pixels(k, tile_w, itemsize, &p.xc, &p.dyc);
  p.aligned = (C * itemsize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  p.n_out = static_cast<int>(n_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? run<bf16>(k, p, static_cast<int>(slices), s, device, nullptr)
                   : run<float>(k, p, static_cast<int>(slices), s, device, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_taps = k * k * C;
  dw_grad_reduce_kernel<<<(p.n_out + kSumLanes - 1) / kSumLanes, kSumLanes * kSumRows, 0, s>>>(
      p.part, static_cast<float*>(dtaps), static_cast<float*>(dbias), n_taps, p.n_out,
      static_cast<int>(tiles * runs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
