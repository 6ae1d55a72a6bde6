// Backward of Swin's window attention for NVIDIA Hopper (sm_90a): the gradient of
// window_attention_qkv's output with respect to its qkv input, for the explain step's
// input gradient through Swin.
//
// The TPU kernel that window_attention.cu replaces (scripts/proto_window_attn.py:82,
// pallas_window_attention) has no backward; this is the backward of the port's forward
// kernel. Per (window, head) the forward computes, in fp32,
//   S = (q scale)_T K^T + bias + mask,   P = softmax(S),   O = (P)_T V,
// where (.)_T is a rounding to the input's type T (bf16 or fp32). Given dO this kernel
// recomputes S and P exactly as the forward does (ex2.approx on (s - m) log2(e) for bf16,
// expf for fp32, P = e / l correctly rounded) and computes
//   O' = P V with P unrounded, D_i = sum_d dO_id O'_id (= sum_j P_ij dP_ij),
//   dP = dO V^T,   dS = P (dP - D),
//   dq = scale dS K,   dk = dS^T (q scale)_T,   dv = (P)_T^T dO,
// every sum in fp32, each gradient rounded once to T on its store. The bias table, its
// index and the mask are read as the forward reads them; the mask takes no gradient.
//
// The gradient of the bias table (training): the bias is the same for every window of a
// head, so its gradient is dB[h, i, j] = sum over windows of dS_ij, and the table's is
// that gathered back through the index. Where it is asked for, a block takes several
// windows of one head (windows g, g + G, g + 2G, ... of the call) and adds their dS into
// a [ww, ww] fp32 block in shared memory, a row a thread, which it writes once to a
// partial [G, heads, ww, ww] buffer: Swin-T's first stage at batch 32 has 2,048 windows of
// 3 heads, whose dS would be 59 MB written window by window. ics_window_attention_dtable
// then sums the G partials of each (head, i, j) in their order (table_sum_windows_kernel) and
// each table row over the (i, j) that index it, in the order of a stable sort of the
// index (table_gather_kernel): no atomics, the same sums on every run.
//
// Token map: as the forward's. Window n of a gy x gx grid of tokens in windows of
// wh x wwid takes image token ((wy wh + i + shift) mod gy, (wx wwid + j + shift) mod gx)
// as its token (i, j). The tokens of the windows of one image are a permutation of the
// image's (the cyclic shift), so a work item (a window and a head) owns its rows of dq,
// dk and dv: no atomics, and no pass over device memory besides its own loads and stores.
//
// What bounds it on an H100: operations. An item recomputes S and O' and makes dP, dq,
// dk and dv, 12 ww^2 hd operations (1.8 MFLOP at ww 49, hd 32), for 7 ww hd values
// read or written (21 KB in bf16): about 85 FLOP a byte. Swin-T's 12 calls at a
// SmoothGrad batch of 16 do 5.7 GFLOP and move 70 MB.
//
// Design (simple first, SIMT fp32 for both types): one block of 64 threads a work item;
// q (scaled and rounded as the forward's), k, v and dO of the item staged in shared
// memory as fp32, and P, then dS, as a [ww, ww] fp32 block, so that every operand of the
// item's six products is read from shared memory. Four phases between barriers:
//   1. thread i (a query row): S_i, P_i into shared, O'_i and D_i in registers;
//   2. thread j (a key row): dv_j = sum_i (P_ij)_T dO_i;
//   3. thread i: dP_ij = dO_i . v_j, dS_ij into shared over P_ij, dq_i = scale dS_i K;
//   4. thread j: dk_j = sum_i dS_ij (q scale)_i.
// A row of the [ww, ww] block is ww floats apart when ww is odd, ww + 1 when even, so
// that the rows threads write side by side in phases 1 and 3 fall on distinct banks;
// the columns of phases 2 and 4 are neighbouring words. The tensor-core version
// (mma.sync, as the forward's bf16 kernel) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include "device_guard.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxTokens = 64;   // tokens a window may have; threads of a block
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  long long sb, sy, sx, sh;   // strides (elements) of q, k, v: image, row, column, head
  long long ob, oy, ox, oh;   // the same of dO
  long long gb, gy_s, gx_s, gh;  // the same of dq, dk, dv
  int gy, gx;                 // tokens a column and a row of an image
  int wh, wwid, ww;           // window height, width, tokens
  int shift;
  int nwx, nw_img;            // windows a row and an image
  int heads;
  const float* table;         // bias table: row j of head h at table[j t_row + h t_head]
  long long t_row, t_head;
  const short* index;         // [ww, ww] rows of the table
  const float* mask;          // [n_mask, ww, ww] or null
  int n_mask;
  float scale;
  int ld;                     // row stride of the [ww, ww] block in shared memory
  float* dbias_part;          // [groups, heads, ww, ww] sums of dS, or null: no table gradient
  int groups;                 // blocks a head; block g takes windows g, g + groups, ...
  int windows;                // windows of the call
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// v rounded to T and back: what the forward's rounding to the input's type leaves
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// e^(s - m) as the forward kernel of T takes it: ex2.approx with the subtraction folded
// into one multiply-add for bf16, expf for fp32
template <typename T>
__device__ __forceinline__ float exp_shifted(float s, float m) {
  if constexpr (std::is_same<T, float>::value) {
    return expf(s - m);
  } else {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmaf_rn(s, kLog2e, -(m * kLog2e))));
    return y;
  }
}

// offset (elements, before the head) of token (i, j) of window (b, wy, wx)
__device__ __forceinline__ long long token_offset(const Params& p, int b, int wy, int wx, int i,
                                                  int j, long long sb, long long sy,
                                                  long long sx) {
  int y = wy * p.wh + i + p.shift;
  int x = wx * p.wwid + j + p.shift;
  y -= y >= p.gy ? p.gy : 0;
  x -= x >= p.gx ? p.gx : 0;
  return b * sb + y * sy + x * sx;
}

template <typename T, int D>
__global__ void __launch_bounds__(kMaxTokens)
window_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ww = p.ww;
  float* qs = smem;                 // [ww][D]: (q scale) rounded to T
  float* ks = qs + ww * D;
  float* vs = ks + ww * D;
  float* dos = vs + ww * D;
  float* ps = dos + ww * D;         // [ww][ld]: P, then dS
  float* accs = ps + ww * p.ld;     // [ww][ld]: the sum of dS over the block's windows

  const int head = blockIdx.x % p.heads;
  const int group = blockIdx.x / p.heads;
  const T* q = static_cast<const T*>(p.q) + head * p.sh;
  const T* k = static_cast<const T*>(p.k) + head * p.sh;
  const T* v = static_cast<const T*>(p.v) + head * p.sh;
  const T* dout = static_cast<const T*>(p.dout) + head * p.oh;
  const bool table_grad = p.dbias_part != nullptr;
  const int r = threadIdx.x;        // a query row in phases 1 and 3, a key row in 2 and 4
  const bool live = r < ww;
  const int ri = live ? r / p.wwid : 0;
  const int rj = live ? r - ri * p.wwid : 0;
  if (table_grad && live) {
    for (int j = 0; j < ww; ++j) accs[r * p.ld + j] = 0.f;
  }

  for (int n = group; n < p.windows; n += p.groups) {
    const int b = n / p.nw_img;
    const int local = n - b * p.nw_img;
    const int wy = local / p.nwx;
    const int wx = local - wy * p.nwx;

    for (int e = threadIdx.x; e < ww * D; e += blockDim.x) {
      const int t = e / D;
      const int d = e - t * D;
      const int ti = t / p.wwid;
      const int tj = t - ti * p.wwid;
      const long long off = token_offset(p, b, wy, wx, ti, tj, p.sb, p.sy, p.sx) + d;
      qs[e] = round_t<T>(__fmul_rn(to_f(q[off]), p.scale));
      ks[e] = to_f(k[off]);
      vs[e] = to_f(v[off]);
      dos[e] = to_f(dout[token_offset(p, b, wy, wx, ti, tj, p.ob, p.oy, p.ox) + d]);
    }
    __syncthreads();

    const long long g_off =
        token_offset(p, b, wy, wx, ri, rj, p.gb, p.gy_s, p.gx_s) + head * p.gh;
    float dor[D];
    float dd = 0.f;

    // 1. S_i and P_i (as the forward computes them), O'_i = P_i V and D_i = dO_i . O'_i
    if (live) {
      float* prow = ps + r * p.ld;
      const short* idx = p.index + r * ww;
      const float* tb = p.table + head * p.t_head;
      const float* mrow = p.mask == nullptr
                              ? nullptr
                              : p.mask + (static_cast<long long>(n % p.n_mask) * ww + r) * ww;
      float qr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[d] = qs[r * D + d];
        dor[d] = dos[r * D + d];
      }
      float m = kNegInf;
      for (int j = 0; j < ww; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j * D + d], s);
        s += tb[static_cast<unsigned short>(idx[j]) * p.t_row];
        if (mrow != nullptr) s += mrow[j];
        prow[j] = s;
        m = fmaxf(m, s);
      }
      float l = 0.f;
      for (int j = 0; j < ww; ++j) {
        const float e = exp_shifted<T>(prow[j], m);
        prow[j] = e;
        l += e;
      }
      float o[D];
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = 0.f;
      for (int j = 0; j < ww; ++j) {
        const float pj = __fdiv_rn(prow[j], l);
        prow[j] = pj;
#pragma unroll
        for (int d = 0; d < D; ++d) o[d] = fmaf(pj, vs[j * D + d], o[d]);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) dd = fmaf(dor[d], o[d], dd);
    }
    __syncthreads();

    // 2. dv_j = sum_i (P_ij)_T dO_i: P as the forward rounded it before P V
    if (live) {
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      for (int i = 0; i < ww; ++i) {
        const float pij = round_t<T>(ps[i * p.ld + r]);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pij, dos[i * D + d], acc[d]);
      }
      T* dv = static_cast<T*>(p.dv) + g_off;
#pragma unroll
      for (int d = 0; d < D; ++d) dv[d] = from_f<T>(acc[d]);
    }
    __syncthreads();

    // 3. dS_i = P_i (dO_i V^T - D_i) over P_i; dq_i = scale dS_i K
    if (live) {
      float* prow = ps + r * p.ld;
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      for (int j = 0; j < ww; ++j) {
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dp = fmaf(dor[d], vs[j * D + d], dp);
        const float ds = prow[j] * (dp - dd);
        prow[j] = ds;
        if (table_grad) accs[r * p.ld + j] += ds;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j * D + d], acc[d]);
      }
      T* dq = static_cast<T*>(p.dq) + g_off;
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = from_f<T>(acc[d] * p.scale);
    }
    __syncthreads();

    // 4. dk_j = sum_i dS_ij (q scale)_i
    if (live) {
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      for (int i = 0; i < ww; ++i) {
        const float ds = ps[i * p.ld + r];
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, qs[i * D + d], acc[d]);
      }
      T* dk = static_cast<T*>(p.dk) + g_off;
#pragma unroll
      for (int d = 0; d < D; ++d) dk[d] = from_f<T>(acc[d]);
    }
    __syncthreads();   // the next window's staging overwrites what phase 4 read
  }

  if (table_grad && live) {
    float* out = p.dbias_part + (static_cast<long long>(group * p.heads + head) * ww + r) * ww;
    for (int j = 0; j < ww; ++j) out[j] = accs[r * p.ld + j];
  }
}

// dbias[h, t] = sum over g of part[g, h, t], t < ww^2
__global__ void table_sum_windows_kernel(const float* __restrict__ part,
                                         float* __restrict__ dbias, int groups, int heads,
                                         int ww2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= heads * ww2) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += part[static_cast<long long>(g) * heads * ww2 + t];
  dbias[t] = s;
}

// out[row, h] = sum of dbias[h, order[e]] over e in [offsets[row], offsets[row + 1])
__global__ void table_gather_kernel(const float* __restrict__ dbias,
                                    const int* __restrict__ order,
                                    const int* __restrict__ offsets, float* __restrict__ out,
                                    int rows, int heads, int ww2) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * heads) return;
  const int row = t / heads;
  const int h = t - row * heads;
  float s = 0.f;
  for (int e = offsets[row]; e < offsets[row + 1]; ++e) s += dbias[h * ww2 + order[e]];
  out[t] = s;
}

int smem_bytes(int ww, int head_dim, int ld, bool table_grad) {
  return (4 * ww * head_dim + (table_grad ? 2 : 1) * ww * ld) * 4;
}

template <typename T, int D>
cudaError_t launch(const Params& p, long long items, cudaStream_t stream, int device) {
  auto kernel = window_bwd_kernel<T, D>;
  static bool configured[kMaxDevices] = {};
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int most = smem_bytes(kMaxTokens, D, kMaxTokens + 1, true);
  if (!configured[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  kernel<<<static_cast<unsigned>(items), kMaxTokens,
           smem_bytes(p.ww, D, p.ld, p.dbias_part != nullptr), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ics_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = bf16, 1 = fp32, of q, k, v, dout, dq, dk and dv. Token (y, x) of image b,
// head h of q lies at q + b sb + y sy + x sx + h sh (elements; the same strides for k and
// v), its head_dim values contiguous; dout's by ob, oy, ox, oh, and dq's, dk's and dv's
// by gb, gys, gxs, gh. Grid, windows, shift, table, index, mask and scale as
// ics_window_attention takes them. dbias_part: null, or [groups, heads, ww, ww] fp32 for
// the sums of dS over windows (then block g of a head takes windows g, g + groups, ...).
// Returns a cudaError_t; 0 when the launch was accepted.
int ics_window_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv, long long sb,
                             long long sy, long long sx, long long sh, long long ob,
                             long long oy, long long ox, long long oh, long long gb,
                             long long gys, long long gxs, long long gh, int batch, int gy,
                             int gx, int wh, int wwid, int shift, int heads, int head_dim,
                             const void* table, long long t_row, long long t_head,
                             const void* index, const void* mask, int n_mask, float scale,
                             void* dbias_part, int groups, void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || heads <= 0) return 0;
  const int ww = wh * wwid;
  if (wh <= 0 || wwid <= 0 || ww > kMaxTokens || gy % wh != 0 || gx % wwid != 0 ||
      shift < 0 || shift >= wh || shift >= wwid || (mask != nullptr && n_mask <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sb = sb;
  p.sy = sy;
  p.sx = sx;
  p.sh = sh;
  p.ob = ob;
  p.oy = oy;
  p.ox = ox;
  p.oh = oh;
  p.gb = gb;
  p.gy_s = gys;
  p.gx_s = gxs;
  p.gh = gh;
  p.gy = gy;
  p.gx = gx;
  p.wh = wh;
  p.wwid = wwid;
  p.ww = ww;
  p.shift = shift;
  p.nwx = gx / wwid;
  p.nw_img = (gy / wh) * p.nwx;
  p.heads = heads;
  p.table = static_cast<const float*>(table);
  p.t_row = t_row;
  p.t_head = t_head;
  p.index = static_cast<const short*>(index);
  p.mask = static_cast<const float*>(mask);
  p.n_mask = mask != nullptr ? n_mask : 1;
  p.scale = scale;
  p.ld = ww % 2 == 1 ? ww : ww + 1;
  const long long windows = static_cast<long long>(batch) * p.nw_img;
  if (windows * heads > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  p.windows = static_cast<int>(windows);
  p.dbias_part = static_cast<float*>(dbias_part);
  p.groups = dbias_part != nullptr ? groups : p.windows;
  if (p.groups <= 0 || p.groups > p.windows) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(p.groups) * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim * 2 + dtype) {
    case 32: return static_cast<int>(launch<bf16, 16>(p, items, s, device));
    case 33: return static_cast<int>(launch<float, 16>(p, items, s, device));
    case 64: return static_cast<int>(launch<bf16, 32>(p, items, s, device));
    case 65: return static_cast<int>(launch<float, 32>(p, items, s, device));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The table gradient from the partial sums that ics_window_attention_bwd wrote: part
// [groups, heads, ww, ww] fp32 -> dbias [heads, ww, ww] fp32 (scratch) -> out [rows,
// heads] fp32, contiguous. order: the ww^2 positions of the index sorted by table row
// (stable), offsets: [rows + 1] starts of each row's run in order, both int32. Two
// launches on the stream. Returns a cudaError_t; 0 when both were accepted.
int ics_window_attention_dtable(const void* part, int groups, int heads, int ww, void* dbias,
                                const void* order, const void* offsets, int rows, void* out,
                                void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups <= 0 || heads <= 0 || ww <= 0 || ww > kMaxTokens || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ww2 = ww * ww;
  const int threads = 256;
  table_sum_windows_kernel<<<(heads * ww2 + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), groups, heads, ww2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  table_gather_kernel<<<(rows * heads + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(dbias), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<float*>(out), rows, heads, ww2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
